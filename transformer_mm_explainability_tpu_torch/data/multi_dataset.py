"""Multi-dataset interleaving loader (C29).

The port's copy of
``transformer_mm_explainability_tpu/data/multi_dataset.py`` (numpy):
importing that module would load the JAX package.

Re-design of ``VisualBERT/mmf/datasets/multi_dataset_loader.py``
(MultiDatasetLoader:17-292; the torch ConcatDataset shim it wraps,
mmf/datasets/concat_dataset.py, is subsumed by the same size-weighted
interleaving): several dataset iterators interleaved by
per-batch dataset choice — size-proportional probabilities by default
(``_infer_dataset_probabilities``:158-183), equal probabilities with
reignition otherwise (``__next__``:206-253, ``change_dataloader``:
255-276).

The dataset choice uses an explicit seeded RandomState and
is made on the host; over several processes every process derives
the same choice sequence from the shared seed (the reference instead
broadcasts the master's draw over NCCL — identical outcome, no
collective needed).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


class MultiDatasetLoader:
    """Iterate batches from several epoch-iterator factories.

    ``loaders`` maps name → zero-arg callable returning a fresh batch
    iterator (the shape ``core.build.build_dataloader_and_sampler``
    produces); ``lengths`` are dataset sizes for proportional sampling.
    """

    def __init__(self, loaders: Dict[str, Callable[[], Iterator]],
                 lengths: Optional[Dict[str, int]] = None,
                 proportional_sampling: bool = True,
                 dataset_type: str = "train", seed: int = 0):
        assert loaders, "MultiDatasetLoader needs at least one loader"
        # drop empty datasets: a zero-probability dataset can never be
        # chosen, so it would never finish and _choose would spin
        # forever once every other dataset is exhausted
        if lengths:
            loaders = {n: l for n, l in loaders.items()
                       if lengths.get(n, 1) > 0}
            assert loaders, "every dataset is empty"
        self.names = list(loaders)
        self.loaders = loaders
        self.dataset_type = dataset_type
        # val/test must fully iterate every dataset (metrics run over
        # complete sets) — the reference forces proportional there
        self.proportional = (proportional_sampling
                             or dataset_type != "train")
        if lengths and self.proportional:
            # same default as the emptiness filter above: names missing
            # from a partial lengths dict count as length 1
            total = float(sum(lengths.get(n, 1) for n in self.names))
            self.probabilities = [lengths.get(n, 1) / total
                                  for n in self.names]
        else:
            self.probabilities = [1.0 / len(self.names)] * len(self.names)
        self.rng = np.random.RandomState(seed)
        self.current_index = 0

    @property
    def num_datasets(self) -> int:
        return len(self.names)

    @property
    def current_dataset_name(self) -> str:
        return self.names[self.current_index]

    def _choose(self, finished: Dict[int, int]) -> int:
        choice = int(self.rng.choice(self.num_datasets,
                                     p=self.probabilities))
        while choice in finished:
            choice = int(self.rng.choice(self.num_datasets,
                                         p=self.probabilities))
        return choice

    def __iter__(self) -> Iterator[Any]:
        if self.num_datasets == 1:
            self.current_index = 0
            yield from self.loaders[self.names[0]]()
            return
        iterators: List[Iterator] = [self.loaders[n]()
                                     for n in self.names]
        finished: Dict[int, int] = {}
        self.current_index = self._choose(finished)
        while True:
            try:
                batch = next(iterators[self.current_index])
            except StopIteration:
                if self.proportional:
                    finished[self.current_index] = 1
                    if len(finished) == self.num_datasets:
                        return
                    self.current_index = self._choose(finished)
                else:
                    # equal sampling: reignite the exhausted iterator
                    iterators[self.current_index] = self.loaders[
                        self.names[self.current_index]]()
                continue
            name = self.current_dataset_name
            self.current_index = self._choose(finished)
            yield name, batch
