"""Sample/SampleList batch containers (mmf/common/sample.py equivalent),
in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/core/sample.py``:
dict-of-arrays batches with attribute access (BatchCollator —
mmf/common/batch_collator.py — is the ``collate`` function here),
collation of heterogeneous samples by padding to the bucket max (numpy,
on the host), and device placement: ``SampleList.to_device(device)``
turns every numpy leaf into a torch tensor on ``device``. It takes no
``sharding``: ``parallel/mesh.shard_batch`` splits a batch over ranks.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np


class Sample(dict):
    """A single example; attribute access sugar over dict."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value


class SampleList(dict):
    """A batch: same keys, leading batch axis on every array leaf."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value

    @property
    def batch_size(self) -> int:
        for v in self.values():
            if hasattr(v, "shape") and len(v.shape) > 0:
                return v.shape[0]
        return 0

    def to_device(self, device) -> "SampleList":
        """Every numpy leaf as a torch tensor on ``device`` (torch leaves
        move there too); other leaves (lists, strings) as they are."""
        import torch

        out = SampleList()
        for k, v in self.items():
            if isinstance(v, np.ndarray) and v.dtype != object:
                out[k] = torch.as_tensor(v).to(device)
            elif isinstance(v, torch.Tensor):
                out[k] = v.to(device)
            else:
                out[k] = v
        return out


def _pad_to(arr: np.ndarray, length: int, axis: int = 0,
            pad_value=0) -> np.ndarray:
    if arr.shape[axis] == length:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, length - arr.shape[axis])
    return np.pad(arr, pad, constant_values=pad_value)


def collate(samples: Sequence[Mapping[str, Any]],
            pad_lengths: Optional[Mapping[str, int]] = None,
            pad_values: Optional[Mapping[str, Any]] = None) -> SampleList:
    """Stack samples into a SampleList, padding axis-0 of ragged array
    fields to ``pad_lengths[key]`` (or the batch max)."""
    pad_lengths = pad_lengths or {}
    pad_values = pad_values or {}
    out = SampleList()
    keys = samples[0].keys()
    for key in keys:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            tgt = pad_lengths.get(key,
                                  max(v.shape[0] for v in vals))
            pv = pad_values.get(key, 0)
            out[key] = np.stack([_pad_to(v, tgt, 0, pv) for v in vals])
        elif isinstance(vals[0], (int, float, bool, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = list(vals)
    return out


class Report(dict):
    """mmf/common/report.py:9-86: merged batch+model_output container
    used by evaluation/prediction loops.  Attribute access mirrors
    keys; ``accumulate_tensor_fields`` concatenates eval shards (the
    host-side gather step after eval batches)."""

    def __init__(self, batch=None, model_output=None, *args):
        super().__init__()
        if batch is None:
            return
        if model_output is None:
            model_output = {}
        if self._check_and_load_tuple(batch):
            return
        all_args = [batch, model_output, *args]
        for idx, arg in enumerate(all_args):
            if not isinstance(arg, Mapping):
                raise TypeError(
                    "Argument {:d}, {} must be of instance of "
                    "collections.abc.Mapping".format(idx, arg))
        bs = batch.get("batch_size")
        if bs is None:
            sizes = [len(v) for v in batch.values()
                     if hasattr(v, "__len__")]
            bs = sizes[0] if sizes else 0
        self["batch_size"] = bs
        for arg in all_args:
            for key, item in arg.items():
                self[key] = item

    def get_batch_size(self):
        return self["batch_size"]

    @staticmethod
    def _is_kv_tuples(batch):
        return (not isinstance(batch, Mapping)
                and isinstance(batch[0], (tuple, list))
                and isinstance(batch[0][0], str))

    def _check_and_load_tuple(self, batch):
        if not self._is_kv_tuples(batch):
            return False
        for k, v in batch:
            self[k] = v
        return True

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def fields(self):
        return list(self.keys())

    def accumulate_tensor_fields(self, report: "Report", field_list):
        import warnings

        for key in field_list:
            if key not in self:
                warnings.warn(
                    f"{key} not found in report. Metrics calculation "
                    "might not work as expected.")
                continue
            val = self[key]
            if isinstance(val, np.ndarray):
                self[key] = np.concatenate(
                    [val, np.asarray(report[key])], axis=0)
            elif type(val).__module__.startswith("torch"):
                import torch

                self[key] = torch.cat(
                    [val, torch.as_tensor(report[key]).to(val.device)],
                    dim=0)
