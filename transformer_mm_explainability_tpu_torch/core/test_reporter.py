"""Prediction report writer (C28/C31).

The port's copy of
``transformer_mm_explainability_tpu/core/test_reporter.py`` (pure Python):
importing that module would load the JAX package.

Re-design of ``VisualBERT/mmf/common/test_reporter.py``
(TestReporter:26-160): accumulate per-dataset prediction rows and
flush them to timestamped json/csv files under a reports folder — the
EvalAI-submission surface of the reference's ``predict`` flow
(mmf_cli/predict.py + mmf/trainers/core/reporting.py
TrainerReportingMixin).

Host-side IO; rows come from a prediction processor (e.g. the
registered ``prediction.argmax``) applied to eval Reports.
"""

from __future__ import annotations

import csv
import json
import os
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence


class TestReporter:
    """flush_report/csv_dump/json_dump semantics
    (test_reporter.py:72-107)."""

    __test__ = False  # not a pytest class despite the Test* name

    def __init__(self, dataset_names: Sequence[str], report_folder: str,
                 experiment_name: str = "", dataset_type: str = "test",
                 file_format: str = "json",
                 prediction_processor: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None):
        assert file_format in ("json", "csv")
        self.dataset_names = list(dataset_names)
        self.report_folder = report_folder
        self.experiment_name = experiment_name
        self.dataset_type = dataset_type
        self.file_format = file_format
        self.prediction_processor = prediction_processor
        self.report: List[Dict[str, Any]] = []
        self.current_dataset_idx = -1
        self._clock = clock or _time.time
        self.written: List[str] = []
        os.makedirs(report_folder, exist_ok=True)

    @property
    def current_dataset_name(self) -> str:
        return self.dataset_names[self.current_dataset_idx]

    def next_dataset(self) -> bool:
        """test_reporter.py:59-70: flush the previous dataset's report,
        advance; False when every dataset is done."""
        if self.current_dataset_idx >= 0:
            self.flush_report()
        self.current_dataset_idx += 1
        return self.current_dataset_idx < len(self.dataset_names)

    def add_to_report(self, report: Dict[str, Any]) -> None:
        """test_reporter.py:126-160 reduced to its data path: run the
        prediction processor (or take ready row dicts) and extend."""
        if self.prediction_processor is not None:
            rows = self.prediction_processor(report)
        elif isinstance(report, list):
            rows = report
        else:
            raise ValueError(
                "add_to_report needs a prediction_processor or a list "
                "of row dicts")
        self.report.extend(rows)

    def flush_report(self) -> Optional[str]:
        """test_reporter.py:72-96: timestamped per-dataset file."""
        if not self.report:
            self.report = []
            return None
        stamp = _time.strftime("%Y-%m-%dT%H:%M:%S",
                               _time.localtime(self._clock()))
        filename = self.current_dataset_name + "_"
        if self.experiment_name:
            filename += self.experiment_name + "_"
        filename += f"{self.dataset_type}_{stamp}"
        if self.file_format == "csv":
            path = os.path.join(self.report_folder, filename + ".csv")
            with open(path, "w", newline="") as f:
                writer = csv.DictWriter(f, self.report[0].keys(),
                                        delimiter=",",
                                        quoting=csv.QUOTE_MINIMAL)
                writer.writeheader()
                writer.writerows(self.report)
        else:
            path = os.path.join(self.report_folder, filename + ".json")
            with open(path, "w") as f:
                json.dump(self.report, f)
        self.report = []
        self.written.append(path)
        return path
