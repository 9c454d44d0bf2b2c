"""Parse a training log into train / test CSV tables (port of
``tools/parse_log.py``).

Reference: tools/extra/parse_log.py (+ parse_log.sh), which splits a Caffe
training log into ``<log>.train`` (NumIters, LearningRate, loss) and
``<log>.test`` (NumIters, one column per test-net output) CSV files for
plotting.  This version parses the glog lines ``train.Solver`` and
``NetSolver`` print:

    Iteration N, loss = L
    Iteration N, lr = R
    Iteration N, Testing net (#0)
        Test net output #i: name = value

    python -m nct_tpu_torch.tools.parse_log train.log [output_dir]

A host tool: nothing goes to a device.
"""

from __future__ import annotations

import csv
import os
import re
import sys

_RE_LOSS = re.compile(r"Iteration (\d+), loss = ([\d.eE+-]+|nan|inf)")
_RE_LR = re.compile(r"Iteration (\d+), lr = ([\d.eE+-]+)")
_RE_TEST = re.compile(r"Iteration (\d+), Testing net")
_RE_SCORE = re.compile(r"Test net output #\d+: (\S+) = ([\d.eE+-]+|nan|inf)")


def parse_log(path: str):
    """Returns (train_rows, test_rows): train rows are dicts with NumIters,
    loss and (when logged) LearningRate; test rows have NumIters plus one
    key per test-net output name."""
    train: dict[int, dict] = {}
    test_rows: list[dict] = []
    current_test: dict | None = None
    with open(path) as f:
        for line in f:
            m = _RE_LOSS.search(line)
            if m:
                it = int(m.group(1))
                train.setdefault(it, {"NumIters": it})["loss"] = float(
                    m.group(2))
                continue
            m = _RE_LR.search(line)
            if m:
                it = int(m.group(1))
                train.setdefault(it, {"NumIters": it})["LearningRate"] = (
                    float(m.group(2)))
                continue
            m = _RE_TEST.search(line)
            if m:
                current_test = {"NumIters": int(m.group(1))}
                test_rows.append(current_test)
                continue
            m = _RE_SCORE.search(line)
            if m and current_test is not None:
                current_test[m.group(1)] = float(m.group(2))
    train_rows = [train[k] for k in sorted(train)]
    return train_rows, test_rows


def _write_csv(rows: list[dict], path: str) -> None:
    if not rows:
        return
    fields = ["NumIters"] + sorted(
        {k for r in rows for k in r} - {"NumIters"})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    log_path = argv[0]
    out_dir = argv[1] if len(argv) > 1 else os.path.dirname(
        os.path.abspath(log_path))
    train_rows, test_rows = parse_log(log_path)
    base = os.path.join(out_dir, os.path.basename(log_path))
    _write_csv(train_rows, base + ".train")
    _write_csv(test_rows, base + ".test")
    print(f"{len(train_rows)} train rows -> {base}.train; "
          f"{len(test_rows)} test rows -> {base}.test")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
