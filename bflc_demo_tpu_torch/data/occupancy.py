"""UCI Occupancy Detection dataset — the config-1 data pipeline.

Copy of `bflc_demo_tpu/data/occupancy.py` (:1-103), numpy only, with the
same outputs: the CSV parser, the seeded synthetic stand-in, the
`occupancy_source` switch the accuracy bars key off, and the 75/25 split.

Reference (python-sdk/main.py:33-53): read data/datatraining.txt (8,143
rows; features Temperature, Humidity, Light, CO2, HumidityRatio; binary
Occupancy label, imbalanced 6,414/1,729), 75/25 train/test split with a
fixed seed, one-hot labels, train side split into CLIENT_NUM contiguous
shards.

The CSV is UCI data, not framework code: it is read from disk when
present and otherwise replaced by a seeded synthetic generator with the
same shape, scale and class imbalance.  The path chain is the
reference's, kept inside the checkout: `BFLC_TPU_OCCUPANCY`, then a
`datatraining.txt` beside this module, then one beside the reference's
data module (`bflc_demo_tpu/data/`).  The reference's last entry, the
reference demo's SDK checkout outside this repository, is not read; so
the two packages pick the same source whenever the CSV is named by the
variable or committed in the repository.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import numpy as np

N_FEATURES = 5
N_CLASS = 2

_REPO = Path(__file__).resolve().parents[2]


def _default_paths() -> tuple:
    # env var read per-call so late os.environ changes are honoured
    return (
        os.environ.get("BFLC_TPU_OCCUPANCY", ""),
        os.path.join(os.path.dirname(__file__), "datatraining.txt"),
        str(_REPO / "bflc_demo_tpu" / "data" / "datatraining.txt"),
    )


def _parse_csv(path: str) -> Tuple[np.ndarray, np.ndarray]:
    feats, labels = [], []
    with open(path, "r") as f:
        f.readline()  # "date","Temperature",... — discarded
        for line in f:
            parts = line.rstrip("\n").split(",")
            if len(parts) < 8:
                continue
            # "rowid","date",Temp,Humidity,Light,CO2,HumidityRatio,Occupancy
            feats.append([float(v) for v in parts[2:7]])
            labels.append(int(parts[7]))
    return np.asarray(feats, np.float32), np.asarray(labels, np.int32)


def synthesize_occupancy(n: int = 8143, seed: int = 0,
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded stand-in with the real dataset's scale and imbalance.

    Class-conditional Gaussians around the real data's per-class feature
    means (occupied rooms: more light, more CO2, slightly warmer) at
    realistic magnitudes, ~21% positive rate like the real 1,729/8,143.
    """
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.2123).astype(np.int32)
    mu0 = np.array([20.6, 27.0, 40.0, 600.0, 0.0042], np.float32)
    mu1 = np.array([22.4, 27.5, 460.0, 1000.0, 0.0047], np.float32)
    sd = np.array([1.0, 4.5, 120.0, 180.0, 0.0007], np.float32)
    x = np.where(y[:, None] == 1, mu1, mu0) + rng.standard_normal(
        (n, N_FEATURES)).astype(np.float32) * sd
    return x.astype(np.float32), y


def occupancy_source() -> str:
    """'csv' when a real datatraining.txt is reachable through the default
    path chain, else 'synthetic'.  Accuracy bars calibrate per source: the
    reference's 0.9214 plateau is a property of the REAL distribution; the
    seeded stand-in is more linearly separable but worse-conditioned (raw
    light/CO2 scales), so its fixed-lr trajectory oscillates and peaks
    differently."""
    return "csv" if any(p and os.path.exists(p)
                        for p in _default_paths()) else "synthetic"


def load_occupancy(test_fraction: float = 0.25, seed: int = 42,
                   path: str | None = None,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train, y_train, x_test, y_test); labels as int32 ids.

    Split mirrors the reference's train_test_split(test_size=0.25,
    random_state=42) (main.py:41-42): one seeded permutation, last quarter
    out.
    """
    if path is not None:
        # an explicit path must not silently degrade to synthetic data
        if not os.path.exists(path):
            raise FileNotFoundError(f"occupancy dataset not found: {path}")
        x, y = _parse_csv(path)
    else:
        x = y = None
        for p in _default_paths():
            if p and os.path.exists(p):
                x, y = _parse_csv(p)
                break
        if x is None:
            x, y = synthesize_occupancy()

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    x, y = x[perm], y[perm]
    n_test = int(len(x) * test_fraction)
    return (x[n_test:], y[n_test:], x[:n_test], y[:n_test])
