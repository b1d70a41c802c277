"""Synthetic stand-ins for the paper's non-redistributable datasets.

A numpy copy of ``repro/data/synth.py`` (same seeds, same arrays).

The Pavia Centre hyperspectral scene and the Breast Cancer Wisconsin
tables cannot ship inside this offline container, so we synthesize
datasets with the SAME shape statistics (features, classes, sizes) and a
controlled degree of class separation. The benchmarks only measure
training TIME vs sample count (the paper's axis is speedup, not
accuracy), so matched shapes + a realistic conditioning of the Gram
matrix are what matters.

* ``load_pavia_like``  — 102 spectral bands, 9 classes; per-class spectra
  are smooth correlated curves (random Fourier mixtures) + band noise,
  mimicking hyperspectral pixel statistics.
* ``load_breast_cancer_like`` — 569 samples, 32 features (30 informative
  + id-like noise), 2 classes with partial overlap.
* ``make_blobs`` — generic Gaussian clusters.
* ``make_synth_regression`` — the epsilon-SVR fixture (sinc / linear
  target of a random 1-D projection, plus noise).
"""
from __future__ import annotations

import numpy as np


def make_blobs(n_per_class: int, n_classes: int, n_features: int, *,
               sep: float = 3.0, seed: int = 0,
               cov_scale: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=sep, size=(n_classes, n_features))
    xs, ys = [], []
    for c in range(n_classes):
        xs.append(centers[c] +
                  cov_scale * rng.normal(size=(n_per_class, n_features)))
        ys.append(np.full(n_per_class, c, np.int64))
    x = np.concatenate(xs, 0).astype(np.float32)
    y = np.concatenate(ys, 0)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def make_synth_regression(n_samples: int, n_features: int = 6, *,
                          kind: str = "sinc", noise: float = 0.1,
                          seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Regression fixture for epsilon-SVR: a smooth nonlinear (or
    exactly linear) function of a random 1-D projection of x, plus
    Gaussian noise of scale ``noise``.

    * ``kind="sinc"``   — sinc(2t) + 0.5 sin(t) (bounded, smooth,
      non-monotone).
    * ``kind="linear"`` — t itself.
    """
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(n_samples, n_features))
    w = rng.normal(size=(n_features,))
    w /= np.linalg.norm(w)
    t = x @ w
    if kind == "sinc":
        y = np.sinc(2.0 * t) + 0.5 * np.sin(t)
    elif kind == "linear":
        y = t
    else:
        raise ValueError(f"unknown regression target {kind!r}; "
                         "expected 'sinc' or 'linear'")
    y = y + noise * rng.normal(size=n_samples)
    return x.astype(np.float32), y.astype(np.float32)


def load_pavia_like(n_per_class: int = 800, *, n_classes: int = 9,
                    n_bands: int = 102, seed: int = 7,
                    noise: float = 0.15) -> tuple[np.ndarray, np.ndarray]:
    """Hyperspectral-like: each class is a smooth spectral signature."""
    rng = np.random.default_rng(seed)
    wav = np.linspace(0.0, 1.0, n_bands)
    xs, ys = [], []
    for c in range(n_classes):
        # smooth class signature: low-order Fourier mixture
        coef = rng.normal(size=(6,))
        phase = rng.uniform(0, 2 * np.pi, size=(6,))
        sig = sum(coef[k] * np.sin(2 * np.pi * (k + 1) * wav + phase[k])
                  for k in range(6))
        sig = sig + rng.uniform(1.0, 3.0)  # reflectance offset
        # per-pixel: signature * illumination + correlated band noise
        illum = rng.uniform(0.7, 1.3, size=(n_per_class, 1))
        band_noise = rng.normal(scale=noise, size=(n_per_class, n_bands))
        # correlate the noise along the band axis (moving average)
        kern = np.ones(7) / 7.0
        band_noise = np.apply_along_axis(
            lambda v: np.convolve(v, kern, mode="same"), 1, band_noise)
        xs.append((sig[None, :] * illum + band_noise).astype(np.float32))
        ys.append(np.full(n_per_class, c, np.int64))
    x = np.concatenate(xs, 0)
    y = np.concatenate(ys, 0)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def load_breast_cancer_like(n_samples: int = 569, *, n_features: int = 32,
                            seed: int = 13) -> tuple[np.ndarray, np.ndarray]:
    """Two overlapping classes, 30 informative + 2 noise features,
    class prior ~ (357 benign, 212 malignant) like the original."""
    rng = np.random.default_rng(seed)
    n_pos = int(round(n_samples * 357 / 569))
    n_neg = n_samples - n_pos
    mean_shift = rng.normal(scale=1.2, size=(n_features,))
    mean_shift[-2:] = 0.0  # uninformative tail features
    x_pos = rng.normal(size=(n_pos, n_features))
    x_neg = rng.normal(size=(n_neg, n_features)) + mean_shift
    x = np.concatenate([x_pos, x_neg], 0).astype(np.float32)
    y = np.concatenate([np.zeros(n_pos, np.int64), np.ones(n_neg, np.int64)])
    perm = rng.permutation(len(y))
    return x[perm], y[perm]
