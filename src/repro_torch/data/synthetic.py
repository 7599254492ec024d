"""Synthetic CIFAR-shaped data (the machines running this have no network).

Held against ``repro.data.synthetic`` (``synthetic_cifar``,
``synthetic_lm``): the same numpy draws, so a seed gives bitwise the same
images, labels and tokens on both sides.

``synthetic_cifar`` produces CIFAR-10-shaped data (32x32x3, 10 classes)
with class-conditional structure (a fixed random template per class +
noise + random shifts), so the paper's ResNet genuinely learns.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_cifar(num: int, *, num_classes: int = 10, image_size: int = 32,
                    channels: int = 3, noise: float = 0.5, max_shift: int = 3,
                    seed: int = 0, template_seed: int = 1234
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N, H, W, C) f32 in ~[-1, 1], labels (N,) int32).

    Smooth (low-frequency) class templates + small circular jitter +
    additive noise. ``template_seed`` fixes the class definitions so
    train/test splits generated with different ``seed`` values share the
    same classes.
    """
    rng = np.random.default_rng(seed)
    trng = np.random.default_rng(template_seed)
    # low-frequency templates: upsampled 8x8 random fields
    coarse = trng.normal(0.0, 1.0, (num_classes, 8, 8, channels))
    reps = image_size // 8
    templates = np.repeat(np.repeat(coarse, reps, axis=1), reps,
                          axis=2).astype(np.float32)
    labels = rng.integers(0, num_classes, size=num).astype(np.int32)
    imgs = templates[labels]
    shifts = rng.integers(-max_shift, max_shift + 1, size=(num, 2))
    out = np.empty_like(imgs)
    for i in range(num):
        out[i] = np.roll(imgs[i], tuple(shifts[i]), axis=(0, 1))
    out += rng.normal(0.0, noise, out.shape).astype(np.float32)
    out /= np.max(np.abs(out))
    return out, labels


def synthetic_lm(num_seqs: int, seq_len: int, vocab: int, *,
                 seed: int = 0, period: int = 16,
                 noise: float = 0.1) -> np.ndarray:
    """Token sequences (num_seqs, seq_len) int32: a random periodic
    pattern per sequence with a ``noise`` share of tokens redrawn."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(num_seqs, period))
    reps = int(np.ceil(seq_len / period))
    toks = np.tile(base, (1, reps))[:, :seq_len]
    flip = rng.random((num_seqs, seq_len)) < noise
    toks = np.where(flip, rng.integers(0, vocab, size=toks.shape), toks)
    return toks.astype(np.int32)
