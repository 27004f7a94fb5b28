"""Spectral template learning on a torch device (NMF / PCA / N-FINDR + FCLS)."""

from .decomposition import fcls, learn_templates_nmf, nfindr, nmf, pca

__all__ = ["fcls", "learn_templates_nmf", "nfindr", "nmf", "pca"]
