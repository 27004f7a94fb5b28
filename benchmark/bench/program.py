"""The system under test: `surfh_tpu_torch`'s flagship model, built as
its users build it from a configuration file's `problem` and `model`
blocks, on the device, with its host tables from the table cache.

The program's own set-up (`simulation.flagship.make_flagship_setup`)
draws the operator's fixed inputs; they are held against the benchmark's
own (`reference.instrument.problem_inputs`) and must agree exactly, so
both sides run the same problem.  The `problem` block's ``unknown`` says
what the model takes: "maps" (the default), the template maps, or "cube",
the hyperspectral cube itself (the flagship model built from the same
set-up with no templates, as a user builds the cube-mode flagship).  The
unknown comes from the run's seed.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..reference import instrument

WORKERS = min(8, os.cpu_count() or 1)  # processes for a cold host-table build


class Stages:
    """Named set-up stages, each printed on stderr as it ends."""

    def __init__(self, log):
        self.log = log
        self.seconds = {}

    def __call__(self, name, fn, *args, **kw):
        import torch

        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t0
        self.log(f"set-up {name}: {self.seconds[name]:.3f} s")
        return out


def _check_inputs(setup: dict, problem: dict) -> None:
    """The program's inputs are the configuration's: raise where they differ
    (the templates only where the unknown is the maps)."""
    ours = instrument.problem_inputs(problem)
    pairs = [("psf_stack", "stamps"), ("wavelength_axis", "wavel"), ("alpha_axis", "alpha"),
             ("beta_axis", "beta")]
    if ours["unknown"] == "maps":
        pairs.insert(0, ("templates", "templates"))
    for theirs, mine in pairs:
        a, b = np.asarray(setup[theirs]), ours[mine]
        if a.shape != b.shape or not np.array_equal(a, b):
            raise RuntimeError(f"the program's {theirs} is not the configuration's")
    pts = np.asarray([[[c.alpha, c.beta] for c in p] for p in setup["pointings"]])
    grid = np.round(ours["pointings"] / ours["step"])
    if any(not np.array_equal(np.round(p / ours["step"]), grid) for p in pts):
        raise RuntimeError("the program's pointings are not the configuration's")


def build(config: dict, device, stages: Stages):
    """The model of `config` on `device` (float32), its tables uploaded."""
    import torch

    from surfh_tpu_torch.simulation.flagship import make_flagship_model, make_flagship_setup

    prob, mdl = config["problem"], dict(config["model"])
    window_local = bool(mdl.pop("window_local"))
    cube = instrument.unknown(prob) == "cube"
    if cube and window_local:
        raise ValueError("a cube-unknown window-local configuration: the benchmark builds the cube "
                         "unknown on the W-plane model only")

    def setup():
        s = make_flagship_setup(npix=prob["npix"], bands=list(prob["bands"]),
                                n_pointings=prob["n_pointings"], n_tpl=prob["n_tpl"],
                                lambda_subsample=prob["lambda_subsample"], seed=prob["setup_seed"],
                                build_sotf=not window_local, device=device)
        _check_inputs(s, prob)
        return s

    s = stages("problem set-up" + ("" if window_local else " and OTF on the device"), setup)
    channels = None
    if "channels_from" in config:
        # the band geometry, response and gather plans of the cached model of `channels_from`,
        # built with the templates whatever the unknown: its table cache is the maps models'
        src, _ = stages("channels from the table cache", make_flagship_model, s, dtype=np.float32,
                        workers=WORKERS, **config["channels_from"])
        stages.log(f"set-up channels: table cache {'hit' if src.table_cache_hit else 'miss'}")
        channels = src.channels
    model, _ = stages("host tables", make_flagship_model, dict(s, templates=None) if cube else s,
                      dtype=np.float32, window_local=window_local, workers=WORKERS, channels=channels,
                      **mdl)
    stages.log(f"set-up host tables: table cache "
               f"{'off' if model.table_cache_path() is None else ('hit' if model.table_cache_hit else 'miss')}")
    stages("upload", model.to, device, torch.float32)
    return model


def seed_unknown(config: dict, seed: int, device):
    """The unknown of a run, uniform in [0, 1), from `seed`: the sky maps
    [M, N, N], or the cube [L, N, N] where the problem's unknown is "cube"."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand(instrument.x_shape(config["problem"]), generator=gen, device=device,
                      dtype=torch.float32)
