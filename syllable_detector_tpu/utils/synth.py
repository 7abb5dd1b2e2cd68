"""Synthetic labeled audio and synthetic model variants for tests, demos,
and hardware smokes.

The reference ships no labeled training data (Examples/ is gitignored,
.gitignore:3); every training test and hardware validation here uses this
generator so the suite and chip_smoke.py exercise the SAME data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_labeled_audio", "deepen_net", "perturbed_params"]


def make_labeled_audio(seconds=4.0, rate=44100, seed=0):
    """Syllable = loud band-limited chirp bursts; silence/noise elsewhere.

    Returns (audio float32 [n], intervals [(start_s, end_s), ...]); the
    labeled intervals sit inside the bursts (past the detector's window
    fill) so edge evaluations count as neither hits nor false alarms.
    """
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.01 * rng.standard_normal(n)
    intervals = []
    pos = 0.3
    while pos + 0.25 < seconds:
        lo, hi = pos, pos + 0.15
        m = (t >= lo) & (t < hi)
        tt = t[m] - lo
        f0 = 3000.0 + 1500.0 * np.sin(2 * np.pi * 8 * tt)
        x[m] += 0.6 * np.sin(2 * np.pi * np.cumsum(f0) / rate)
        intervals.append((lo + 0.04, hi - 0.01))  # interior, past window fill
        pos += 0.55
    return x.astype(np.float32), intervals


def deepen_net(spec, params, mid_units=6, transfer="LogSig", seed=0):
    """Graft an extra hidden layer (arbitrary transfer) between a net's
    hidden layer and its output layer -> (spec2, params2).

    Mirrors what the train CLI emits for --hidden H1 H2
    (training/trainer.py builds [features, *hidden, 1]); used by the
    detector and bank tests.
    """
    import dataclasses

    rng = np.random.default_rng(seed)
    layers = list(params["layers"])
    h1_out = layers[0]["w"].shape[0]
    n_out = layers[-1]["w"].shape[0]
    mid = {
        "w": (rng.standard_normal((mid_units, h1_out)) * 0.5).astype(
            np.float32
        ),
        "b": (rng.standard_normal(mid_units) * 0.1).astype(np.float32),
    }
    out = {
        "w": (rng.standard_normal((n_out, mid_units)) * 0.5).astype(
            np.float32
        ),
        "b": np.asarray(layers[-1]["b"], np.float32),
    }
    params2 = dict(params)
    params2["layers"] = [layers[0], mid, out]
    net2 = dataclasses.replace(
        spec.net,
        layer_sizes=(
            spec.net.layer_sizes[0],
            (h1_out, mid_units),
            (mid_units, n_out),
        ),
        transfers=(spec.net.transfers[0], transfer, spec.net.transfers[-1]),
    )
    return dataclasses.replace(spec, net=net2), params2


def perturbed_params(params, seed, scale=0.05):
    """A distinct network of the same geometry: every leaf scaled by
    ``1 + scale * N(0, 1)`` (host numpy), for per-lane distinct-net runs."""
    import jax

    r = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(
            np.asarray(a)
            * (1.0 + scale * r.standard_normal(np.asarray(a).shape)),
            dtype=np.asarray(a).dtype,
        ),
        params,
    )
