"""Input/output processing chains (the MATLAB mapminmax/mapstd family).

Pure-jnp re-implementations of the reference's processing functions
(reference: Common/NeuralNet.swift:23-182), batched over leading axes.
The input chain is applied in declaration order before the first layer
(NeuralNet.swift:300-307); the output chain is applied in *reverse*
("reverseAndCopy") after the last layer (NeuralNet.swift:316-323), mapping
the net's output range back to the original target range — e.g. the sample
net's mapminmax(gain 2, yMin -1) reverse maps [-1, 1] back to [0, 1].

Functions are keyed by name with a parameter dict (a pytree leaf group), so
stacked multi-channel nets vmap/shard over a leading channel axis without
retracing.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import jax.numpy as jnp
import numpy as np

from syllable_detector_tpu.config.model_format import ProcessingSpec

__all__ = [
    "fold_input_affines",
    "fold_output_affines",
    "apply_named",
    "reverse_named",
    "apply_input_chain",
    "reverse_output_chain",
    "specs_to_chain",
]

Params = Mapping[str, Any]


def apply_named(x: jnp.ndarray, name: str, params: Params) -> jnp.ndarray:
    """Apply one input-processing function along the last axis."""
    if name == "mapminmax":
        # y = (x - xOffsets) * gains + yMin (NeuralNet.swift:127-131,
        # exact MATLAB mapminmax-apply)
        return (x - params["x_offsets"]) * params["gains"] + params["y_offset"]
    if name == "mapstd":
        # y = (x - xOffsets) * gains + yMean (NeuralNet.swift:162-168)
        return (x - params["x_offsets"]) * params["gains"] + params["y_offset"]
    if name == "l2normalize":
        # x / ||x||_2 over the feature axis (NeuralNet.swift:47-59)
        norm = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
        return x / norm
    if name == "normalize":
        # min-max to [-1, 1]; a zero range fills with -1
        # (NeuralNet.swift:69-96)
        mn = jnp.min(x, axis=-1, keepdims=True)
        mx = jnp.max(x, axis=-1, keepdims=True)
        rng = mx - mn
        slope = 2.0 / rng
        intercept = (0.0 - mn - mx) / rng
        y = x * slope + intercept
        return jnp.where(rng == 0.0, jnp.float32(-1.0), y)
    if name == "normalizestd":
        # zero-mean unit-std via vDSP_normalize (NeuralNet.swift:105-108);
        # vDSP uses the population standard deviation (denominator N)
        mean = jnp.mean(x, axis=-1, keepdims=True)
        centered = x - mean
        std = jnp.sqrt(jnp.mean(centered * centered, axis=-1, keepdims=True))
        return centered / std
    if name == "passthrough":
        return x
    raise ValueError(f"unknown input processing function {name!r}")


def reverse_named(y: jnp.ndarray, name: str, params: Params) -> jnp.ndarray:
    """Apply one output-processing function's *reverse* mapping."""
    if name in ("mapminmax", "mapstd"):
        # x = (y - yOffset) / gains + xOffsets (NeuralNet.swift:138-143,
        # 176-181)
        return (y - params["y_offset"]) / params["gains"] + params["x_offsets"]
    if name == "passthrough":
        return y
    raise ValueError(f"unknown output processing function {name!r}")


def specs_to_chain(
    specs: Sequence[ProcessingSpec],
) -> tuple[tuple[str, ...], list[dict]]:
    """Split specs into (static names, param pytrees)."""
    names = tuple(s.name for s in specs)
    params = []
    for s in specs:
        if s.name in ("mapminmax", "mapstd"):
            params.append(
                {
                    "x_offsets": np.asarray(s.x_offsets, np.float32),
                    "gains": np.asarray(s.gains, np.float32),
                    "y_offset": np.float32(s.y_offset),
                }
            )
        else:
            params.append({})
    return names, params


def apply_input_chain(
    x: jnp.ndarray, names: Sequence[str], params: Sequence[Params]
) -> jnp.ndarray:
    """Apply the input processing chain in order; empty chain is identity
    (NeuralNet.swift:261-266)."""
    for name, p in zip(names, params):
        x = apply_named(x, name, p)
    return x


def reverse_output_chain(
    y: jnp.ndarray, names: Sequence[str], params: Sequence[Params]
) -> jnp.ndarray:
    """Apply each output processing function's reverse mapping in declaration
    order (NeuralNet.swift:316-323)."""
    for name, p in zip(names, params):
        y = reverse_named(y, name, p)
    return y


def fold_input_affines(names, procs, n_features: int):
    """Fold an affine input chain (mapminmax/mapstd after an optional leading
    l2normalize) into per-feature (scale, shift) in float64, so
    ``chain(x) = (x_or_normalized * scale) + shift``.

    Returns (scale [D], shift [D], has_l2). The algebra the tensor-parallel
    path relies on:
    W @ (x*s + h) = (W*s) @ x + W @ h.
    """
    import numpy as np

    scale = np.ones(n_features, np.float64)
    shift = np.zeros(n_features, np.float64)
    has_l2 = False
    for name, p in zip(names, procs):
        if name == "l2normalize":
            has_l2 = True
        elif name in ("mapminmax", "mapstd"):
            g = np.asarray(p["gains"], np.float64)
            xo = np.asarray(p["x_offsets"], np.float64)
            yo = float(p["y_offset"])
            # applied after the accumulated (scale, shift):
            # ((x*s + h) - xo) * g + yo
            shift = (shift - xo) * g + yo
            scale = scale * g
    return scale, shift, has_l2


def fold_output_affines(names, procs, n_outputs: int):
    """Fold the reverse-applied output chain into one affine ``y*a + c``
    (float64) — mapminmax/mapstd reverse maps composed in reverse order
    (NeuralNet.swift:316-323)."""
    import numpy as np

    a = np.ones(n_outputs, np.float64)
    c = np.zeros(n_outputs, np.float64)
    for name, p in zip(names, procs):
        if name in ("mapminmax", "mapstd"):
            g = np.asarray(p["gains"], np.float64)
            xo = np.asarray(p["x_offsets"], np.float64)
            yo = float(p["y_offset"])
            a = a / g
            c = (c - yo) / g + xo
    return a, c
