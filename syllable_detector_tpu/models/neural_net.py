"""The MATLAB-subset MLP as a JAX pytree.

The reference implements a strictly-chained feed-forward net I -> L -> ... ->
L -> O with per-layer ``transfer(W @ x + b)`` and input/output processing
chains around it (reference: Common/NeuralNet.swift:230-378). Here the net is
a pytree of parameters plus a hashable static :class:`NetSpec`, so a single
traced function serves any number of channels: stack parameter pytrees on a
leading axis and ``vmap``/``shard_map`` over it — the batched equivalent of
the reference running one independent detector object per audio channel
(Processor.swift:57-59).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from syllable_detector_tpu.config.model_format import SyllableDetectorConfig
from syllable_detector_tpu.ops.processing import (
    apply_input_chain,
    reverse_output_chain,
    specs_to_chain,
)
from syllable_detector_tpu.ops.transfer import apply_transfer

__all__ = ["NetSpec", "net_from_config", "apply_net", "stack_params"]


@dataclass(frozen=True)
class NetSpec:
    """Static (trace-time) description of a net: shapes and function names."""

    layer_sizes: tuple[tuple[int, int], ...]  # (inputs, outputs) per layer
    transfers: tuple[str, ...]
    input_processing: tuple[str, ...]
    output_processing: tuple[str, ...]

    @property
    def inputs(self) -> int:
        return self.layer_sizes[0][0]

    @property
    def outputs(self) -> int:
        return self.layer_sizes[-1][1]


def net_from_config(cfg: SyllableDetectorConfig) -> tuple[NetSpec, dict]:
    """Build (static spec, parameter pytree) from a parsed config.

    Weights keep the reference's (outputs, inputs) row-major orientation
    (NeuralNet.swift:333, 366-368); ``apply_net`` contracts x @ W^T. The
    leaves are host numpy arrays: building a net starts no device backend
    (worker processes that only stage audio build nets too).
    """
    in_names, in_params = specs_to_chain(cfg.process_inputs)
    out_names, out_params = specs_to_chain(cfg.process_outputs)
    spec = NetSpec(
        layer_sizes=tuple((l.inputs, l.outputs) for l in cfg.layers),
        transfers=tuple(l.transfer for l in cfg.layers),
        input_processing=in_names,
        output_processing=out_names,
    )
    params = {
        "layers": [
            {
                "w": np.asarray(l.weights, np.float32),
                "b": np.asarray(l.biases, np.float32),
            }
            for l in cfg.layers
        ],
        "process_inputs": in_params,
        "process_outputs": out_params,
    }
    return spec, params


def apply_net(spec: NetSpec, params: dict, x: jax.Array) -> jax.Array:
    """Forward pass over a batch: [..., inputs] -> [..., outputs].

    Follows NeuralNet.apply (NeuralNet.swift:294-326): input chain, layers
    (vDSP_mmul + bias + transfer per layer, NeuralNet.swift:366-376), then the
    output chain reversed.
    """
    x = apply_input_chain(x, spec.input_processing, params["process_inputs"])
    for transfer, layer in zip(spec.transfers, params["layers"]):
        x = jnp.matmul(
            x, layer["w"].T, precision=jax.lax.Precision.HIGHEST
        ) + layer["b"]
        x = apply_transfer(x, transfer)
    return reverse_output_chain(
        x, spec.output_processing, params["process_outputs"]
    )


def stack_params(params_list: list[Any]) -> Any:
    """Stack per-channel parameter pytrees on a new leading axis.

    All nets must share one NetSpec (same shapes/functions); distinct
    architectures per channel run as separate shards instead.
    """
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *params_list)
