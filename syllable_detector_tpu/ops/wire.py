"""Sample encodings of the host->device drain transfer.

The live bank sends each drain round as one ``[lanes, samples]`` array in
a wire format and expands it on the device:

  * ``float32`` — the capture samples as they are;
  * ``int16`` — capture-native PCM, ``round(clip(x, -1, 1) * 32767)``,
    expanded as ``code / 32767`` (exact for S16 capture hardware);
  * ``mulaw8`` — continuous mu-law (mu = 255) companding of the int16
    code to 8 bits, a lossy tier (<= 2.3% of |x|).

The host side of the encoding lives in models/detector_bank.py and
native/ring_buffer.cpp (``sdstage_batch``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["WIRE_DTYPES", "MU", "dequantize"]

WIRE_DTYPES = {"float32": np.float32, "int16": np.int16, "mulaw8": np.int8}
MU = 255.0


def dequantize(x, wire: str):
    """Expand wire codes to float32 samples (traceable, elementwise)."""
    if wire == "float32":
        return x.astype(jnp.float32)
    if wire == "int16":
        return x.astype(jnp.float32) * np.float32(1.0 / 32767.0)
    if wire == "mulaw8":
        y = x.astype(jnp.float32) * np.float32(1.0 / 127.0)
        return jnp.sign(y) * (
            jnp.expm1(jnp.abs(y) * np.float32(np.log1p(MU))) * np.float32(1.0 / MU)
        )
    raise ValueError(f"unknown wire format {wire!r}")
