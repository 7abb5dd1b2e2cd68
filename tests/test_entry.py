"""Entry-point smoke tests: entry() serves the detector's forward step
and matches the NumPy oracle."""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_matches_oracle():
    import __graft_entry__
    import reference_impl as ref

    fn, args = __graft_entry__.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert out.shape == (2048, 1)
    cfg, _, _ = __graft_entry__._sample_setup()
    want = ref.detect_offline(cfg, np.asarray(args[0]))
    np.testing.assert_allclose(out, want, rtol=1e-3, atol=1e-4)
