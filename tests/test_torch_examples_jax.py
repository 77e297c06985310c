"""Each ported example through its public entry on the CPU against the JAX
example (zang_tpu_torch/host/examples.py against zang_tpu/host/examples.py),
at the seconds of tests/test_examples_golden.py: every channel < -90 dBFS
RMS (the parity budget), the eight zangscript examples included. The
detuned example is held in two parts in test_torch_examples.py. A file of
its own so that pytest-xdist's --dist loadfile gives these renders a
worker of their own.
"""

import numpy as np
import pytest
import torch

from test_torch_examples import BUDGET_DB, SECONDS, _pair, _rms_db

torch.set_num_threads(1)  # xdist workers share the cores (see PERF.md §7)


@pytest.mark.parametrize("name", sorted(SECONDS))
def test_example_matches_jax(name):
    ja, jsr, ta, tsr = _pair(name)
    assert ta.shape == ja.shape and ta.dtype == np.float32 and tsr == jsr
    assert np.abs(ta).max() > 0.01  # not silent
    for ch in range(ja.shape[0]):
        assert _rms_db(ta[ch], ja[ch]) < BUDGET_DB, (name, ch)
