"""Golden oracle of the port: the reference-exact engine (NumPy + C++ inner
loops), a copy of zang_tpu/oracle/ held bit for bit to it on one CPU
(tests/test_torch_oracle.py, tests/test_torch_oracle_examples.py).

It runs on the host by design and takes no device. Two roles:
1. Executable specification of the reference's semantics (mode="exact":
   float accumulation, per-paint-call phase wraps, all quirks preserved).
2. Golden source for the port's renders on the card (mode="parity": the
   order-independent formulations the device engines reproduce), where the
   JAX package cannot run: bench's fidelity metric, the renderer's
   --engine oracle, the examples' backend="oracle" and chip_smoke.py's
   phase 15.

It imports numpy, ctypes and the port's own host modules, never jax and
nothing of zang_tpu.
"""

from . import modules, instruments, engine  # noqa: F401
from .engine import Voice, render_blocks, render_to_s16  # noqa: F401
