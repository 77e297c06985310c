"""zang_tpu_torch — the PyTorch and CUDA port of zang_tpu.

The JAX package (zang_tpu) stays the reference; this package renders the
same songs on an NVIDIA GPU and is held against it on the same inputs.
Its layout mirrors zang_tpu's, so each counterpart sits at the same path:

  core      mixdown (torch on the device, numpy twin)
  ops       u32 phase math, tiled segment programs, oscillators, painter
            envelopes, the SVF filter (plain torch + a hand-written CUDA
            kernel for the table-cut form)
  graph     the chunked offline renderer and the fidelity metric
  host      instruments, the Bach song, the render_wav CLI
  convert   carry a zang_tpu Performance's programs and state across

It imports torch, numpy and the JAX-free modules of zang_tpu.core
(notes, timeline, native, curves, span, trigger, twelve_tet, wav), and
never jax. Every entry point takes an explicit device.
"""

__version__ = "0.1.0"
