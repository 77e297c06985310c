"""zang_tpu_torch — the PyTorch and CUDA port of zang_tpu.

The JAX package (zang_tpu) stays the reference; this package renders the
same songs on an NVIDIA GPU and is held against it on the same inputs.
Its layout mirrors zang_tpu's, so each counterpart sits at the same path:

  core      the host core (notes, timeline, native, curves, span, trigger,
            wav: copies of zang_tpu.core's, the C++ compiler in csrc/) and
            mixdown (torch on the device, numpy twin)
  ops       u32 phase math, segment programs (tiled and flat chunks),
            oscillators, painter envelopes, the SVF filter, the sampler,
            FM, noise, effects and delays (plain torch, plus hand-written
            CUDA kernels for the SVF, the sample-table lookup and the FM
            feedback oscillator)
  graph     the chunked offline and streaming renderer and the fidelity
            metric
  host      instruments, the Bach song, the sampler and poly_echo configs,
            the examples, MIDI files and tracker text, the CLIs
  script    zangscript: the compiler (a copy of zang_tpu.script's front
            end), a torch backend, live reload and the zangc CLI
  serve     live fleets, the TCP server and client, the batch fleet and
            the HTTP render tier
  parallel  voice-sharded renders, one process a device with the mix
            all-reduced (torch.distributed), and the device list a live
            fleet splits its lanes over
  convert   carry a zang_tpu Performance's programs and state across

It imports torch and numpy, never jax and nothing of zang_tpu: it reads
only the data files under zang_tpu/data/. The render entry points run on
the card (device="cuda") unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
