"""Device ops of the port: plain torch, plus hand-written CUDA kernels built
at first use (ops/_build.py). Modules import lazily; nothing here builds
or launches a kernel at import time."""
