"""zangscript: the modular-synthesis DSL on the port (port of zang_tpu/script).

The front end (tokenize -> parse -> codegen, the printers and the builtin
registry) is the JAX package's plain-Python pipeline, copied; the backend
(torch_backend.ScriptInstrument) plans a compiled module on the host and
renders it with the port's torch ops and kernels. runtime.LiveScript
reloads a script file; zangc is the compiler's CLI:

    python -m zang_tpu_torch.script.zangc [options] script.txt
"""

from .compile import compile_script, CompiledScript  # noqa: F401
from .errors import ScriptError  # noqa: F401
