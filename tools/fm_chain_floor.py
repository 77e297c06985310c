"""Moved: the serial-chain floor of the FM feedback kernel is now one of the
kernels that zang_tpu_torch/tools/chain_floor.py reads. This runs

    python3 zang_tpu_torch/tools/chain_floor.py fm [--n N] [--sass FILE] [--mhz MHZ]
"""

import os
import runpy
import sys

if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.argv[1:1] = ["fm"]
    runpy.run_path(os.path.join(here, "zang_tpu_torch", "tools", "chain_floor.py"),
                   run_name="__main__")
