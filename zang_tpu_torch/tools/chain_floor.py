#!/usr/bin/env python3
"""An estimate of the serial-chain floor of the port's sequential CUDA
kernels, counted from their machine code: the FM feedback kernel (K5,
zang_tpu_torch/csrc/fm_feedback.cu) and the one-pass SVF (K3,
csrc/svf_onepass.cu).

Each output sample of a voice needs the one before, so a voice's n samples
take at least n times the latency of one step's chain of dependent
instructions, however wide the card. This script:

  1. builds the kernel library (zang_tpu_torch/ops/_build.py) and dumps its
     SASS with cuobjdump beside it, as lib<...>.sass in zang_tpu_torch/build/
     (or reads a dump given with --sass);
  2. finds the code of one batch of kBatch samples (16 for fm, 32 for
     onepass), a branch-free block of the function that steps it:
       fm       fm_chain<0> (waveform 0, the fmsynth example's), the first
                of the four functions that fm_feedback_kernel calls: its
                largest block, a batch on fast_sin, sinf's fast path
                without its branch
       onepass  svf_onepass_kernel<2> (poly_echo's slot count), its chain
                warp's batches: each block with at least 16 f32 adds and
                multiplies a step is one of the batch's paths, told apart by
                their selects (FSEL): the fewest, every lane active and one
                cutoff for the batch, is the floor of a chunk in which
                every voice sounds; the others (a cutoff a sample; the
                plain loop's selects where a lane's af falls in the batch)
                are printed beside it
  3. finds the longest chain of register dependences through the block
     (from any register at its start to any at its end), both with each
     predicated instruction on that chain skipped (the floor) and executed,
     and divides it by the batch's steps;
  4. prices each dependent instruction at LATENCY_CYCLES, the
     register-dependency latency that the CUDA C++ Programming Guide
     ("Maximize Instruction Throughput", multiprocessor level) gives for
     arithmetic on devices of compute capability 7.x and later, takes the
     larger of that and the instructions issued a step (a warp alone on its
     scheduler issues at most one a cycle), and the card's maximum SM clock
     from nvidia-smi.

Run from the repo root on a machine with CUDA and nvcc:

    python3 zang_tpu_torch/tools/chain_floor.py fm|onepass [--n N] [--sass FILE]
    python3 zang_tpu_torch/tools/chain_floor.py latency

`latency` checks LATENCY_CYCLES on the card: one warp steps a chain of
dependent f32 multiplies and adds (LATENCY_SOURCE), alone and with
independent adds beside each link, and prints the cycles a link takes
(clock64 around the loop).

(--n: samples a voice; default 16384, fmsynth's chunk, for fm and 65536,
poly_echo's, for onepass.) With --sass FILE nothing is built and no card is
read (give --mhz). The floor it prints is an estimate: it assumes the
guide's latency for every instruction on the chain, and counts neither
shared-memory latency nor barriers, which the measured time per step
includes.
"""

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

LATENCY_CYCLES = 4
# one warp: a chain of dependent multiplies and adds, 64 links unrolled, with
# K independent adds beside each link; clock64 around n passes
LATENCY_SOURCE = r"""
#include <cuda_runtime.h>
template <int K>
__global__ void chain(float* out, long long* cycles, float a, float c, int n) {
  float x = a, y[K + 1];
  for (int k = 0; k <= K; ++k) y[k] = a * (k + 2);
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      x = x * c;
#pragma unroll
      for (int k = 0; k < K; ++k) y[k] = y[k] + c;
      x = x + a;
    }
  }
  const long long t1 = clock64();
  for (int k = 0; k < K; ++k) x += y[k];
  out[threadIdx.x] = x;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}
extern "C" int zt_chain_latency(float* out, long long* cycles, int n, int k) {
  if (k == 0) chain<0><<<1, 32>>>(out, cycles, 0.999f, 0.5f, n);
  else if (k == 2) chain<2><<<1, 32>>>(out, cycles, 0.999f, 0.5f, n);
  else return -1;
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
SLOW_PATH_GUARD = "105615"  # sinf's switch to its slow range reduction
# kernel -> (library stem, the function's mangled-name fragment, samples a
# voice, samples a batch: the kernel's kBatch)
KERNELS = {"fm": ("fm_feedback", "fm_feedback_kernel", 16384, 16),
           "onepass": ("svf_onepass", "svf_onepass_kernelILi2E", 65536, 32)}

_LINE = re.compile(r"/\*([0-9a-f]{4,5})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_REG = re.compile(r"\bR(\d+)(\.64)?\b")
_PRED = re.compile(r"^!?P(\d)$")
_NO_DEST = ("ST", "BRA", "EXIT", "BSSY", "BSYNC", "NOP", "RET", "BAR", "WARPSYNC", "CALL")
_BRANCHES = ("BRA", "EXIT", "RET", "CALL", "BSSY", "BSYNC", "BAR", "WARPSYNC")


def functions(sass_text):
    """The names of the functions in a cuobjdump -sass dump."""
    return [line.split("Function :", 1)[1].strip() for line in sass_text.splitlines()
            if "Function :" in line]


def parse(sass_text, fragment):
    """The instructions of the function whose name holds `fragment` in a
    cuobjdump -sass dump: a list of (address, guard, opcode, operands)."""
    out, inside = [], False
    for line in sass_text.splitlines():
        if "Function :" in line:
            inside = fragment in line
            continue
        m = _LINE.search(line) if inside else None
        if m:
            guard = (m.group(2) or "").strip() or None
            ops = [o.strip() for o in m.group(4).split(",") if o.strip()]
            out.append((int(m.group(1), 16), guard, m.group(3), ops))
    if not out:
        raise SystemExit(f"no SASS of a function named *{fragment}* in the dump; "
                         f"it has {functions(sass_text)}")
    return out


def stall_counts(sass_text, fragment):
    """address -> the stall count that the compiler wrote into the control
    bits of each instruction of the function (bits 41-44 of an
    instruction's second 64-bit word): the cycles the warp waits before it
    issues its next instruction, waits on memory not counted."""
    out, inside, addr = {}, False, None
    for line in sass_text.splitlines():
        if "Function :" in line:
            inside = fragment in line
            continue
        if not inside:
            continue
        m = _LINE.search(line)
        if m:
            addr = int(m.group(1), 16)
            continue
        m = re.fullmatch(r"\s*/\* (0x[0-9a-f]{16}) \*/\s*", line)
        if m and addr is not None:
            out.setdefault(addr, (int(m.group(1), 16) >> 41) & 0xF)  # the first such function's
            addr = None
    return out


def _regs(text, wide=False):
    """Register names read in an operand (a .64 suffix or a wide operand
    names the pair)."""
    names = []
    for m in _REG.finditer(text):
        r = int(m.group(1))
        names.append(f"R{r}")
        if m.group(2) or wide:
            names.append(f"R{r + 1}")
    return names


def _width(op):
    """Registers a load or store moves: LDS.128 -> 4."""
    m = re.search(r"\.(64|128)\b", op)
    return int(m.group(1)) // 32 if m and op.startswith(("LD", "ST")) else 1


def defs_uses(op, ops):
    """(registers and predicates written, those read) by one instruction."""
    if op.startswith(_NO_DEST) or not ops:
        uses = []
        for i, o in enumerate(ops):
            # a store's data operand (the last) spans its width
            w = _width(op) if op.startswith("ST") and i == len(ops) - 1 else 1
            uses += [f"R{int(r[1:]) + j}" for r in _regs(o) for j in range(w)]
        return [], uses + [f"P{m.group(1)}" for o in ops if (m := _PRED.match(o))]
    wide_dest = any(s in op for s in (".WIDE", ".64", "F64.", "CS2R")) or \
        op.startswith(("DMUL", "DADD", "DFMA")) or op.endswith(".F64")
    wide_src = op.startswith(("DMUL", "DADD", "DFMA", "F2F.F32.F64"))
    # ISETP P0, PT, ... and LOP3.LUT P1, R7, ... write two; so does IADD3 R11,
    # P0, ... (its carry)
    n_dest = 2 if _PRED.match(ops[0]) or ops[0] == "PT" or (
        len(ops) > 1 and _PRED.match(ops[1])) else 1
    defs, uses = [], []
    for i, o in enumerate(ops):
        pm = _PRED.match(o)
        if i < n_dest:
            if pm:
                defs.append(f"P{pm.group(1)}")
            elif op.startswith("LD") and _width(op) > 1:
                k = int(_regs(o)[0][1:]) if _regs(o) else None
                defs += [] if k is None else [f"R{k + j}" for j in range(_width(op))]
            else:
                defs += _regs(o, wide_dest)[:2 if wide_dest else 1]
        elif pm:
            uses.append(f"P{pm.group(1)}")
        else:
            uses += _regs(o, wide_src)
    return defs, uses


def chain_functions(instrs):
    """The four fm_chain<W> functions that fm_feedback_kernel calls, in the
    order the compiler lays them out (W = 0, 1, 2, 3): lists of
    instructions. The order is checked: fm_chain<1> alone takes a maximum at
    every step (the most FMNMX), and fm_chain<3> holds twice the sinf range
    guards of fm_chain<0> (it takes sin 2p too)."""
    starts = sorted({int(ops[0], 16) for a, g, op, ops in instrs
                     if op.startswith("CALL.REL") and ops
                     and re.fullmatch(r"0x[0-9a-f]+", ops[0])})
    if len(starts) != 4:
        raise SystemExit(f"expected the 4 fm_chain<W> calls, found {len(starts)}")
    ends = starts[1:] + [instrs[-1][0] + 1]
    funcs = [[i for i in instrs if lo <= i[0] < hi] for lo, hi in zip(starts, ends)]

    def count(f, test):
        return sum(1 for _, _, op, ops in f if test(op, " ".join(ops)))

    fmnmx = [count(f, lambda op, t: op.startswith("FMNMX")) for f in funcs]
    guards = [count(f, lambda op, t: op.startswith("FSETP") and SLOW_PATH_GUARD in t)
              for f in funcs]
    if max(fmnmx) != fmnmx[1] or fmnmx.count(fmnmx[1]) != 1 or guards[3] != 2 * guards[0]:
        raise SystemExit(f"the called functions do not look like fm_chain<0..3> in order: "
                         f"FMNMX {fmnmx}, sinf range guards {guards}")
    return funcs


def blocks(instrs):
    """The runs of instructions with no branch, barrier or branch target
    inside them."""
    targets = {int(ops[0], 16) for a, g, op, ops in instrs
               if op == "BRA" and ops and re.fullmatch(r"0x[0-9a-f]+", ops[0])}
    out, cur = [], []
    for ins in instrs:
        a, guard, op, ops = ins
        if a in targets or op.startswith(_BRANCHES):
            out.append(cur)
            cur = [] if op.startswith(_BRANCHES) else [ins]
            continue
        cur.append(ins)
    return [b for b in out + [cur] if b]


def largest_block(instrs):
    """The longest run of instructions with no branch, barrier or branch
    target inside it."""
    return max(blocks(instrs), key=len)


def count_ops(path, *prefixes):
    return sum(1 for _, _, op, _ in path if op.startswith(prefixes))


def batch_paths(instrs, batch):
    """The onepass kernel's batch paths: the branch-free blocks that step a
    whole batch (at least 16 f32 adds and multiplies a sample: a step has
    16, its output mix 5), fewest selects first."""
    found = [b for b in blocks(instrs) if count_ops(b, "FADD", "FMUL", "FFMA") >= 16 * batch]
    if not found:
        raise SystemExit("no block of the onepass kernel steps a whole batch")
    return sorted(found, key=lambda b: (count_ops(b, "FSEL"), len(b)))


def longest_chain(path, skip_predicated):
    """The longest chain of dependent instructions from a register at the
    start of the path to any register at its end: (register, the chain's
    instructions)."""
    best = (None, [])
    live_in = {r for _, _, op, ops in path for r in defs_uses(op, ops)[1]}
    for start in sorted(live_in):
        if not start.startswith("R"):
            continue
        chain = {start: []}  # register -> the dependent chain that wrote it
        for ins in path:
            a, guard, op, ops = ins
            if op in ("BRA", "BSSY", "BSYNC"):
                continue
            d, u = defs_uses(op, ops)
            if guard and guard.lstrip("@!") not in ("PT",):
                u = u + [guard.lstrip("@!")]
            src = [chain[r] for r in u if r in chain]
            executed = max(src, key=len) + [ins] if src else None
            for r in d:
                # a register not in `chain` does not depend on the start
                options = [executed]
                if guard and skip_predicated:  # off, the old value stands
                    options.append(chain.get(r))
                if None in options:
                    chain.pop(r, None)
                else:
                    chain[r] = min(options, key=len)
        for r in chain:
            if r in chain and len(chain[r]) > len(best[1]):
                best = (start, chain[r])
    return best


def fmt(ins):
    a, guard, op, ops = ins
    return f"{a:05x}  {(guard or ''):5s} {op} {', '.join(ops)}"


def measure_latency() -> int:
    """Build LATENCY_SOURCE into zang_tpu_torch/build/ and print the cycles
    a dependent link takes on the card."""
    import ctypes

    import torch

    from zang_tpu_torch.ops import _build

    src = os.path.join(_build.BUILD_DIR, "chain_latency.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(src, "w") as f:
        f.write(LATENCY_SOURCE)
    lib = ctypes.CDLL(_build.build_shared(src, _build.nvcc_path, _build.NVCC_FLAGS,
                                          "chain_latency"))
    fn = lib.zt_chain_latency
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = torch.empty(32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    n = 2048
    readings = {}
    for k in (0, 2):
        for _ in range(2):  # the first call loads the code
            if fn(out.data_ptr(), cycles.data_ptr(), n, k) != 0:
                raise SystemExit("the latency kernel failed")
        readings[k] = cycles.item() / (n * 64)
        print(f"a dependent f32 multiply or add, {k} independent adds beside each: "
              f"{readings[k]:.3f} cycles")
    print(json.dumps({"latency_cycles_measured": readings[0],
                      "with_2_independent": readings[2], "assumed": LATENCY_CYCLES,
                      "card": subprocess.run(
                          ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["latency"]:
        return measure_latency()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--n", type=int, help="samples a voice")
    ap.add_argument("--sass", help="read this cuobjdump -sass dump instead of building")
    ap.add_argument("--mhz", type=float, help="SM clock (default: nvidia-smi's maximum)")
    ap.add_argument("--batch", type=int, help="samples a batch (default: the kernel's kBatch; "
                    "16 for a dump of the earlier, 16-sample onepass kernel)")
    args = ap.parse_args()
    stem, fragment, n_default, batch = KERNELS[args.kernel]
    batch = args.batch or batch
    n = args.n or n_default

    card = None
    if args.sass:
        with open(args.sass) as f:
            text = f.read()
    else:
        from zang_tpu_torch.ops import _build

        so = _build.library(stem)._name
        tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                              check=True).stdout
        dump = os.path.splitext(so)[0] + ".sass"
        with open(dump, "w") as f:
            f.write(text)
        print(f"SASS of {so} in {dump}")
        q = ["nvidia-smi", "--format=csv,noheader"]
        card = subprocess.run(q + ["--query-gpu=name,power.limit"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[0]
        print(card)
        if args.mhz is None:
            args.mhz = float(subprocess.run(
                q[:1] + ["--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True).stdout.split()[0])
    if args.mhz is None:
        raise SystemExit("give --mhz with --sass")

    instrs = parse(text, fragment)
    if args.kernel == "fm":
        instrs = chain_functions(instrs)[0]
        fragment = "fm_chain<0>"
        paths = [largest_block(instrs)]
    else:
        paths = batch_paths(instrs, batch)
    stalls = stall_counts(text, KERNELS[args.kernel][1])
    readings = [floor(args.kernel, fragment, path, batch, n, args.mhz, card, show=k == 0,
                      stalls=stalls) for k, path in enumerate(paths)]
    if len(readings) > 1:
        print("the other batch paths, by their selects: " + "; ".join(
            f"{r['fsel']} FSEL, {r['issued']} issued, chain {r['chain_floor']}, "
            f"{r['scheduled_cycles_a_step']:.2f} scheduled cycles a step: {r['floor_ms']:.4f} ms"
            for r in readings[1:]))
    print(json.dumps({**readings[0], "other_paths": readings[1:]}))
    return 0


def floor(kernel, fragment, path, batch, n, mhz, card, show, stalls):
    """The chain floor of one batch's block: a reading (printed when show),
    with the stall cycles that the compiled schedule gives the block."""
    result = {}
    for label, skip in (("floor", True), ("all predicated executed", False)):
        reg, chain = longest_chain(path, skip)
        if show:
            print(f"longest dependent chain, {label}: {len(chain)} instructions from {reg}:")
            for ins in chain:
                print("   ", fmt(ins))
        result[label] = len(chain)
    chain_step = result["floor"] / batch
    issued_step = len(path) / batch
    cycles = max(chain_step * LATENCY_CYCLES, issued_step)
    floor_ms = n * cycles / (mhz * 1e3)
    scheduled = sum(stalls.get(a, 0) for a, _, _, _ in path) / batch
    if show:
        print(f"the branch-free block of {fragment}, {path[0][0]:#06x} to {path[-1][0]:#06x}, "
              f"a batch of {batch} steps: {len(path)} instructions issued, "
              f"{count_ops(path, 'FSEL')} FSEL")
        print(f"serial-chain floor (estimate): the larger of {chain_step:.2f} dependent "
              f"instructions x {LATENCY_CYCLES} cycles and {issued_step:.2f} issued = "
              f"{cycles:.2f} cycles a step; x {n} steps at {mhz:g} MHz = {floor_ms:.4f} ms"
              + (f" [{card}]" if card else ""))
        print(f"the compiled schedule: {scheduled:.2f} stall cycles a step (the control "
              f"bits' stall counts over the block; what the loop around it costs, and "
              f"waits on memory, come on top)")
    return {"kernel": kernel, "function": fragment, "steps": batch, "issued": len(path),
            "fsel": count_ops(path, "FSEL"), "chain_floor": result["floor"],
            "chain_executed": result["all predicated executed"],
            "latency_cycles": LATENCY_CYCLES, "cycles_a_step": cycles,
            "scheduled_cycles_a_step": scheduled, "n": n, "mhz": mhz, "floor_ms": floor_ms,
            "card": card}


if __name__ == "__main__":
    sys.exit(main())
