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
  2. finds the code of one batch of kBatch = 16 samples, the largest
     branch-free block of the function that steps it:
       fm       fm_chain<0> (waveform 0, the fmsynth example's), the first
                of the four functions that fm_feedback_kernel calls: a
                batch on fast_sin, sinf's fast path without its branch
       onepass  svf_onepass_kernel<2> (poly_echo's slot count): a batch's
                16 steps, whose activity and slot choices are selects
  3. finds the longest chain of register dependences through the block
     (from any register at its start to any at its end), both with each
     predicated instruction on that chain skipped (the floor) and executed,
     and divides it by the batch's 16 steps;
  4. prices each dependent instruction at LATENCY_CYCLES, the
     register-dependency latency that the CUDA C++ Programming Guide
     ("Maximize Instruction Throughput", multiprocessor level) gives for
     arithmetic on devices of compute capability 7.x and later, takes the
     larger of that and the instructions issued a step (a warp alone on its
     scheduler issues at most one a cycle), and the card's maximum SM clock
     from nvidia-smi.

Run from the repo root on a machine with CUDA and nvcc:

    python3 zang_tpu_torch/tools/chain_floor.py fm|onepass [--n N] [--sass FILE]

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
SLOW_PATH_GUARD = "105615"  # sinf's switch to its slow range reduction
BATCH = 16  # samples a batch in both kernels (kBatch)
# kernel -> (library stem, the function's mangled-name fragment, samples a voice)
KERNELS = {"fm": ("fm_feedback", "fm_feedback_kernel", 16384),
           "onepass": ("svf_onepass", "svf_onepass_kernelILi2E", 65536)}

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


def largest_block(instrs):
    """The longest run of instructions with no branch, barrier or branch
    target inside it."""
    targets = {int(ops[0], 16) for a, g, op, ops in instrs
               if op == "BRA" and ops and re.fullmatch(r"0x[0-9a-f]+", ops[0])}
    best, cur = [], []
    for ins in instrs:
        a, guard, op, ops = ins
        if a in targets or op.startswith(_BRANCHES):
            best = max(best, cur, key=len)
            cur = [] if op.startswith(_BRANCHES) else [ins]
            continue
        cur.append(ins)
    return max(best, cur, key=len)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--n", type=int, help="samples a voice")
    ap.add_argument("--sass", help="read this cuobjdump -sass dump instead of building")
    ap.add_argument("--mhz", type=float, help="SM clock (default: nvidia-smi's maximum)")
    args = ap.parse_args()
    stem, fragment, n_default = KERNELS[args.kernel]
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
    path = largest_block(instrs)
    print(f"the largest branch-free block of {fragment}, {path[0][0]:#06x} to "
          f"{path[-1][0]:#06x}, a batch of {BATCH} steps: {len(path)} instructions issued")
    result = {}
    for label, skip in (("floor", True), ("all predicated executed", False)):
        reg, chain = longest_chain(path, skip)
        print(f"longest dependent chain, {label}: {len(chain)} instructions from {reg}:")
        for ins in chain:
            print("   ", fmt(ins))
        result[label] = len(chain)
    chain_step = result["floor"] / BATCH
    issued_step = len(path) / BATCH
    cycles = max(chain_step * LATENCY_CYCLES, issued_step)
    floor_ms = n * cycles / (args.mhz * 1e3)
    print(f"serial-chain floor (estimate): the larger of {chain_step:.2f} dependent "
          f"instructions x {LATENCY_CYCLES} cycles and {issued_step:.2f} issued = "
          f"{cycles:.2f} cycles a step; x {n} steps at {args.mhz:g} MHz = {floor_ms:.4f} ms"
          + (f" [{card}]" if card else ""))
    print(json.dumps({"kernel": args.kernel, "function": fragment, "steps": BATCH,
                      "issued": len(path), "chain_floor": result["floor"],
                      "chain_executed": result["all predicated executed"],
                      "latency_cycles": LATENCY_CYCLES, "cycles_a_step": cycles,
                      "n": n, "mhz": args.mhz, "floor_ms": floor_ms, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
