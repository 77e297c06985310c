"""An estimate of the serial-chain floor of the FM feedback kernel (K5,
zang_tpu_torch/csrc/fm_feedback.cu), counted from its machine code.

Each output sample of a voice needs the one before, so a voice's n samples
take at least n times the latency of one step's chain of dependent
instructions, however wide the card. This script:

  1. builds the kernel library (zang_tpu_torch/ops/_build.py) and dumps its
     SASS with cuobjdump beside it, as lib<...>.sass in zang_tpu_torch/build/
     (or reads a dump given with --sass);
  2. walks one iteration of the kernel's sample loop along the path that
     fm_feedback takes for waveform 0 (the fmsynth example's) with the
     angle in sinf's fast range (|p| < 105615: base lies in [0, 2 pi) and
     |fb1 + fb2| * feedback <= 2 * (pi / 4) at the example's feedback),
     each branch resolved by the rules in `_fact`; a branch it cannot
     resolve stops the script;
  3. finds the longest chain of register dependences from a register's
     value at the loop head to the same register at the back edge (the
     carried output), both with each predicated instruction on that chain
     skipped (the shortest any iteration can take: the floor) and executed;
  4. prices each dependent instruction at LATENCY_CYCLES, the
     register-dependency latency that the CUDA C++ Programming Guide
     ("Maximize Instruction Throughput", multiprocessor level) gives for
     arithmetic on devices of compute capability 7.x and later, takes the
     larger of that and the instructions issued (one warp issues at most
     one a cycle), and the card's maximum SM clock from nvidia-smi.

Run from the repo root on a machine with CUDA and nvcc:

    python tools/fm_chain_floor.py [--n 16384] [--sass FILE]

With --sass FILE nothing is built and no card is read (give --mhz). The
floor it prints is an estimate: it assumes the guide's latency for every
instruction on the chain, and counts neither the loads of base nor the
branches, which the measured time per step includes.
"""

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LATENCY_CYCLES = 4
SLOW_PATH_GUARD = "105615"  # sinf's switch to its slow range reduction
WAVEFORM = 0
# the kernel's parameters in the constant bank: base, fb1, fb2, out, fb1_end,
# fb2_end (8 bytes each from 0x210), then feedback, waveform, V, n
WAVEFORM_PARAM = "c[0x0][0x244]"

_LINE = re.compile(r"/\*([0-9a-f]{4})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
_REG = re.compile(r"\bR(\d+)(\.64)?\b")
_PRED = re.compile(r"^!?P(\d)$")
_NO_DEST = ("ST", "BRA", "EXIT", "BSSY", "BSYNC", "NOP", "RET", "BAR", "WARPSYNC")


def parse(sass_text, kernel="fm_feedback_kernel"):
    """The instructions of `kernel`'s function in a cuobjdump -sass dump:
    a list of (address, guard, opcode, operands)."""
    out, inside = [], False
    for line in sass_text.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = _LINE.search(line) if inside else None
        if m:
            guard = (m.group(2) or "").strip() or None
            ops = [o.strip() for o in m.group(4).split(",") if o.strip()]
            out.append((int(m.group(1), 16), guard, m.group(3), ops))
    if not out:
        raise SystemExit(f"no SASS of {kernel} in the dump")
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


def defs_uses(op, ops):
    """(registers and predicates written, those read) by one instruction."""
    if op.startswith(_NO_DEST) or not ops:
        return [], [r for o in ops for r in _regs(o)] + \
            [f"P{m.group(1)}" for o in ops if (m := _PRED.match(o))]
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
            else:
                defs += _regs(o, wide_dest)[:2 if wide_dest else 1]
        elif pm:
            uses.append(f"P{pm.group(1)}")
        else:
            uses += _regs(o, wide_src)
    return defs, uses


def _taken(instrs, at, guard, facts):
    """Whether the branch at index `at` is taken on the walked path."""
    if guard is None:
        return True
    neg, pred = guard.startswith("@!"), guard.lstrip("@!")
    if pred not in facts:
        raise SystemExit(f"cannot resolve the branch at {instrs[at][0]:#06x} ({guard})")
    return facts[pred] != neg


def _fact(op, ops, loaded):
    """The value of the predicate an ISETP/FSETP writes on the walked path,
    or None when no rule covers it."""
    text = " ".join(ops)
    if op.startswith("FSETP.GE") and SLOW_PATH_GUARD in text:
        return False  # |p| < 105615: sinf's fast range reduction
    if op.startswith("FSETP.NEU") and "+INF" in text:
        return True  # p is finite
    if op.startswith("ISETP.NE") and loaded.get(ops[2]) == WAVEFORM_PARAM:
        imm = ops[3]
        value = 0 if imm == "RZ" else int(imm, 0)
        return WAVEFORM != value
    return None


def walk(instrs):
    """One iteration of the sample loop along the walked path: returns the
    loop's head address and the executed instructions in order."""
    index = {a: i for i, (a, *_rest) in enumerate(instrs)}
    backs = [(a, int(ops[0], 16)) for a, g, op, ops in instrs
             if op == "BRA" and g and ops and int(ops[0], 16) < a]
    # the sample loop: the backward branch that spans the most code
    end, head = max(backs, key=lambda b: b[0] - b[1])
    facts, loaded, path = {}, {}, []
    i = index[head]
    while True:
        a, guard, op, ops = instrs[i]
        path.append(instrs[i])
        if a == end:
            return head, path
        if op.startswith("LDC") and ops:
            loaded[ops[0]] = ops[1]
        if op.startswith(("ISETP", "FSETP")):
            f = _fact(op, ops, loaded)
            if f is not None:
                facts[ops[0]] = f
            else:
                facts.pop(ops[0], None)
        if op == "BRA" and _taken(instrs, i, guard, facts):
            i = index[int(ops[0], 16)]
        else:
            i += 1


def longest_chain(path, skip_predicated):
    """The longest chain of dependent instructions from a register at the
    head of the path to the same register at its end: (register, the
    chain's instructions)."""
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
        if start in chain and len(chain[start]) > len(best[1]):
            best = (start, chain[start])
    return best


def fmt(ins):
    a, guard, op, ops = ins
    return f"{a:04x}  {(guard or ''):5s} {op} {', '.join(ops)}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384, help="samples a voice (fmsynth's chunk)")
    ap.add_argument("--sass", help="read this cuobjdump -sass dump instead of building")
    ap.add_argument("--mhz", type=float, help="SM clock (default: nvidia-smi's maximum)")
    args = ap.parse_args()

    card = None
    if args.sass:
        with open(args.sass) as f:
            text = f.read()
    else:
        from zang_tpu_torch.ops import _build

        so = _build.library("fm_feedback")._name
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

    instrs = parse(text)
    head, path = walk(instrs)
    print(f"the sample loop from {head:#06x}, one iteration at waveform {WAVEFORM} "
          f"on sinf's fast path: {len(path)} instructions issued")
    result = {}
    for label, skip in (("floor", True), ("all predicated executed", False)):
        reg, chain = longest_chain(path, skip)
        print(f"longest dependent chain, {label}: {len(chain)} instructions, "
              f"{reg} at the head to {reg} at the back edge:")
        for ins in chain:
            print("   ", fmt(ins))
        result[label] = len(chain)
    # a voice's warp also issues at most one instruction a cycle
    cycles = max(result["floor"] * LATENCY_CYCLES, len(path))
    floor_ms = args.n * cycles / (args.mhz * 1e3)
    print(f"serial-chain floor (estimate): the larger of {result['floor']} dependent "
          f"instructions x {LATENCY_CYCLES} cycles and {len(path)} issued = {cycles} "
          f"cycles a step; x {args.n} steps at {args.mhz:g} MHz = {floor_ms:.4f} ms"
          + (f" [{card}]" if card else ""))
    print(json.dumps({"issued": len(path), "chain_floor": result["floor"],
                      "chain_executed": result["all predicated executed"],
                      "latency_cycles": LATENCY_CYCLES, "cycles_a_step": cycles,
                      "n": args.n, "mhz": args.mhz, "floor_ms": floor_ms, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
