#!/usr/bin/env python3
"""Count the instructions of K3's step loops and time its instances.

    python3 tools/k3_sass.py [--out FILE]

Runs on a machine with an NVIDIA card and the CUDA toolkit. Builds
``gordo_components_torch/ops/csrc/lstm_step.cu`` as the port does
(``ops/_cuda.build_all``), disassembles it with the toolkit's
``cuobjdump -sass`` and, for every kernel in it, counts the instructions of
its step loop (the loop with the longest body, found by its backward
branch) by opcode: the conversions (``F2F``, ``F2FP``, ``I2F``, ``F2I``),
the ``MUFU`` operations by function, the shuffles, shared-memory loads and
the packed half-precision arithmetic, beside the loop's length and the
kernel's registers (``cuobjdump --dump-resource-usage``).

Then times, with the profiler's device time of the ``lstm_steps`` kernels
(mean of 50 launches), ``seq_scan.lstm_layer`` in float32 and in bfloat16
at the LSTM bank's full batch (S, B, M, H) = (32, 97, 64, 8) and for one
member (32, 97, 1, 8), whose time is the latency of the step chain alone,
and for one member at S = 8 and 64 steps: the slope is a step's latency,
the intercept what a launch costs besides its steps.

Prints one JSON line (and writes it to ``--out`` when given); the card's
name and power limit are in it. ``--compare LIB`` disassembles another
build of the source too (say, the parent commit's
``build/torch_kernels/lstm_step-*.so``) and holds each of its kernels to
this build's of the same name: ``same_sass`` lists each with whether their
instructions match, addresses and labels aside.
"""

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from gordo_components_torch.ops import _cuda, seq_scan  # noqa: E402

INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")
FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
CLASSES = ("F2F", "F2FP", "I2F", "F2I", "MUFU", "SHFL", "LDS", "HADD2", "HMUL2", "HFMA2", "PRMT")


def toolkit(name: str) -> str:
    return os.path.join(os.path.dirname(_cuda._nvcc()), name)


def disassemble(lib: str) -> str:
    return subprocess.run([toolkit("cuobjdump"), "-sass", lib], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def demangle(names):
    filt = toolkit("cu++filt")
    if not os.path.exists(filt) or not names:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True, timeout=60)
    return dict(zip(names, out.stdout.splitlines())) if out.returncode == 0 else {n: n for n in names}


def functions(sass: str) -> dict:
    """mangled name -> list of [address, opcode with modifiers, branch
    target address or None]."""
    funcs, labels, name, pending = {}, {}, None, []
    for line in sass.splitlines():
        m = FUNCTION.match(line)
        if m:
            name, pending = m.group(1), []
            funcs[name], labels[name] = [], {}
            continue
        m = LABEL.match(line)
        if name is None or m:
            pending += [m.group(1)] if m else []
            continue
        m = INSTR.match(line)
        if not m:
            continue
        addr, text = int(m.group(1), 16), re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
        labels[name].update((label, addr) for label in pending)
        pending = []
        op = text.split()[0] if text else ""
        target = None
        if op.startswith("BRA"):
            t = re.search(r"`\((\.L_x_\d+)\)|0x([0-9a-f]+)", text)
            if t:
                target = t.group(1) or int(t.group(2), 16)
        funcs[name].append([addr, op, target])
    for name, instrs in funcs.items():
        for ins in instrs:
            if isinstance(ins[2], str):
                ins[2] = labels[name].get(ins[2])
    return funcs


def same_sass(old_sass: str, new_sass: str) -> dict:
    """Kernel name (the translation unit's hash left out) -> whether its
    instructions in the two disassemblies match, branch targets aside;
    None where the new build lacks it."""
    def by_name(sass):
        return {re.sub(r"_GLOBAL__N__\w+?_lstm_step_cu_[0-9a-f]+", "", name):
                [re.sub(r"0x[0-9a-f]+|`\(\.L_x_\d+\)", "X", op) + str(t is not None) for _, op, t in instrs]
                for name, instrs in functions(sass).items()}
    old, new = by_name(old_sass), by_name(new_sass)
    return {name: (new[name] == ops if name in new else None) for name, ops in old.items()}


def loop_counts(instrs) -> dict:
    """Opcode counts of the loop with the longest body (a backward branch
    and its target), and of the whole kernel."""
    loops = [(a - t, t, a) for a, _, t in instrs if t is not None and t <= a]
    whole = Counter(op.split(".")[0] for _, op, _ in instrs)
    result = {"instructions": len(instrs), "whole": {c: whole.get(c, 0) for c in CLASSES}}
    if not loops:
        return dict(result, loop=None)
    _, start, end = max(loops)
    body = [op for a, op, _ in instrs if start <= a <= end]
    base = Counter(op.split(".")[0] for op in body)
    mufu = Counter(op for op in body if op.startswith("MUFU"))
    conv = Counter(op for op in body if op.split(".")[0] in ("F2F", "F2FP", "I2F", "F2I"))
    return dict(result, loop={
        "instructions": len(body), **{c: base.get(c, 0) for c in CLASSES},
        "mufu_by_function": dict(sorted(mufu.items())), "conversions": dict(sorted(conv.items())),
    })


def registers(lib: str) -> dict:
    out = subprocess.run([toolkit("cuobjdump"), "--dump-resource-usage", lib],
                         capture_output=True, text=True, timeout=120).stdout
    regs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs


def device_us(fn, args, runs=50):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn(*args)
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if "lstm_steps" in evt.key:
                us = getattr(evt, "device_time", None) or getattr(evt, "cuda_time", None)
                if us:
                    return round(us, 3)
    return None


def layer_case(S, B, M, H, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    xz = torch.randn(S, B, M, 4 * H, generator=g)
    Wh = torch.randn(M, H, 4 * H, generator=g) / H ** 0.5
    b = 0.1 * torch.randn(M, 4 * H, generator=g)
    return [a.to(dtype).cuda() for a in (xz, Wh, b)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    parser.add_argument("--compare", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_sass: CUDA is not available; this script runs on a card", file=sys.stderr)
        return 2
    lib = str(_cuda.build_all(["lstm_step"])["lstm_step"])
    sass = disassemble(lib)
    funcs = functions(sass)
    names = demangle(list(funcs))
    regs = registers(lib)
    kernels = {names[n]: dict(loop_counts(instrs), registers=regs.get(n))
               for n, instrs in funcs.items() if "lstm_steps" in n}
    timings = {}
    with torch.no_grad():
        for label, shape in (("serve", (32, 97, 64, 8)), ("one_member", (32, 97, 1, 8)),
                             ("one_member_S8", (8, 97, 1, 8)), ("one_member_S64", (64, 97, 1, 8))):
            for dtype in (torch.float32, torch.bfloat16):
                timings[f"{label}_{str(dtype).split('.')[1]}_device_us"] = device_us(
                    seq_scan.lstm_layer, layer_case(*shape, dtype, seed=7))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    result = {"card": card, "library": os.path.basename(lib), "timings": timings, "kernels": kernels}
    if args.compare:
        result["same_sass"] = same_sass(disassemble(args.compare), sass)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
