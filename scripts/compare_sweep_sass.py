#!/usr/bin/env python3
"""Whether two checkouts compile the sweep kernels to the same machine
code, and how the bf16 instantiations differ from the float32 ones.

    python3 scripts/compare_sweep_sass.py --root DIR
    python3 scripts/compare_sweep_sass.py --forms

Compiles ``videomorphing_tpu_torch/csrc/sweep.cu`` of this checkout and of
``DIR`` to ``sm_90a`` cubins with the port's nvcc flags (both at once, into
``build/sweep_sass/``), disassembles them with ``cuobjdump -sass`` and
compares, function by function, every instantiation of kernels 1-2 that
both compile, float32 and bf16 (the tiles, the strips, the wide strip,
the per-pixel chain's kernels and the reduction), after removing the per-file name of the
anonymous namespace. Prints one JSON line per function (``equal``, the
instruction counts of both), then a summary line that also names the
functions only one of them compiles; exits 1 if any common function
differs. With
``--forms`` it compiles this checkout only and prints, for every kernel
instantiated in both forms, the instruction counts of its float32 and
bf16 instantiations and the opcodes whose counts differ. Needs ``nvcc``
and ``cuobjdump`` (the CUDA toolkit), no card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_sweep_cu_[0-9a-f]+")


def functions(sass: str) -> dict:
    """{function name: [instruction lines]} of a ``cuobjdump -sass`` listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = ANON.sub("ANON", m.group(1))
            out[name] = []
        elif name is not None and line.strip().startswith("/*") and "*/" in line:
            out[name].append(line.strip())
    return out


def opcodes(lines) -> dict:
    """{opcode: count} of a function's instruction lines."""
    out = {}
    for x in lines:
        m = re.match(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", x)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="the other checkout")
    ap.add_argument("--forms", action="store_true", help="float32 against bf16 instantiations of this checkout")
    args = ap.parse_args()
    if not args.forms and not args.root:
        ap.error("give --root DIR or --forms")
    sys.path.insert(0, str(ROOT))
    from videomorphing_tpu_torch.kernels import build

    nvcc = build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    out_dir = ROOT / "build" / "sweep_sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    jobs = []
    roots = (("this", ROOT),) if args.forms else (("this", ROOT), ("other", Path(args.root).resolve()))
    for label, root in roots:
        src = root / "videomorphing_tpu_torch" / "csrc" / "sweep.cu"
        cubin = out_dir / f"{label}.cubin"
        cmd = [nvcc, *flags, "-cubin", "-I", str(src.parent), "-o", str(cubin), str(src)]
        jobs.append((label, cubin, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    listings = {}
    for label, cubin, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
        listings[label] = functions(sass)
    if args.forms:
        # a kernel's two instantiations differ in the plane type, the last template argument
        key = lambda n: re.sub(r"(?:f|13__nv_bfloat16)EEv.*$", "", n)
        floats = {key(n): n for n in listings["this"] if "bfloat16" not in n}
        for name in sorted(n for n in listings["this"] if "bfloat16" in n):
            twin = floats.get(key(name))
            if twin is None:
                continue
            a, b = opcodes(listings["this"][twin]), opcodes(listings["this"][name])
            diff = {k: [a.get(k, 0), b.get(k, 0)] for k in sorted(set(a) | set(b)) if a.get(k, 0) != b.get(k, 0)}
            print(json.dumps({"function": twin, "instructions": [sum(a.values()), sum(b.values())],
                              "opcodes_float32_bf16": diff}), flush=True)
        return 0
    this, other = listings["this"], listings["other"]
    common = sorted(set(this) & set(other))
    differ = 0
    count = lambda lines: sum(1 for x in lines if re.match(r"/\*[0-9a-f]{4,}\*/", x))
    for name in common:
        equal = this[name] == other[name]
        differ += not equal
        print(json.dumps({"function": name, "equal": equal, "instructions": [count(this[name]), count(other[name])]}),
              flush=True)
    print(json.dumps({"common_functions": len(common), "differ": differ,
                      "only_in_this": sorted(set(this) - set(other)),
                      "only_in_other": sorted(set(other) - set(this))}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
