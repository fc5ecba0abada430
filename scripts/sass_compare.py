"""Compare the SASS of every kernel that two builds of the kernel libraries
share: prints SAME or DIFF per kernel (anonymous-namespace hashes removed
from the names), NEW and GONE for the others, and a count.

Build both trees first (``chip_smoke.py`` or ``ops/cuda/build.build()`` in
each), then, from the repository root on a machine with the CUDA toolkit:

    python scripts/sass_compare.py <old tree>/build/torch_kernels build/torch_kernels

A kernel with the same SASS in both builds computes the same bits from the
same inputs.
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def functions(cuobjdump: str, lib: str) -> dict:
    """{kernel name: its SASS lines} of one library."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs, name, body = {}, None, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                funcs[name] = body
            name, body = re.sub(r"_GLOBAL__N__[0-9a-f]+_|(?<=_cu_)[0-9a-f]{8}", "", m.group(1)), []
        elif name and "/*" in line:
            body.append(re.sub(r"\s+", " ", line.strip()))
    if name:
        funcs[name] = body
    return funcs


def main() -> None:
    sys.path.insert(0, ROOT)
    from confidence_bootstrapping_tpu_torch.ops.cuda import build

    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    a_dir, b_dir = sys.argv[1:3]
    same = diff = 0
    for lib in sorted(os.listdir(b_dir)):
        if not lib.endswith(".so") or not os.path.exists(os.path.join(a_dir, lib)):
            continue
        fa, fb = functions(cuobjdump, os.path.join(a_dir, lib)), functions(cuobjdump, os.path.join(b_dir, lib))
        for name in sorted(set(fa) & set(fb)):
            ok = fa[name] == fb[name]
            same += ok
            diff += not ok
            print(("SAME " if ok else "DIFF ") + lib + " " + name[:100] + f" ({len(fb[name])} lines)")
        for name in sorted(set(fb) - set(fa)):
            print("NEW  " + lib + " " + name[:100])
        for name in sorted(set(fa) - set(fb)):
            print("GONE " + lib + " " + name[:100])
    print(f"kernels in both builds: {same} with identical SASS, {diff} different")


if __name__ == "__main__":
    main()
