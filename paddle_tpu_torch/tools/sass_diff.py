"""Compare one kernel's machine code between two builds of a CUDA source.

    python -m paddle_tpu_torch.tools.sass_diff OLD.cu OLD_KERNEL NEW.cu NEW_KERNEL

Each source compiles as ``ops/_build`` compiles it (``NVCC_FLAGS``, with
the headers beside it) into ``ops/_build/sass_diff/``; ``cuobjdump -sass``
lists its kernels, and the one whose mangled name contains OLD_KERNEL
(NEW_KERNEL) is taken.  The two are compared line for line, addresses,
encodings and scheduling bits included, only the kernel's name left out:
exit 0 and "identical" when the machine code is the same, else exit 1 and
the first line that differs.  Needs the CUDA toolkit's ``nvcc`` and
``cuobjdump``, not a card.

Kernel 1's float32 instance against an earlier checkout's, for example:

    python -m paddle_tpu_torch.tools.sass_diff \\
        OLD/paddle_tpu_torch/ops/csrc/flash_fwd.cu flash_fwd_kernelEPKf \\
        paddle_tpu_torch/ops/csrc/flash_fwd.cu flash_fwd_kernelIfLb1ELb0E
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess

from paddle_tpu_torch.ops import _build


def kernels(sass: str) -> dict:
    """``{mangled name: [SASS lines]}`` from ``cuobjdump -sass`` output,
    each line stripped, blank and closing dotted lines dropped."""
    out, lines = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            lines = out.setdefault(line.split(":", 1)[1].strip(), [])
        elif lines is not None and line and line.strip(".") != "":
            lines.append(line)
    return out


def pick(table: dict, part: str) -> list:
    """The lines of the one kernel whose name contains ``part``."""
    names = [n for n in table if part in n]
    if len(names) != 1:
        raise SystemExit(f"{len(names)} kernels match {part!r}: "
                         f"{sorted(table)}")
    return table[names[0]]


def first_difference(old: list, new: list):
    """None when the two listings are the same, else (line number, old
    line, new line), a missing line given as ""."""
    for i in range(max(len(old), len(new))):
        a = old[i] if i < len(old) else ""
        b = new[i] if i < len(new) else ""
        if a != b:
            return i, a, b
    return None


def git_blob_id(path: str) -> str:
    """The id git gives the file's content as a blob (``git hash-object``),
    computed without git."""
    with open(path, "rb") as f:
        data = f.read()
    return hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()


def sass_of(src: str, tag: str) -> str:
    out_dir = os.path.join(_build.BUILD_DIR, "sass_diff")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"{tag}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, text=True)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", so], check=True,
                          capture_output=True, text=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_src")
    ap.add_argument("old_kernel")
    ap.add_argument("new_src")
    ap.add_argument("new_kernel")
    args = ap.parse_args(argv)
    old = pick(kernels(sass_of(args.old_src, "old")), args.old_kernel)
    new = pick(kernels(sass_of(args.new_src, "new")), args.new_kernel)
    diff = first_difference(old, new)
    if diff is None:
        print(f"identical: {len(old)} SASS lines", flush=True)
        return 0
    print(f"differ at line {diff[0]} of {len(old)} / {len(new)}:\n"
          f"  old: {diff[1]}\n  new: {diff[2]}", flush=True)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
