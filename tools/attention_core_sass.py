#!/usr/bin/env python3
"""Compare the SASS of the attention cores of two trees of the port.

    python3 tools/attention_core_sass.py OLD NEW

OLD and NEW are checkouts (for instance the parent commit unpacked with
``git archive`` under ``build/``). Both trees' ``csrc/encoder_kernels.cu``
and ``csrc/encoder_backward_kernels.cu`` are compiled with the flags of
``ops/_build.py`` (all four ``nvcc`` at once), and each attention-core
kernel of OLD at head widths 16, 32 and 64 (the forward core's three
instances a width, the backward's two kernels) is compared, instruction for
instruction, with the NEW kernel of the same template arguments and width
(a tree whose cores take no head-width argument counts as width 64). Prints
one line a kernel and a JSON summary last; exit 1 if a kernel differs or
has no counterpart. Needs the CUDA toolkit (``nvcc``, ``cuobjdump``); no
card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

SOURCES = ("encoder_kernels", "encoder_backward_kernels")
WIDTHS = (16, 32, 64)
KERNELS = ("attention_core_kernel", "attention_bwd_q_mma_kernel", "attention_bwd_kv_mma_kernel")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def _cuda_bin(name: str) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", name)


def compile_all(trees, out_dir):
    """{(tree, source): object path}, every nvcc started together."""
    procs, objects = [], {}
    for tree in trees:
        for src in SOURCES:
            obj = os.path.join(out_dir, f"{len(objects)}_{src}.o")
            objects[tree, src] = obj
            cmd = [_cuda_bin("nvcc"), *FLAGS, "-c", "-o", obj,
                   os.path.join(tree, "matchmaker_tpu_torch", "csrc", f"{src}.cu")]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{err}")
    return objects


def sass_functions(obj: str):
    """{mangled kernel name: [instruction, ...]} of an object file."""
    out = subprocess.run([_cuda_bin("cuobjdump"), "-sass", obj], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if name and m:
            funcs[name].append(re.sub(r"\s+", " ", m.group(1)))
    return funcs


def template_key(name: str):
    """(kernel, template arguments without the head width, head width) of a
    mangled kernel name; a kernel without a head-width argument is width 64."""
    m = re.match(r"_ZN2mm\d+(\w+?kernel)(I.*?)?E+v?P", name)
    if not m:
        return None
    args = m.group(2) or ""
    hd = re.search(r"Li(\d+)", args)
    width = int(hd.group(1)) if hd else 64
    return m.group(1), re.sub(r"(E|I)Li\d+", "", args), width


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    rows, ok = [], True
    with tempfile.TemporaryDirectory() as tmp:
        objects = compile_all((args.old, args.new), tmp)
        for src in SOURCES:
            old, new = ({template_key(k): v for k, v in sass_functions(objects[tree, src]).items()
                         if any(n in k for n in KERNELS)} for tree in (args.old, args.new))
            for key, code in sorted(old.items()):
                if key is None or key[2] not in WIDTHS:
                    continue
                other = new.get(key)
                same = other == code
                ok &= same
                diff = None if other is None else sum(a != b for a, b in zip(code, other)) + abs(len(code) - len(other))
                rows.append({"kernel": key[0], "template": key[1], "head_width": key[2], "old_instructions": len(code),
                             "new_instructions": None if other is None else len(other), "identical": same,
                             "differing": diff})
                print(f"{src}: {key[0]}{key[1]} old {len(code)} vs new (head width {key[2]}) "
                      f"{'-' if other is None else len(other)} instructions: {'identical' if same else 'DIFFERENT'}")
    print(json.dumps({"identical": ok, "kernels": rows}))
    return 0 if ok and rows else 1


if __name__ == "__main__":
    sys.exit(main())
