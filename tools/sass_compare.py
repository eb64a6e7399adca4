#!/usr/bin/env python3
"""The megakernel's machine code in this checkout against another
checkout's, instantiation by instantiation, on a machine with nvcc.

    python3 tools/sass_compare.py OTHER [--diff DIR]
                                            # OTHER: the root of a checkout

Builds every library that each checkout's ``ops/_build.py`` makes from
``csrc/decoder_layer.cu`` (Whisper's set, the decoder-only set, and any
other build of that source with macros of its own), with this checkout's
nvcc flags and that checkout's macros, into ``build/sass/``, one nvcc
each, all at once; dumps each library's SASS with ``cuobjdump -sass`` and
prints, for every kernel of either checkout, whether its instructions are
equal (instruction addresses and the dump's column padding dropped, and
the anonymous namespace's hash, which names a kernel after its file, taken
out of the name).  A kernel is
keyed by its set (the decoder-only set, built with ``MEGA_DECODER_ONLY``,
or Whisper's) and its name, whichever library of the set holds it.
Exits 1 when a kernel of OTHER is missing from this checkout or differs
in it; kernels that only this checkout has are listed as new.  For a
kernel that differs it prints both instruction counts, the lines that
differ and the opcodes whose counts differ; ``--diff DIR`` also writes
each such kernel's unified diff of instructions into DIR.
"""
import collections
import difflib
import hashlib
import importlib.util
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
SOURCE = os.path.join("eddie_wang_hackathon2023_tpu_torch", "csrc",
                      "decoder_layer.cu")


def megakernel_libs(root):
    """{library: its macros} of the checkout at ``root``: each library its
    ``ops/_build.py`` (plain Python, loaded from its file) builds from
    decoder_layer.cu."""
    spec = importlib.util.spec_from_file_location(
        f"_build_of_{abs(hash(root))}",
        os.path.join(root, "eddie_wang_hackathon2023_tpu_torch", "ops",
                     "_build.py"))
    table = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(table)
    return {name: getattr(table, "DEFINES", {}).get(name, [])
            for name, src in table.SOURCES.items()
            if os.path.basename(src) == "decoder_layer.cu"}


def sass(lib):
    """{kernel: its instructions} of a built library."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", m.group(1))
            funcs[name] = []
        elif name is not None:
            # the address dropped, and the dump's padding, which widens
            # with the library's size
            funcs[name].append(" ".join(re.sub(
                r"/\*[0-9a-f]{4,}\*/", "", line).split()))
    return funcs


def digest(lines):
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:12]


def opcodes(lines):
    """Each instruction's opcode (its predicate dropped), counted."""
    ops = collections.Counter()
    for line in lines:
        m = re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops[m.group(1)] += 1
    return ops


def main(argv):
    from eddie_wang_hackathon2023_tpu_torch.ops import _build
    diff_dir = None
    if "--diff" in argv:
        i = argv.index("--diff")
        diff_dir = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
        os.makedirs(diff_dir, exist_ok=True)
    roots = {"other": os.path.abspath(argv[0]), "this": HERE}
    procs = {}
    for tag, root in roots.items():
        out = os.path.join(HERE, "build", "sass", tag)
        os.makedirs(out, exist_ok=True)
        for lib, defines in megakernel_libs(root).items():
            path = os.path.join(out, f"lib{lib}.so")
            procs[tag, lib] = (path, defines, subprocess.Popen(
                ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, *defines,
                 "-o", path, os.path.join(root, SOURCE)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels = {tag: {} for tag in roots}
    for (tag, lib), (path, defines, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed for {tag}'s {lib}:\n{log}")
            return 1
        kset = ("decoder_only" if "-DMEGA_DECODER_ONLY" in defines
                else "whisper")
        for k, lines in sass(path).items():
            kernels[tag][kset, k] = lines
    a, b = kernels["other"], kernels["this"]
    bad = 0
    for n, key in enumerate(sorted(set(a) | set(b))):
        state = ("new" if key not in a else "missing" if key not in b
                 else "equal" if a[key] == b[key] else "differ")
        bad += state in ("missing", "differ")
        print(f"{key[0]}: {state:7s} {key[1]} "
              f"{digest(a[key]) if key in a else None} "
              f"{digest(b[key]) if key in b else None}")
        if state != "differ":
            continue
        lines = list(difflib.unified_diff(a[key], b[key], "other", "this",
                                          n=2, lineterm=""))
        changed = sum(1 for x in lines[2:] if x[:1] in "+-")
        oa, ob = opcodes(a[key]), opcodes(b[key])
        delta = {op: ob[op] - oa[op] for op in set(oa) | set(ob)
                 if ob[op] != oa[op]}
        print(f"    {len(a[key])} / {len(b[key])} lines, {changed} "
              f"differ; opcode counts this - other: "
              + (", ".join(f"{op} {d:+d}" for op, d in sorted(
                  delta.items(), key=lambda t: -abs(t[1]))[:12])
                 or "none"))
        if diff_dir:
            with open(os.path.join(diff_dir, f"{key[0]}_{n}.diff"),
                      "w") as f:
                f.write(f"{key[1]}\n" + "\n".join(lines) + "\n")
    for kset in sorted({k for k, _ in a} | {k for k, _ in b}):
        mine = [k for k in a if k[0] == kset]
        same = sum(a[k] == b.get(k) for k in mine)
        print(f"{kset}: {same} of {len(mine)} kernels of OTHER equal in "
              f"this build ({sum(k[0] == kset for k in b)} in this build)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
