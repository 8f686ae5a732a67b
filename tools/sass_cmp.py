"""Compare the SASS of this tree's CUDA kernel libraries with an older
checkout's, function by function.

    python3 tools/sass_cmp.py PARENT_DIR [library ...]

builds each named library (default: the attention's three) with each
tree's own ``_build`` into that tree's ``build/torch_kernels``, runs
``cuobjdump -sass`` on both, and prints one line per kernel function:
identical, different, or present in one tree only, with the local loads
and stores (spills) of this tree's.  Needs ``nvcc`` and ``cuobjdump``
(the CUDA toolkit); exits 1 when a function present in both differs.
"""
from __future__ import annotations

import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIBRARIES = ("flash_attention", "flash_attention_train", "flash_attention_bwd")


def _build_module(tree: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, tree / "src/repro_torch/kernels/_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def functions(sass: str) -> dict[str, list[str]]:
    """Each function's instructions, addresses and the anonymous
    namespace's hash (it names the source file's build) taken out."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f_]+", "NS", m.group(1))
            out[cur] = []
        elif cur is not None:
            text = re.sub(r"/\*[0-9a-f]+\*/", "", line).strip()
            if text:
                out[cur].append(re.sub(r"_GLOBAL__N__[0-9a-f_]+", "NS", text))
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print(__doc__)
        return 2
    parent, names = Path(args[0]).resolve(), args[1:] or LIBRARIES
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    trees = {"parent": _build_module(parent, "parent_build"),
             "tree": _build_module(ROOT, "tree_build")}
    differ = 0
    for name in names:
        sass = {}
        for which, mod in trees.items():
            mod.build((name,))
            sass[which] = functions(subprocess.run(
                [cuobjdump, "-sass", str(mod.library_path(name))],
                capture_output=True, text=True, check=True).stdout)
        old, new = sass["parent"], sass["tree"]
        for fn in sorted(set(old) | set(new)):
            spills = sum(1 for x in new.get(fn, ())
                         if re.search(r"\b(STL|LDL)\b", x))
            if fn not in old or fn not in new:
                verdict = "only in " + ("this tree" if fn in new else
                                        "the parent")
            elif old[fn] == new[fn]:
                verdict = "identical"
            else:
                verdict, differ = "DIFFERENT", differ + 1
            print(f"{name}: {fn}: parent {len(old.get(fn, ()))} "
                  f"instructions, this tree {len(new.get(fn, ()))}, "
                  f"{verdict}; local loads/stores here {spills}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
