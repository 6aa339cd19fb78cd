"""Generated API reference (the reference ships a Doxygen ``apidoc``
target, ``/root/reference/slib/CMakeLists.txt:32-41``; this is the
counterpart for an environment without Sphinx/pdoc).

Walks the public surface — each module's ``__all__`` (or public
top-level callables/classes) — and emits a markdown API reference with
signatures and docstrings.

Run:  ``python -m spsparse_tpu.tools.apidoc [out.md]``
(default output: ``docs/API.md`` relative to the repo root).
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

MODULES = [
    "spsparse_tpu",
    "spsparse_tpu.core.coo",
    "spsparse_tpu.core.errors",
    "spsparse_tpu.core.consolidate",
    "spsparse_tpu.core.chunksort",
    "spsparse_tpu.core.structure",
    "spsparse_tpu.core.algebra",
    "spsparse_tpu.core.construct",
    "spsparse_tpu.core.join",
    "spsparse_tpu.core.joinfill",
    "spsparse_tpu.core.accum",
    "spsparse_tpu.core.dia",
    "spsparse_tpu.core.bsr",
    "spsparse_tpu.core.tiled",
    "spsparse_tpu.core.reorder",
    "spsparse_tpu.core.interop",
    "spsparse_tpu.core.validate",
    "spsparse_tpu.core.backend",
    "spsparse_tpu.ops.multiply",
    "spsparse_tpu.ops.spgemm",
    "spsparse_tpu.ops.spgemm_tiled",
    "spsparse_tpu.ops.spmm",
    "spsparse_tpu.ops.spmv_kernels",
    "spsparse_tpu.ops.general",
    "spsparse_tpu.ops.block_spmm",
    "spsparse_tpu.ops.tiled_ops",
    "spsparse_tpu.io.netcdf",
    "spsparse_tpu.io.cdf",
    "spsparse_tpu.io.nc4",
    "spsparse_tpu.io.npz",
    "spsparse_tpu.io.sharded",
    "spsparse_tpu.dist",
    "spsparse_tpu.solvers",
    "spsparse_tpu.graph",
    "spsparse_tpu.utils.benchtime",
    "spsparse_tpu.utils.roofline",
    "spsparse_tpu.utils.trace",
    "spsparse_tpu.utils.compilecache",
    "spsparse_tpu.native",
]


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, limit: int | None = None) -> str:
    d = inspect.getdoc(obj) or ""
    if limit is not None:
        lines = d.splitlines()
        if len(lines) > limit:
            d = "\n".join(lines[:limit]) + "\n..."
    return d


def _symbols(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and getattr(v, "__module__", None) == mod.__name__]
    out = []
    for n in names:
        try:
            out.append((n, getattr(mod, n)))
        except AttributeError:
            continue
    return out


def generate(out_path: str) -> int:
    lines = ["# spsparse-tpu API reference",
             "",
             "Generated by `python -m spsparse_tpu.tools.apidoc` — do not "
             "edit by hand.",
             ""]
    n_symbols = 0
    for modname in MODULES:
        try:
            mod = importlib.import_module(modname)
        except Exception as e:  # pragma: no cover - optional deps
            lines += [f"## `{modname}`", "", f"*(import failed: {e})*", ""]
            continue
        lines += [f"## `{modname}`", ""]
        mdoc = _doc(mod, limit=None)
        if mdoc:
            first = mdoc.split("\n\n")[0]
            lines += [first, ""]
        for name, obj in _symbols(mod):
            n_symbols += 1
            if inspect.isclass(obj):
                lines += [f"### class `{name}{_signature(obj)}`", ""]
                d = _doc(obj)
                if d:
                    lines += [d, ""]
                for mname, m in inspect.getmembers(obj):
                    if mname.startswith("_"):
                        continue
                    if inspect.isfunction(m) or isinstance(
                            inspect.getattr_static(obj, mname, None),
                            property):
                        if inspect.isfunction(m):
                            head = f"`{name}.{mname}{_signature(m)}`"
                        else:
                            head = f"`{name}.{mname}` *(property)*"
                        md = _doc(m) if inspect.isfunction(m) else _doc(
                            inspect.getattr_static(obj, mname).fget)
                        lines += [f"- {head}"]
                        if md:
                            first = md.splitlines()[0]
                            lines += [f"  — {first}"]
                lines += [""]
            elif callable(obj):
                lines += [f"### `{name}{_signature(obj)}`", ""]
                d = _doc(obj)
                if d:
                    lines += [d, ""]
            else:
                lines += [f"### `{name}` = `{obj!r}`", ""]
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return n_symbols


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = argv[0] if argv else os.path.join(root, "docs", "API.md")
    n = generate(out)
    print(f"wrote {out} ({n} symbols)")


if __name__ == "__main__":
    main()
