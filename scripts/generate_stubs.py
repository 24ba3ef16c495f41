#!/usr/bin/env python3
"""Generate polychase_core.pyi from the live module by introspection
(the analogue of the reference's generate_stubs.sh, which runs
pybind11-stubgen — /root/reference/generate_stubs.sh:9-13).

Run from the repo root:  python scripts/generate_stubs.py
Writes polychase_tpu/polychase_core.pyi (checked in; the packaging test
asserts it stays in sync with the module's __all__).
"""

import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sig(obj) -> str:
    """Parameter list with defaults collapsed to `...` and annotations
    dropped — value reprs (enum members, arrays) are not valid stub
    syntax."""
    try:
        sig = inspect.signature(obj)
    except (ValueError, TypeError):
        return "(*args, **kwargs)"
    parts = []
    for p in sig.parameters.values():
        s = p.name
        if p.kind == p.VAR_POSITIONAL:
            s = "*" + s
        elif p.kind == p.VAR_KEYWORD:
            s = "**" + s
        elif p.default is not p.empty:
            s += "=..."
        parts.append(s)
    return "(" + ", ".join(parts) + ")"


def _class_stub(name: str, cls: type, out: list) -> None:
    bases = [
        b.__name__ for b in cls.__bases__
        if b is not object and not b.__name__.startswith("_")
    ]
    base_s = f"({', '.join(bases)})" if bases else ""
    out.append(f"class {name}{base_s}:")
    body = []
    # NamedTuple-style fields with annotations/defaults
    ann = getattr(cls, "__annotations__", {}) or {}
    fields = getattr(cls, "_fields", None)
    defaults = getattr(cls, "_field_defaults", {})
    if fields:
        for f in fields:
            t = ann.get(f)
            t = getattr(t, "__forward_arg__", t)  # unwrap ForwardRef
            t_s = getattr(t, "__name__", None) or (
                str(t).replace("typing.", "") if t is not None else "Any"
            )
            if f in defaults:
                body.append(f"    {f}: {t_s} = ...")
            else:
                body.append(f"    {f}: {t_s}")
    else:
        for f, t in ann.items():
            t = getattr(t, "__forward_arg__", t)
            t_s = getattr(t, "__name__", None) or str(t).replace(
                "typing.", ""
            )
            body.append(f"    {f}: {t_s}")
    # int-enum style class attributes (the API's convention constants);
    # names already emitted from annotations (dataclass defaults) are
    # skipped to avoid duplicate declarations.
    for k, v in vars(cls).items():
        if k.startswith("_") or (fields and k in fields) or k in ann:
            continue
        if isinstance(v, int) and not isinstance(v, bool):
            body.append(f"    {k}: int")
    for k, v in vars(cls).items():
        if k.startswith("_") and k != "__init__":
            continue
        if inspect.isfunction(v):
            body.append(f"    def {k}{_sig(v)}: ...")
        elif isinstance(v, staticmethod):
            body.append("    @staticmethod")
            body.append(f"    def {k}{_sig(v.__func__)}: ...")
        elif isinstance(v, property):
            body.append("    @property")
            body.append(f"    def {k}(self): ...")
        elif not k.startswith("_") and isinstance(v, cls):
            body.append(f"    {k}: '{name}'")  # enum members
    if not body:
        body = ["    ..."]
    out.extend(body)
    out.append("")


def main() -> str:
    # Introspection only — never touch an accelerator backend.
    import jax

    jax.config.update("jax_platforms", "cpu")
    import polychase_tpu.polychase_core as pc

    out = [
        '"""Typing stubs for polychase_core (generated — do not edit).',
        "",
        "Regenerate with:  python scripts/generate_stubs.py",
        '"""',
        "",
        "from enum import Enum",
        "from typing import Any",
        "",
        "import numpy as np",
        "",
    ]
    for name in sorted(pc.__all__):
        obj = getattr(pc, name)
        if inspect.isclass(obj):
            _class_stub(name, obj, out)
        elif callable(obj):
            out.append(f"def {name}{_sig(obj)}: ...")
            out.append("")
        else:
            out.append(f"{name}: Any")
            out.append("")
    return "\n".join(out).rstrip() + "\n"


if __name__ == "__main__":
    text = main()
    dst = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "polychase_tpu", "polychase_core.pyi",
    )
    with open(dst, "w") as f:
        f.write(text)
    print(f"wrote {dst} ({len(text.splitlines())} lines)")
