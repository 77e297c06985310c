"""zangc: the zangscript compiler CLI (tools/zangc.zig equivalent; port of
zang_tpu/script/zangc.py).

    python -m zang_tpu_torch.script.zangc [options] script.txt

Options (mirroring zangc.zig:9-26):
  -o, --output FILE     emit a generated Python module (the Zig-source
                        emitter's analog: reconstructs the compiled script,
                        exposes the port's ScriptInstrument factories, and
                        embeds the lowered IR as LOWERED_IR)
  --dump-parse FILE     write the AST dump
  --dump-codegen FILE   write the bytecode dump
  --dump-lowered FILE   write the lowered device-IR dump (the diffable
                        generated-source analog, codegen_zig.zig:461-577)
  --dump-builtins FILE  write the builtin registry dump
  --add-builtins MODULE[:Class,...]  register user builtins (written
                        against torch: render gets torch tensors)
  --color WHEN          auto|always|never (diagnostic coloring)
  -h, --help
"""

import argparse
import sys

from .compile import builtin_packages, compile_script
from .errors import ScriptError
from . import printers


def load_user_builtins(spec: str) -> dict:
    """--add-builtins MODULE[:Class,Class] — import user DSL builtins.

    MODULE is a dotted module path or a .py file path. Named classes are
    registered via builtins.builtin_from_class; with no names, every
    class in the module that declares PARAMS/Params and render() is
    registered. The working analog of the reference's disabled
    --add-builtins/parse_builtins (zangc.zig:14-15, tools/zangc/
    parse_builtins.zig)."""
    import importlib

    from .builtins import user_package

    modpath, _, names = spec.partition(":")
    if modpath.endswith(".py"):
        import importlib.util
        import os

        mspec = importlib.util.spec_from_file_location(
            "zang_user_builtins_" + os.path.basename(modpath)[:-3], modpath)
        mod = importlib.util.module_from_spec(mspec)
        mspec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(modpath)
    if names:
        classes = [getattr(mod, n) for n in names.split(",") if n]
    else:
        classes = [
            v for v in vars(mod).values()
            if isinstance(v, type)
            and (hasattr(v, "PARAMS") or hasattr(v, "Params"))
            and callable(getattr(v, "render", None))
        ]
        if not classes:
            raise SystemExit(f"--add-builtins {spec}: no builtin classes found")
    return user_package(*classes, name=modpath)


def generate_python(cs, script_path: str, add_builtins=()) -> str:
    """Emit a standalone Python module for the compiled script.

    The generated module embeds the script source and rebuilds the compiled
    form at import (deterministic), exposing `load()` and
    `make_instrument(name, param_map=None)`. This replaces the reference's
    Zig source emitter: the "generated code" plans torch render programs,
    so the artifact is the script + an entry point that makes the
    instrument, rather than hand-lowered source text.
    """
    src = cs.source.contents
    names = [em.name for em in cs.exported_modules]
    lowered = printers.dump_lowered(cs)
    return f'''"""Generated by zangc from {script_path} — do not edit.

Exported modules: {", ".join(names)}
"""

from zang_tpu_torch.script import compile_script
from zang_tpu_torch.script.torch_backend import ScriptInstrument

SCRIPT_SOURCE = {src!r}

EXPORTED_MODULES = {names!r}

# user builtin specs (--add-builtins) re-registered at load
ADD_BUILTINS = {list(add_builtins)!r}

# the lowered IR each exported module plans to (diffable snapshot;
# regenerate with: python -m zang_tpu_torch.script.zangc --dump-lowered)
LOWERED_IR = {lowered!r}

_compiled = None


def load():
    global _compiled
    if _compiled is None:
        packages = None
        if ADD_BUILTINS:
            from zang_tpu_torch.script.compile import builtin_packages
            from zang_tpu_torch.script.zangc import load_user_builtins

            packages = builtin_packages() + [
                load_user_builtins(s) for s in ADD_BUILTINS
            ]
        _compiled = compile_script(SCRIPT_SOURCE, filename={script_path!r},
                                   packages=packages)
    return _compiled


def make_instrument(name, param_map=None):
    return ScriptInstrument(load(), name, param_map)
'''


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zangc", description=__doc__)
    ap.add_argument("script")
    ap.add_argument("-o", "--output")
    ap.add_argument("--dump-parse")
    ap.add_argument("--dump-codegen")
    ap.add_argument("--dump-lowered")
    ap.add_argument("--dump-builtins")
    ap.add_argument("--add-builtins", action="append", default=[],
                    metavar="MODULE[:Class,...]",
                    help="register user Python modules as DSL builtins")
    ap.add_argument("--color", choices=["auto", "always", "never"], default="auto")
    args = ap.parse_args(argv)

    color = (args.color == "always") or (
        args.color == "auto" and sys.stderr.isatty())

    packages = builtin_packages()
    for spec in args.add_builtins:
        packages.append(load_user_builtins(spec))

    if args.dump_builtins:
        with open(args.dump_builtins, "w") as f:
            f.write(printers.dump_builtins(packages))

    with open(args.script) as f:
        contents = f.read()
    try:
        cs = compile_script(contents, filename=args.script, color=color,
                            packages=packages)
    except ScriptError as e:
        print(e.render(color), file=sys.stderr)
        return 1

    if args.dump_parse:
        with open(args.dump_parse, "w") as f:
            f.write(printers.dump_parse(cs))
    if args.dump_codegen:
        with open(args.dump_codegen, "w") as f:
            f.write(printers.dump_codegen(cs))
    if args.dump_lowered:
        with open(args.dump_lowered, "w") as f:
            f.write(printers.dump_lowered(cs))
    if args.output:
        with open(args.output, "w") as f:
            f.write(generate_python(cs, args.script, args.add_builtins))
    print(f"compiled {args.script}: "
          f"{len(cs.exported_modules)} exported module(s): "
          f"{', '.join(em.name for em in cs.exported_modules)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
