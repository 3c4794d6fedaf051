"""Reference test modules run on the port: a module's text with
`arbius_tpu.` read as `arbius_tpu_torch.` is loaded as a module of its
own (`renamed_module`), and each of its tests becomes a case of a port
test (`run_case`), so every case drives the port's code and imports
nothing of the reference. From a module whose other tests need JAX,
`renamed_definitions` loads only the named definitions."""
from __future__ import annotations

import ast
import inspect
import pathlib
import types


def renamed_module(path: pathlib.Path) -> types.ModuleType:
    """`path`'s code with the reference's package renamed to the port's."""
    mod = types.ModuleType("ported_" + path.stem)
    mod.__file__ = str(path)
    src = path.read_text().replace("arbius_tpu.", "arbius_tpu_torch.")
    assert "arbius_tpu." not in src and "import jax" not in src, path
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def renamed_definitions(path: pathlib.Path, names: tuple[str, ...],
                        env: dict | None = None) -> types.ModuleType:
    """The top-level classes, functions and assigned names `names` of
    `path`'s code, renamed as `renamed_module` does, with the module's
    imports of anything but JAX and the reference, and the globals `env`
    (the port's objects for the names the dropped imports bound)."""
    src = path.read_text()
    lines = src.splitlines()
    keep = []
    for node in ast.parse(src).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module or ""])
            if all(m.split(".")[0] not in ("jax", "flax", "arbius_tpu")
                   for m in mods):
                keep.append(ast.get_source_segment(src, node))
        elif getattr(node, "name", None) in names or (
                isinstance(node, ast.Assign) and
                {getattr(t, "id", None) for t in node.targets} & set(names)):
            # with its decorators (a test's parametrize marks)
            first = min([d.lineno for d in
                         getattr(node, "decorator_list", [])] + [node.lineno])
            keep.append("\n".join(lines[first - 1:node.end_lineno]))
    mod = types.ModuleType("ported_" + path.stem)
    mod.__file__ = str(path)
    mod.__dict__.update(env or {})
    code = "\n\n".join(keep).replace("arbius_tpu.", "arbius_tpu_torch.")
    assert "arbius_tpu." not in code and "import jax" not in code, path
    exec(compile(code, str(path), "exec"), mod.__dict__)
    missing = set(names) - set(vars(mod))
    assert not missing, f"{path.name} has no {sorted(missing)}"
    return mod


def cases(mod: types.ModuleType) -> list[str]:
    return sorted(name for name in vars(mod) if name.startswith("test_"))


def parametrized_cases(mod: types.ModuleType,
                       names: list[str]) -> list[tuple[str, str, dict]]:
    """(case id, test name, parameters) for each test `names` of `mod`:
    a test under `pytest.mark.parametrize` once per combination of its
    parameter sets (ids `name[i-j]`, indices into each mark's values)."""
    out = []
    for name in names:
        combos = [("", {})]
        for mark in getattr(getattr(mod, name), "pytestmark", []):
            if mark.name != "parametrize":
                continue
            argnames, values = mark.args[:2]
            argnames = ([a.strip() for a in argnames.split(",")]
                        if isinstance(argnames, str) else list(argnames))
            combos = [(f"{tag}-{i}" if tag else str(i),
                       {**given, **dict(zip(argnames, v if len(argnames) > 1
                                            else (v,)))})
                      for i, v in enumerate(values) for tag, given in combos]
        out += [(f"{name}[{tag}]" if tag else name, name, given)
                for tag, given in combos]
    return out


def run_case(mod: types.ModuleType, name: str, request,
             params: dict | None = None) -> None:
    """Call the test `name` of `mod` with `params` and the fixtures it
    names, taken from `request` (the calling module must expose `mod`'s
    own fixtures under their names)."""
    fn = getattr(mod, name)
    params = params or {}
    fn(**{arg: params[arg] if arg in params
          else request.getfixturevalue(arg)
          for arg in inspect.signature(fn).parameters})
