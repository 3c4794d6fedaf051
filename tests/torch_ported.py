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


def renamed_definitions(path: pathlib.Path,
                        names: tuple[str, ...]) -> types.ModuleType:
    """The top-level classes, functions and assigned names `names` of
    `path`'s code, renamed as `renamed_module` does, with the module's
    imports of anything but JAX and the reference."""
    src = path.read_text()
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
            keep.append(ast.get_source_segment(src, node))
    mod = types.ModuleType("ported_" + path.stem)
    mod.__file__ = str(path)
    code = "\n\n".join(keep).replace("arbius_tpu.", "arbius_tpu_torch.")
    assert "arbius_tpu." not in code and "import jax" not in code, path
    exec(compile(code, str(path), "exec"), mod.__dict__)
    missing = set(names) - set(vars(mod))
    assert not missing, f"{path.name} has no {sorted(missing)}"
    return mod


def cases(mod: types.ModuleType) -> list[str]:
    return sorted(name for name in vars(mod) if name.startswith("test_"))


def run_case(mod: types.ModuleType, name: str, request) -> None:
    """Call the test `name` of `mod` with the fixtures it names, taken
    from `request` (the calling module must expose `mod`'s own fixtures
    under their names)."""
    fn = getattr(mod, name)
    fn(**{arg: request.getfixturevalue(arg)
          for arg in inspect.signature(fn).parameters})
