"""Reference test modules run on the port: a module's text with
`arbius_tpu.` read as `arbius_tpu_torch.` is loaded as a module of its
own (`renamed_module`), and each of its tests becomes a case of a port
test (`run_case`), so every case drives the port's code and imports
nothing of the reference."""
from __future__ import annotations

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


def cases(mod: types.ModuleType) -> list[str]:
    return sorted(name for name in vars(mod) if name.startswith("test_"))


def run_case(mod: types.ModuleType, name: str, request) -> None:
    """Call the test `name` of `mod` with the fixtures it names, taken
    from `request` (the calling module must expose `mod`'s own fixtures
    under their names)."""
    fn = getattr(mod, name)
    fn(**{arg: request.getfixturevalue(arg)
          for arg in inspect.signature(fn).parameters})
