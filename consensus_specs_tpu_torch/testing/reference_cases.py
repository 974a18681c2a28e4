"""The JAX package's spec cases (``tests/spec/``) on port-built specs.

A case file stays the one text of its cases: the loader reads it, rewrites
the reference package's name to the port's (as a whole word: the
reference's name is a prefix of the port's), and executes it as a module
of its own under the synthetic package ``PACKAGE``, which mirrors
``tests/spec/`` so that the files' relative imports resolve the same way.
A name the text binds to the port's ``get_spec`` builds for the context's
device (``context.set_spec_device``), as the decorators' specs do.

``case_names`` reads a file's cases from its syntax tree, so a test file
can parametrize over them without importing anything; ``unresolved`` says
why a file cannot run on the port (a fork the port does not build, an
import with no counterpart in the port, or cases that take pytest
parameters or fixtures the loader cannot supply), or None; ``cases`` loads
a file and returns its ``test_*`` callables; ``configured`` sets the
context's device, preset, forks and BLS switch, with the native BLS
backend, and restores them.

Plain pytest fixtures are supplied as pytest would: a case's arguments
from the fixtures of its file and of the ``conftest.py`` files of its
directories (nearest first), each fixture's own arguments likewise, the
autouse fixtures of those files around every case.  A fixture of module,
package or session scope is made once per context (device and preset),
so a case on the card never meets a spec built for the CPU; a function
fixture that yields is torn down after its case.  A fixture with
``params``, ``name`` or ``ids``, a scoped fixture that yields, or an
argument no such fixture supplies (``request``, ``tmp_path``, ...) leaves
the file unresolved.
"""
from __future__ import annotations

import ast
import contextlib
import functools
import importlib
import importlib.abc
import importlib.util
import re
import sys
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

from consensus_specs_tpu_torch.specs import available_forks
from consensus_specs_tpu_torch.specs.builder import FORK_PARENTS

PORT = __name__.split(".")[0]
# the reference package's name: the port's without its suffix
REFERENCE = PORT[: -len("_torch")]
_REFERENCE_WORD = re.compile(rf"\b{REFERENCE}\b")

REPO_ROOT = Path(__file__).resolve().parents[2]
CASES_ROOT = REPO_ROOT / "tests" / "spec"
PACKAGE = "port_spec_cases"

# third-party modules the case files may import besides the standard library
_THIRD_PARTY = ("numpy", "pytest")

# The case files (and directories, ending in "/") that the tier-1 tests run
# on CPU-built specs and ``chip_smoke.py`` on CUDA-built ones: every epoch
# sub-step, the voluntary exit and proposer slashing operations, slots
# (with its config-override case), basic rewards, the altair sync
# aggregate and config override, the bellatrix execution payload, the
# capella withdrawals and BLS-to-execution changes, and every case of the
# research forks (custody game, sharding, and the experimental file that
# also runs eip4844 and das); ``tier1_cases`` gives the mainline forks'
# part, ``research_cases`` the research forks'
TIER1 = (
    "phase0/epoch_processing/",
    "phase0/block_processing/test_process_voluntary_exit.py",
    "phase0/block_processing/test_process_proposer_slashing.py",
    "phase0/sanity/test_slots.py",
    "phase0/rewards/test_basic.py",
    "altair/epoch_processing/",
    "altair/test_sync_aggregate.py",
    "altair/unittests/test_config_override.py",
    "bellatrix/test_process_execution_payload.py",
    "capella/test_withdrawals.py",
    "capella/test_bls_to_execution_change.py",
    "capella/epoch_processing/test_process_full_withdrawals.py",
    "custody_game/",
    "sharding/",
    "experimental/",
)

# the case directories of the research forks (``experimental`` is no fork
# of its own: its file builds the forks it names)
RESEARCH_DIRECTORIES = ("custody_game", "sharding", "experimental")

# cases of the ``TIER1`` files that take several seconds each on the CPU
# (a pairing check in Python, an erasure recovery): the tier-1 tests mark
# them slow; ``chip_smoke.py`` runs them
TIER1_SLOW_CASES = (
    ("experimental/test_experimental_forks.py", "test_das_sample_verify_and_reconstruct"),
    ("experimental/test_experimental_forks.py", "test_degree_proof_pairing_identity"),
)


def rewrite(text: str) -> str:
    """``text`` with every import of the reference package turned to the
    port's."""
    return _REFERENCE_WORD.sub(PORT, text)


def case_files() -> List[str]:
    """Every case file under ``tests/spec/``, relative to it."""
    return sorted(p.relative_to(CASES_ROOT).as_posix()
                  for p in CASES_ROOT.rglob("test_*.py"))


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def case_names(relpath: str) -> List[str]:
    """The file's ``test_*`` names in their order: its functions and the
    names it assigns, read from its syntax tree."""
    names = []
    for node in _tree(CASES_ROOT / relpath).body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name) and t.id.startswith("test")]
    return names


def always_bls_case_names(relpath: str) -> List[str]:
    """The file's cases decorated with ``always_bls`` (they check
    signatures whatever the context's BLS default), read from its syntax
    tree, in their order."""
    marked = {node.name for node in _tree(CASES_ROOT / relpath).body
              if isinstance(node, ast.FunctionDef)
              and any(getattr(d, "id", None) == "always_bls"
                      for d in node.decorator_list)}
    return [name for name in case_names(relpath) if name in marked]


def _port_module_exists(name: str) -> bool:
    path = REPO_ROOT.joinpath(*name.split("."))
    return path.with_suffix(".py").is_file() or (path / "__init__.py").is_file()


def _relative_target(path: Path, level: int, module: Optional[str]) -> Path:
    base = path.parent
    for _ in range(level - 1):
        base = base.parent
    return base.joinpath(*module.split(".")) if module else base


def _missing_imports(path: Path, seen: set) -> Iterator[str]:
    """The imports of ``path`` and of the case-tree files it imports
    relatively that have no counterpart here."""
    if path in seen:
        return
    seen.add(path)
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.ImportFrom) and node.level:
            target = _relative_target(path, node.level, node.module)
            files = ([target.with_suffix(".py")] if target.with_suffix(".py").is_file()
                     else [target / f"{a.name}.py" for a in node.names])
            for f in files:
                if f.is_file():
                    yield from _missing_imports(f, seen)
            continue
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top == REFERENCE:
                if not _port_module_exists(rewrite(name)):
                    yield name
            elif top not in sys.stdlib_module_names and top not in _THIRD_PARTY:
                yield name


def _fixture_files(path: Path) -> List[Path]:
    """The files whose fixtures a case of ``path`` sees, nearest first:
    the file, then the ``conftest.py`` files of its directories up to the
    case tree's root."""
    out = [path]
    base = path.parent
    while base == CASES_ROOT or CASES_ROOT in base.parents:
        if (base / "conftest.py").is_file():
            out.append(base / "conftest.py")
        base = base.parent
    return out


@functools.lru_cache(maxsize=None)
def _fixture_marks(path: Path) -> Dict[str, dict]:
    """The module-level fixtures of ``path`` by name: scope, autouse,
    whether the fixture yields, its arguments, and the decorator's
    arguments the loader cannot honor."""
    out = {}
    for node in _tree(path).body:
        if not isinstance(node, ast.FunctionDef):
            continue
        for d in node.decorator_list:
            call = d if isinstance(d, ast.Call) else None
            if ast.unparse(call.func if call else d) != "pytest.fixture":
                continue
            keywords = {k.arg: k.value for k in call.keywords} if call else {}
            scope = keywords.get("scope")
            autouse = keywords.get("autouse")
            out[node.name] = {
                "scope": scope.value if isinstance(scope, ast.Constant) else "function",
                "autouse": isinstance(autouse, ast.Constant) and autouse.value is True,
                "yields": any(isinstance(n, (ast.Yield, ast.YieldFrom))
                              for n in ast.walk(node)),
                "args": [a.arg for a in node.args.args],
                "unsupported": (sorted(set(keywords) - {"scope", "autouse"})
                                + (["positional"] if call and call.args else [])
                                + (["scope"] if scope is not None
                                   and not isinstance(scope, ast.Constant) else [])),
            }
    return out


def _lookup(files, name: str):
    """``(file, mark)`` of the nearest fixture called ``name``, or None."""
    for f in files:
        mark = _fixture_marks(f).get(name)
        if mark is not None:
            return f, mark
    return None


def _unsupplied(files, names, chain=()) -> List[str]:
    """The arguments among ``names`` (and their fixtures' arguments) that
    no fixture the loader can honor supplies."""
    bad = []
    for name in names:
        found = None if name in chain else _lookup(files, name)
        if found is None:
            bad.append(name)
            continue
        mark = found[1]
        if mark["unsupported"] or (mark["yields"] and mark["scope"] != "function"):
            bad.append(name)
            continue
        bad += _unsupplied(files, mark["args"], (*chain, name))
    return bad


def _autouse(files) -> List[str]:
    """The autouse fixtures' names, the farthest file's first (the order
    pytest sets them up in), each name once."""
    names: List[str] = []
    for f in reversed(files):
        names += [n for n, m in _fixture_marks(f).items()
                  if m["autouse"] and n not in names]
    return names


def _takes_pytest_arguments(node: ast.FunctionDef, files) -> bool:
    """A pytest-native test: parametrized or marked, or taking arguments
    that neither a decorator of the spec DSL nor a plain fixture of its
    files supplies."""
    decorators = [ast.unparse(d) for d in node.decorator_list]
    if any(d.startswith("pytest.") for d in decorators):
        return True
    if decorators or not node.args.args:
        return False
    return bool(_unsupplied(files, [a.arg for a in node.args.args]))


def unresolved(relpath: str) -> Optional[str]:
    """Why the case file cannot run on port-built specs, or None."""
    fork = relpath.split("/")[0]
    if fork not in FORK_PARENTS and fork not in RESEARCH_DIRECTORIES:
        return f"the port builds no {fork} spec"
    path = CASES_ROOT / relpath
    files = _fixture_files(path)
    seen: set = set()
    missing = sorted({name for f in files for name in _missing_imports(f, seen)})
    if missing:
        return "imports " + ", ".join(missing)
    autouse = _unsupplied(files, _autouse(files))
    if autouse:
        return "pytest fixtures it cannot supply: " + ", ".join(autouse)
    native = [n.name for n in _tree(path).body
              if isinstance(n, ast.FunctionDef) and n.name.startswith("test")
              and _takes_pytest_arguments(n, files)]
    if native:
        return "pytest fixtures or parameters: " + ", ".join(native)
    return None


def loadable_cases(forks) -> List[tuple]:
    """``(file, name)`` of every case the loader can run in the case
    directories of ``forks``."""
    return [(f, name) for f in case_files()
            if f.split("/")[0] in forks and unresolved(f) is None
            for name in case_names(f)]


def tier1_cases() -> List[tuple]:
    """``(file, name)`` of every case of the ``TIER1`` subset in the
    mainline forks' directories."""
    return [(f, name) for f, name in loadable_cases(tuple(available_forks()))
            if f.startswith(TIER1)]


def research_cases() -> List[tuple]:
    """``(file, name)`` of every loadable case of the research forks."""
    return loadable_cases(RESEARCH_DIRECTORIES)


class _CaseFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Serves ``PACKAGE.<dotted path>`` from ``tests/spec/<path>.py``,
    rewritten to the port."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != PACKAGE and not fullname.startswith(PACKAGE + "."):
            return None
        base = CASES_ROOT.joinpath(*fullname.split(".")[1:])
        if base.is_dir():
            spec = importlib.util.spec_from_loader(
                fullname, self, origin=str(base / "__init__.py"), is_package=True)
            spec.submodule_search_locations = [str(base)]
        elif base.with_suffix(".py").is_file():
            spec = importlib.util.spec_from_loader(
                fullname, self, origin=str(base.with_suffix(".py")))
        else:
            return None
        spec.has_location = True
        return spec

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        path = Path(module.__spec__.origin)
        text = path.read_text() if path.is_file() else ""
        # dont_inherit: this module's future imports stay out of the text
        code = compile(rewrite(text), str(path), "exec", dont_inherit=True)
        exec(code, module.__dict__)
        _bind_get_spec(module)


_finder = _CaseFinder()


def _context_get_spec(fork: str, preset_name: str = "minimal", device=None):
    """``get_spec`` on the context's device unless the caller names one."""
    from consensus_specs_tpu_torch.specs import get_spec
    from consensus_specs_tpu_torch.testing import context

    return get_spec(fork, preset_name,
                    context.spec_device() if device is None else device)


def _bind_get_spec(module) -> None:
    from consensus_specs_tpu_torch.specs import get_spec

    for name, value in list(vars(module).items()):
        if value is get_spec:
            setattr(module, name, _context_get_spec)


def load(relpath: str):
    """The case file as a module of ``PACKAGE`` (loaded once)."""
    if _finder not in sys.meta_path:
        sys.meta_path.insert(0, _finder)
    dotted = relpath[: -len(".py")].replace("/", ".")
    return importlib.import_module(f"{PACKAGE}.{dotted}")


def _plain_function(fixture) -> Callable:
    """The function under a ``pytest.fixture`` decorator (whose wrapper
    refuses a direct call), across pytest's versions."""
    unwrap = getattr(fixture, "_get_wrapped_function", None)
    if unwrap is not None:
        return unwrap()
    wrapped = getattr(fixture, "__pytest_wrapped__", None)
    if wrapped is not None:
        return wrapped.obj
    return getattr(fixture, "__wrapped__", fixture)


# values of the fixtures of module, package or session scope, by
# (file, name, the context's device, preset)
_SCOPED: dict = {}


class _Fixtures:
    """The fixture values of one case, and the teardowns of the ones that
    yield."""

    def __init__(self, files: List[Path]):
        self.files = files
        self.values: dict = {}
        self.teardowns: list = []

    def get(self, name: str):
        if name in self.values:
            return self.values[name]
        from consensus_specs_tpu_torch.testing import context

        path, mark = _lookup(self.files, name)
        key = (path, name, str(context.spec_device()),
               context.DEFAULT_TEST_PRESET)
        if mark["scope"] != "function" and key in _SCOPED:
            value = _SCOPED[key]
        else:
            fn = _plain_function(getattr(
                load(path.relative_to(CASES_ROOT).as_posix()), name))
            args = [self.get(a) for a in mark["args"]]
            if mark["yields"]:
                teardown = fn(*args)
                value = next(teardown)
                self.teardowns.append(teardown)
            else:
                value = fn(*args)
            if mark["scope"] != "function":
                _SCOPED[key] = value
        self.values[name] = value
        return value

    def close(self) -> None:
        """Run the teardowns, the last set up first."""
        while self.teardowns:
            teardown = self.teardowns.pop()
            for _ in teardown:
                raise RuntimeError("a fixture yielded more than once")


def _with_fixtures(relpath: str, fn: Callable, argnames: List[str]) -> Callable:
    """``fn`` with its fixture arguments and its files' autouse fixtures
    supplied (``fn`` itself when it needs neither)."""
    files = _fixture_files(CASES_ROOT / relpath)
    autouse = _autouse(files)
    if not autouse and not argnames:
        return fn

    @functools.wraps(fn)
    def case():
        fixtures = _Fixtures(files)
        try:
            for name in autouse:
                fixtures.get(name)
            return fn(*[fixtures.get(a) for a in argnames])
        finally:
            fixtures.close()

    return case


def _fixture_arguments(relpath: str) -> Dict[str, List[str]]:
    """The arguments of the file's undecorated ``test_*`` functions (the
    decorated ones get theirs from the spec DSL's decorators)."""
    return {node.name: [a.arg for a in node.args.args]
            for node in _tree(CASES_ROOT / relpath).body
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test")
            and not node.decorator_list}


def cases(relpath: str) -> Dict[str, Callable]:
    """The file's ``test_*`` callables by name, each taking no argument:
    the plain fixtures a case asks for, and its files' autouse fixtures,
    are supplied around it."""
    module = load(relpath)
    arguments = _fixture_arguments(relpath)
    return {name: _with_fixtures(relpath, getattr(module, name),
                                 arguments.get(name, []))
            for name in case_names(relpath)}


@contextlib.contextmanager
def configured(device, preset: str = "minimal", forks=None,
               bls_active: bool = True, bls_backend: str = "native"):
    """The context builds its specs for ``device`` at ``preset``, runs the
    given forks (None: every fork the port builds) and checks signatures
    with ``bls_backend`` (the native host backend by default; "torch", the
    device backend, runs its pairing checks on ``device`` too) unless
    ``bls_active`` is False; every global it sets is restored on exit."""
    from consensus_specs_tpu_torch.crypto import bls
    from consensus_specs_tpu_torch.testing import context

    saved = (context.DEFAULT_TEST_PRESET, context.DEFAULT_PYTEST_FORKS,
             context.DEFAULT_BLS_ACTIVE, bls.backend_name(), bls.bls_active)
    previous_device = context.set_spec_device(device)
    device_bls, previous_bls_device = None, None
    try:
        context.DEFAULT_TEST_PRESET = preset
        if forks is not None:
            context.DEFAULT_PYTEST_FORKS = tuple(forks)
        context.DEFAULT_BLS_ACTIVE = bls_active
        if bls_active:
            if bls_backend == "torch":
                from consensus_specs_tpu_torch.ops import bls as device_bls

                previous_bls_device = device_bls.set_device(device)
            bls.use_backend(bls_backend)
        yield
    finally:
        if device_bls is not None:
            device_bls.set_device(previous_bls_device)
        context.set_spec_device(previous_device)
        (context.DEFAULT_TEST_PRESET, context.DEFAULT_PYTEST_FORKS,
         context.DEFAULT_BLS_ACTIVE) = saved[:3]
        bls.use_backend(saved[3])
        bls.bls_active = saved[4]
