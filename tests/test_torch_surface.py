"""The port's public surface against the reference's, read from the sources
with ``ast`` (neither package is imported).

Every public top-level name (function, class, constant) and every public
method of ``src/repro`` must exist at the same module path in
``src/repro_torch``, or stand in one of the two tables below:

* ``RENAMED`` maps a reference name to the port's name for the same thing
  (the port's name must exist);
* ``BY_DESIGN`` maps a reference name, or a whole module, to why it has no
  torch meaning, citing ROADMAP C or the kernel table of PERF.md.

A name the port binds by import counts as its twin (``train/fault_tolerance``
re-exports ``sim/journal``'s ``RunJournal``), and a method counts where the
port's class inherits it from a class of the same module. Together the two
tables are the list of what the port does differently. An entry for a name
the port has at the same path is stale and fails its module's case.
"""

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

RENAMED = {
    # the engine's backends: the one-device backend is CUDA's, not GSPMD's
    "sim/engine.py::PjitBackend": "sim/engine.py::CudaBackend",
    "sim/engine.py::HostOffloadBackend": "sim/engine.py::OffloadBackend",
    # the kernels' wrappers: one launch over all shards of a state
    "kernels/ops.py::apply_fused_shard": "kernels/ops.py::fused_apply",
    "kernels/ops.py::apply_shm_shard": "kernels/ops.py::shm_apply",
    "kernels/ops.py::apply_shm_group": "kernels/ops.py::shm_apply",
    "kernels/ref.py::fused_matmul_ref": "kernels/ref.py::fused_apply_ref",
    # the reverse sweep over a leading binding axis, in place of a vmap
    "sim/adjoint.py::AdjointProgram.vmapped": "sim/adjoint.py::AdjointProgram.sweep_",
    # what steady-state serving must not move: shm schedules, not XLA traces
    "serve/service.py::WarmPool.xla_compiles": "serve/service.py::WarmPool.shm_schedules",
}

_NO_XLA = "the port runs eagerly and never jits or lowers to XLA (ROADMAP C, 'No jit, no XLA')"
_HLO = ("reads XLA's HLO text, which the port never produces; Census counts the eager "
        "step's aten ops (ROADMAP C, 'No jit, no XLA')")

BY_DESIGN = {
    "kernels/fusion.py": "the Pallas kernel became csrc/fused_apply.cu (PERF.md kernel table)",
    "kernels/shm.py": "the Pallas kernel became csrc/shm_apply.cu (PERF.md kernel table)",
    "kernels/ops.py::INTERPRET": "Pallas's interpret mode off the TPU; a wrapper runs its "
                                 "kernel's plain version on a CPU tensor (PERF.md kernel table)",
    "sim/engine.py::JitCache": "an LRU of jitted executables: " + _NO_XLA,
    "sim/engine.py::PjitBackend.lower": "lowers the jitted stage loop: " + _NO_XLA,
    "sim/engine.py::ShardMapBackend.lower": "lowers the jitted shard program: " + _NO_XLA,
    "sim/engine.py::HostOffloadBackend.shard_fn": "builds a jitted per-shard executable: "
                                                  + _NO_XLA,
    "sim/engine.py::BACKEND_CHAIN": "the backends' fallback ladder: the port has no backend "
                                    "rungs (ROADMAP C, 'No backend rungs')",
    "launch/hlo_analysis.py::DTYPE_BYTES": _HLO,
    "launch/hlo_analysis.py::parse_hlo": _HLO,
    "launch/hlo_analysis.py::analyze_hlo": _HLO,
    "launch/hlo_analysis.py::roofline_from_hlo": _HLO,
}

# ported, never listed (each also has a test against its reference twin)
PORTED = (
    "sim/statevector.py::probabilities", "sim/statevector.py::measure",
    "sim/engine.py::ExecutionEngine.n_nonlocal", "sim/engine.py::ExecutionEngine.dense_reference",
    "sim/engine.py::Backend.extract", "sim/engine.py::ShardMapBackend.extract",
    "sim/engine.py::DenseBackend.extract", "sim/engine.py::HostOffloadBackend.extract",
    "sim/engine.py::DenseBackend.prepare", "sim/shard_store.py::ShardStore.ndim",
    "sim/apply.py::axis_of_bit", "launch/steps.py::data_axes_for",
)


class Surface:
    """One module's names: ``bound`` (every top-level name, imports too),
    ``public`` (its own public definitions, by line), ``classes`` (name
    -> its method names and its bases' names) and ``origin`` (a name
    imported from a module of the same package -> that module's path)."""

    def __init__(self, path: Path):
        self.path = path
        self.origin: Dict[str, Path] = {}
        self.bound: Set[str] = set()
        self.public: Dict[str, int] = {}
        self.classes: Dict[str, Tuple[Set[str], List[str]]] = {}
        self._visit(ast.parse(path.read_text()).body)

    def _define(self, name: str, line: int) -> None:
        self.bound.add(name)
        if not name.startswith("_"):
            self.public[name] = line

    def _visit(self, body) -> None:
        for s in body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._define(s.name, s.lineno)
            elif isinstance(s, ast.ClassDef):
                self._define(s.name, s.lineno)
                methods = {b.name for b in s.body
                           if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
                self.classes[s.name] = (methods, [ast.unparse(b) for b in s.bases])
            elif isinstance(s, (ast.Assign, ast.AnnAssign)):
                targets = s.targets if isinstance(s, ast.Assign) else [s.target]
                for t in targets:
                    for node in ast.walk(t):
                        if isinstance(node, ast.Name):
                            self._define(node.id, s.lineno)
            elif isinstance(s, (ast.Import, ast.ImportFrom)):
                self.bound.update((a.asname or a.name).split(".")[0] for a in s.names)
                if isinstance(s, ast.ImportFrom) and s.level and s.module:
                    base = self.path.parents[s.level - 1]
                    src = base.joinpath(*s.module.split(".")).with_suffix(".py")
                    self.origin.update({a.asname or a.name: src for a in s.names})
            elif isinstance(s, ast.If):
                self._visit(s.body)
                self._visit(s.orelse)
            elif isinstance(s, ast.Try):
                self._visit(s.body)
                for h in s.handlers:
                    self._visit(h.body)
                self._visit(s.orelse)
                self._visit(s.finalbody)

    def methods(self, cls: str, seen: Tuple[str, ...] = ()) -> Set[str]:
        """``cls``'s methods with those it inherits from classes of this
        module."""
        own, bases = self.classes[cls]
        out = set(own)
        for b in bases:
            if b in self.classes and b not in seen:
                out |= self.methods(b, seen + (cls,))
        return out


_SURFACES: Dict[Path, Optional[Surface]] = {}


def surface(path: Path) -> Optional[Surface]:
    if path not in _SURFACES:
        _SURFACES[path] = Surface(path) if path.exists() else None
    return _SURFACES[path]


def port_has(key: str) -> bool:
    """Whether the port has ``"<module>::<name>"`` or ``"<module>::<Class>.<method>"``."""
    module, _, name = key.partition("::")
    s = surface(PORT / module)
    if s is None:
        return False
    if not name:
        return True
    cls, _, method = name.partition(".")
    if not method:
        return cls in s.bound
    if cls not in s.classes and cls in s.origin:  # a re-exported class
        return port_has(f"{s.origin[cls].relative_to(PORT)}::{name}")
    return cls in s.classes and method in s.methods(cls)


def ref_has(key: str) -> bool:
    module, _, name = key.partition("::")
    s = surface(REF / module)
    if s is None or not name:
        return s is not None
    cls, _, method = name.partition(".")
    if not method:
        return cls in s.public
    return cls in s.classes and method in s.classes[cls][0]


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def missing(module: str) -> List[str]:
    """The reference's public names of ``module`` with no twin, no rename
    and no reason."""
    if module in BY_DESIGN:
        return []
    ref, port = surface(REF / module), surface(PORT / module)
    if port is None:
        return [module]
    out = []
    for name in ref.public:
        key = f"{module}::{name}"
        if key in BY_DESIGN or name in port.bound:
            continue
        if key not in RENAMED:
            out.append(key)
    for cls, (methods, _) in ref.classes.items():
        if cls.startswith("_") or f"{module}::{cls}" in BY_DESIGN:
            continue
        target = RENAMED.get(f"{module}::{cls}", f"{module}::{cls}").partition("::")[2]
        for m in sorted(methods):
            key = f"{module}::{cls}.{m}"
            if m.startswith("_") or key in RENAMED or key in BY_DESIGN:
                continue
            if not port_has(f"{module}::{target}.{m}"):
                out.append(key)
    return out


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_twin(module):
    assert missing(module) == []
    for key, target in RENAMED.items():
        if key.partition("::")[0] != module:
            continue
        assert ref_has(key), f"RENAMED {key}: no such public name in src/repro"
        assert not port_has(key), f"RENAMED {key}: the port has it at the same path (stale)"
        assert port_has(target), f"RENAMED {key}: the port has no {target}"
    for key, why in BY_DESIGN.items():
        if key.partition("::")[0] != module:
            continue
        assert ref_has(key), f"BY_DESIGN {key}: no such public name in src/repro"
        assert not port_has(key), f"BY_DESIGN {key}: the port has it (stale)"
        assert "ROADMAP C" in why or "kernel table" in why, f"BY_DESIGN {key}: cite the reason"


def test_the_tables_name_only_modules_of_the_reference():
    for key in list(RENAMED) + list(BY_DESIGN):
        assert key.partition("::")[0] in MODULES, key


def test_the_last_public_functions_are_ported_not_listed():
    for key in PORTED:
        assert ref_has(key), key
        assert key not in RENAMED and key not in BY_DESIGN, key
    assert not any(missing(key.partition("::")[0]) for key in PORTED)
    # on their own names, not on inherited or imported stand-ins
    for key in ("sim/statevector.py::probabilities", "sim/statevector.py::measure",
                "sim/apply.py::axis_of_bit", "launch/steps.py::data_axes_for"):
        module, _, name = key.partition("::")
        assert name in surface(PORT / module).public, key
    engine = surface(PORT / "sim/engine.py")
    assert {"n_nonlocal", "dense_reference"} <= engine.classes["ExecutionEngine"][0]
    assert "extract" in engine.classes["Backend"][0]
    assert "ndim" in surface(PORT / "sim/shard_store.py").classes["ShardStore"][0]


def test_the_walk_sees_what_it_must():
    """The walk itself: a rename's class maps its methods, inheritance
    within a module counts, and a re-export counts."""
    assert len(MODULES) > 50
    assert port_has("sim/engine.py::CudaBackend.extract")  # Backend's
    assert not port_has("sim/engine.py::CudaBackend.lower")
    assert port_has("train/fault_tolerance.py::RunJournal")  # from sim/journal
    assert port_has("train/fault_tolerance.py::RunJournal.update")
    assert ref_has("sim/engine.py::PjitBackend.execute_sweep")
    assert "sim/engine.py::PjitBackend.execute_sweep" not in missing("sim/engine.py")
