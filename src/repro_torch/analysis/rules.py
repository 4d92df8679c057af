"""AST lint passes, one function per contract family.

Counterpart of ``repro.analysis.rules``.  Each pass takes a parsed
``SourceFile`` and returns ``Finding``s; the walker has already decided
which passes run in which zone (``zones.RULE_ZONES``) and applies pragma
suppression afterwards.

The clock rules (CLK001-CLK003) and the cache rule (TRC001) are the
reference's.  The gradient and dispatch rules keep the reference's ids and
intent in the port's terms: a public op is a module-level public function
with a keyword-only ``chunk`` parameter (the reference keys on ``impl``,
which the port does not have), it routes through ``kernels/vjp.py``
(VJP001), and the kernel layer selects a kernel by the device of its
tensors and nothing else (DSP001, DSP002).  The reference's TRC002 (a
Python branch on a traced value) and TRC003 (a host op in a Pallas kernel
body) have no counterpart: eager PyTorch traces nothing, and the port's
kernel bodies are CUDA C++.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import zones
from repro_torch.analysis.report import Finding
from repro_torch.analysis.walker import SourceFile
from repro_torch.analysis.zones import RULE_SEVERITY

WALL_CLOCK_ATTRS = ("time", "time_ns", "monotonic", "perf_counter",
                    "monotonic_ns", "perf_counter_ns", "process_time")

# Hashable-by-construction annotation names lru_cache parameters may carry.
STATIC_ANNOTATIONS = ("int", "str", "bool", "float", "bytes", "tuple",
                      "frozenset", "type", "None", "Optional")

# The gradient classifications of kernels/vjp.py.
VJP_CLASSES = ("IndexProducer", "Gathering")

# Device names a call must not pin outside the kernel layer.
DEVICE_LITERALS = ("cpu", "cuda")


def _finding(src: SourceFile, node, rule: str, message: str) -> Finding:
    return Finding(path=src.path, line=node.lineno, rule=rule,
                   severity=RULE_SEVERITY[rule], message=message)


def _dotted(node):
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _func_params(fn: ast.FunctionDef):
    a = fn.args
    return a.posonlyargs + a.args + a.kwonlyargs


def _walk_functions(tree):
    """Yield (fn, enclosing_chain) for every function in the module."""
    def rec(node, chain):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, chain
                yield from rec(child, chain + (child,))
            else:
                yield from rec(child, chain)

    yield from rec(tree, ())


def _calls(node):
    """Dotted names of every call under ``node`` ('' where not dotted)."""
    return {_dotted(n.func) or "" for n in ast.walk(node)
            if isinstance(n, ast.Call)}


# -- clock-domain rules (CLK001/CLK002/CLK003) ----------------------------

def check_clocks(src: SourceFile, active) -> list:
    """Wall-clock *calls* are the hazard; references (``clock=time.time``
    as an injectable default) are the sanctioned pattern and are never
    flagged.  One call yields at most one finding: the most specific rule
    wins (CLK001 > CLK002 > CLK003)."""
    enclosing = {}
    for fn, chain in _walk_functions(src.tree):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                cur = enclosing.get(id(node))
                if cur is None or len(cur) < len(chain) + 1:
                    enclosing[id(node)] = chain + (fn,)

    out = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted is None or not dotted.startswith("time."):
            continue
        attr = dotted.split(".", 1)[1]
        if attr not in WALL_CLOCK_ATTRS:
            continue
        chain = enclosing.get(id(node), ())
        in_now_fn = any("now" in [p.arg for p in _func_params(f)]
                        for f in chain)
        if "CLK001" in active:
            out.append(_finding(
                src, node, "CLK001",
                f"time.{attr}() in an injected-clock zone: time must enter "
                f"through the engine clock (the clock-mixing bug class); "
                f"pass now= or use self._clock"))
        elif in_now_fn and "CLK002" in active:
            out.append(_finding(
                src, node, "CLK002",
                f"time.{attr}() inside a function taking now=: use the "
                f"injected now instead of reading the wall clock"))
        elif attr in ("time", "time_ns") and "CLK003" in active:
            out.append(_finding(
                src, node, "CLK003",
                f"time.{attr}() is not monotonic: use time.monotonic() for "
                "intervals, or pragma with a justification if a wall-clock "
                "timestamp is genuinely required"))
    return out


# -- cache keys (TRC001) ---------------------------------------------------

def _is_lru_decorator(dec) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    return (_dotted(target) or "") in ("functools.lru_cache", "lru_cache",
                                       "functools.cache", "cache")


def _annotation_is_static(ann) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):       # None, or a string annotation
        if isinstance(ann.value, str):
            return all(tok.strip(" []|,.") in STATIC_ANNOTATIONS + ("",)
                       for tok in ann.value.split("|"))
        return ann.value is None
    if isinstance(ann, ast.Name):
        return ann.id in STATIC_ANNOTATIONS
    if isinstance(ann, ast.Attribute):      # e.g. typing.Optional
        return ann.attr in STATIC_ANNOTATIONS
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (_annotation_is_static(ann.left)
                and _annotation_is_static(ann.right))
    if isinstance(ann, ast.Subscript):      # tuple[int, ...], Optional[str]
        return _annotation_is_static(ann.value)
    return False


def check_lru_cache(src: SourceFile, active) -> list:
    """``functools.lru_cache`` keys on argument hash: a tensor argument
    hashes by identity, so the cache pins device memory and returns results
    for a tensor whose values have since changed.  The contract: every
    cached parameter carries an annotation hashable by construction."""
    out = []
    for fn, _chain in _walk_functions(src.tree):
        if not any(_is_lru_decorator(d) for d in fn.decorator_list):
            continue
        if fn.args.vararg or fn.args.kwarg:
            out.append(_finding(
                src, fn, "TRC001",
                f"lru_cache on '{fn.name}' with *args/**kwargs: cached "
                f"signatures must be fully annotated static parameters"))
            continue
        for p in _func_params(fn):
            if p.arg in ("self", "cls"):
                continue
            if not _annotation_is_static(p.annotation):
                out.append(_finding(
                    src, fn, "TRC001",
                    f"lru_cache on '{fn.name}': parameter '{p.arg}' is not "
                    f"annotated with a static hashable type (int/str/bool/"
                    f"float/tuple/...): a tensor argument would poison the "
                    f"cache"))
    return out


# -- gradient classification (VJP001) -------------------------------------

def _public_ops(tree):
    """Module-level public functions with a keyword-only ``chunk``
    parameter: the port's public-op signature."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, ast.FunctionDef) and \
                not node.name.startswith("_") and \
                any(p.arg == "chunk" for p in node.args.kwonlyargs):
            yield node


def _classifies(calls) -> bool:
    return any(c.split(".")[-2:] == [cls, "apply"]
               for c in calls for cls in VJP_CLASSES)


def _vjp_factories(tree):
    """Names of module functions that return a classified call, directly
    or through another such function (``_index_producer``)."""
    returns = {}
    for fn, _chain in _walk_functions(tree):
        returns[fn.name] = {_dotted(n.value.func) or "" for n in ast.walk(fn)
                            if isinstance(n, ast.Return)
                            and isinstance(n.value, ast.Call)}
    names = set()
    while True:
        more = {name for name, calls in returns.items() if name not in names
                and (_classifies(calls)
                     or any(c.split(".")[-1] in names for c in calls))}
        if not more:
            return names
        names |= more


def check_vjp_completeness(src: SourceFile, active) -> list:
    """Every public op routes through a ``kernels/vjp.py`` classification:
    ``IndexProducer.apply``, ``Gathering.apply``, or a module function that
    returns one.  An op that called a kernel wrapper bare would ship
    without a gradient rule (a raw kernel output has no ``grad_fn``)."""
    factories = _vjp_factories(src.tree)
    out = []
    for fn in _public_ops(src.tree):
        calls = _calls(fn)
        if not (_classifies(calls)
                or {c.split(".")[-1] for c in calls} & factories):
            out.append(_finding(
                src, fn, "VJP001",
                f"public op '{fn.name}' is not classified via "
                f"kernels/vjp.py (IndexProducer | Gathering): it would "
                f"ship without a gradient rule"))
    return out


# -- dispatch by device (DSP001/DSP002) -----------------------------------

def _reads_environment(node) -> bool:
    """``os.environ`` (any use: a subscript, ``.get``), ``environ`` or a
    call to ``os.getenv``."""
    if isinstance(node, (ast.Attribute, ast.Name)):
        return _dotted(node) in ("os.environ", "environ")
    if isinstance(node, ast.Call):
        return (_dotted(node.func) or "") in ("os.getenv", "getenv")
    return False


def _calls_library(node) -> bool:
    """A call into the built kernel library: a ``fc_*`` entry, or
    ``library()`` itself."""
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) and n.func.attr.startswith("fc_"):
            return True
        if (_dotted(n.func) or "").split(".")[-1] == "library":
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return all(isinstance(s, ast.Raise) for s in handler.body)


def _is_wrapper(fn: ast.FunctionDef) -> bool:
    """A kernel wrapper counts its launches: ``<fn>.launches += 1``."""
    return any(isinstance(n, ast.AugAssign)
               and isinstance(n.target, ast.Attribute)
               and n.target.attr == "launches" for n in ast.walk(fn))


def check_dispatch(src: SourceFile, active) -> list:
    """DSP001: the kernel layer selects a kernel by the device of its
    tensors and nothing else.  No public function takes ``impl``; nothing
    reads the environment; no call into the built library sits in a
    ``try`` whose handler does more than re-raise (that would be a quiet
    fallback to another path); every kernel wrapper branches on
    ``common.on_card``."""
    out = []
    for node in ast.iter_child_nodes(src.tree):
        if isinstance(node, ast.FunctionDef) and \
                not node.name.startswith("_") and \
                any(p.arg == "impl" for p in _func_params(node)):
            out.append(_finding(
                src, node, "DSP001",
                f"'{node.name}' takes impl=: kernel selection follows the "
                f"device of the tensors, not an argument"))
    for node in ast.walk(src.tree):
        if _reads_environment(node):
            out.append(_finding(
                src, node, "DSP001",
                "the kernel layer reads the environment: kernel selection "
                "follows the device of the tensors and nothing else"))
        elif isinstance(node, ast.Try) and \
                any(_calls_library(s) for s in node.body) and \
                not all(_reraises(h) for h in node.handlers):
            out.append(_finding(
                src, node, "DSP001",
                "a call into the kernel library inside a try whose handler "
                "does not re-raise: a CUDA tensor launches the kernel or "
                "raises, it never falls back"))
    for fn, _chain in _walk_functions(src.tree):
        if _is_wrapper(fn) and not any(c.split(".")[-1] == "on_card"
                                       for c in _calls(fn)):
            out.append(_finding(
                src, fn, "DSP001",
                f"kernel wrapper '{fn.name}' does not choose its branch "
                f"through common.on_card"))
    return out


def check_device_literals(src: SourceFile, active) -> list:
    """DSP002: outside the kernel layer (and ``device.py``, the rule every
    entry point resolves its device by), no call pins a device with a
    literal ``device="cpu"`` or ``"cuda"``: it would run a path on the CPU,
    or demand a card, whatever the caller asked for."""
    if src.path.replace("\\", "/").endswith(zones.DEVICE_PATH):
        return []
    out = []
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg == "device" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str) \
                    and kw.value.value.split(":")[0] in DEVICE_LITERALS:
                out.append(_finding(
                    src, node, "DSP002",
                    f"hardcoded device={kw.value.value!r}: thread the "
                    f"device from the caller (repro_torch.device) instead "
                    f"of pinning it at the call site"))
    return out


# -- registry --------------------------------------------------------------

# pass -> the rule ids it can emit (a pass runs iff any of them is active).
_PASSES = (
    (check_clocks, ("CLK001", "CLK002", "CLK003")),
    (check_lru_cache, ("TRC001",)),
    (check_vjp_completeness, ("VJP001",)),
    (check_dispatch, ("DSP001",)),
    (check_device_literals, ("DSP002",)),
)


def run_rules(src: SourceFile, active: frozenset) -> list:
    findings = []
    for fn, rules in _PASSES:
        if any(r in active for r in rules):
            findings.extend(f for f in fn(src, active) if f.rule in active)
    return findings
