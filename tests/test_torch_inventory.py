"""The port's inventory against the JAX package's, read from the sources.

For every module of ohm_tsd_slam_tpu/ the module of the same path in
ohm_tsd_slam_tpu_torch/ must bind each public top-level def and class
(defined there or imported into it: raycast_fast's beam_geometry is
grid/raycast.py's), take every parameter name of each
shared function, and export every name of the JAX module's `__all__`.
Each shared class must have each public member of the JAX class's body
(methods and properties, `__init__` and `__call__`, dataclass and
NamedTuple fields, class-level bindings), each method taking every
parameter name of the JAX method, and the port's module must bind each
public upper-case constant that the JAX module assigns at its top level.
A compiled entry point bound as `name = jax.jit(fn, ...)` (the port's
`compiled(fn, ...)`, utils/compiled.py) counts as a def with fn's
parameters, so each `*_jit` name is checked like any other.
The sources are parsed with `ast`; neither package is imported.  What the
port leaves out on purpose stands in the allow-lists below, each entry
with its reason, and an entry that no longer stands for a gap fails.
"""

import ast
import fnmatch
import os

import pytest

from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

limit_cpu_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "ohm_tsd_slam_tpu")
PORT_PKG = os.path.join(REPO, "ohm_tsd_slam_tpu_torch")
PORT_NAME = "ohm_tsd_slam_tpu_torch"

# modules of the JAX package with no counterpart (fnmatch patterns)
ALLOWED_MODULES = {
    "ops/*_pallas.py": "the Pallas TPU kernels: each is a CUDA source in "
                       "csrc/ behind an ops/*_cuda.py wrapper",
    "utils/compile_cache.py": "JAX-only: an XLA executable cache; the CUDA "
                              "kernels stay built in ops/_build.py's "
                              "_build/",
}

# (module, name) of the JAX package with no counterpart in that module
ALLOWED_NAMES = {
    ("ops/__init__.py", "push_pallas"): "re-export of ops/push_pallas.py",
    ("ops/__init__.py", "supports_pallas_push"):
        "the Pallas push's layout test; the CUDA push takes every layout",
    ("utils/trace.py", "jnp_idx"): "JAX-only: an index into a jnp array",
    ("grid/raycast_fast.py", "grid_fingerprint"):
        "SegmentCache.is_stale keys on the tensor and its version (the "
        "fingerprint is permutation-invariant, ROADMAP known faults)",
    ("grid/compact.py", "compact_mask_values"):
        "folded into compact_mask when the compaction was ported",
}
# (module, class, member) of a shared class with no counterpart
ALLOWED_MEMBERS = {
    ("grid/raycast_fast.py", "SegmentCache", "fingerprint"):
        "the port keys its cache on the tensor and its version "
        "(SegmentCache.is_stale)",
    ("registration/twinpoint.py", "TwinInject", "__init__"):
        "the port's TwinInject is a NamedTuple of the same fields",
}

# (module, name) of an upper-case constant of the JAX module the port lacks
ALLOWED_CONSTANTS = {
    ("grid/raycast_fast.py", "USE_PALLAS"):
        "JAX-only: forces the jnp candidate search on a TPU; the port's "
        "wrappers pick kernel or twin by the tensor's device",
    ("grid/compact.py", "FORCE_ONEHOT_PICK"):
        "JAX-only: picks compact_mask_values' one-hot matmul on a TPU; "
        "the port compacts by a cumsum and a gather (kernel E on the "
        "card)",
}

# parameter names of shared functions that the port takes otherwise
RENAMED_PARAMS = {
    "key": (("generator", "seed"),
            "a torch.Generator draws where JAX splits a PRNG key; "
            "multi_robot_slam_step seeds one a robot and step from `seed`"),
}
ALLOWED_PARAMS = {
    ("parallel/distributed.py", "initialize", "coordinator_address"):
        "torchrun's environment (MASTER_ADDR, MASTER_PORT) or init_method",
    ("parallel/distributed.py", "initialize", "num_processes"):
        "torchrun's WORLD_SIZE or world_size",
    ("parallel/distributed.py", "initialize", "process_id"):
        "torchrun's RANK or rank",
    ("parallel/mesh.py", "make_mesh", "devices"):
        "the mesh spans the initialised world's ranks",
}


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _members(cls: ast.ClassDef) -> dict:
    """The bindings of a class body: name -> ("def", params) for a method
    or property, ("bound", None) for a field or a class-level binding."""
    out = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", _params(node))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = ("bound", None)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ("bound", None)
    return out


def _parse(path: str) -> dict:
    """Top-level bindings of a module: name -> ("def", params) for a
    function, ("class", members) with `_members` of its body,
    ("import", (module, name)) for a from-import of a package module,
    ("const", None) for an upper-case name bound by assignment,
    ("bound", None) for anything else; and "__all__" -> the exported
    names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ("def", _params(node))
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ("class", _members(node))
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = (
                    "import", (node.module, alias.name))
        elif isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = (
                    "bound", None)
        elif isinstance(node, ast.Assign):
            wrapped = _wrapped_def(node.value, out)
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    out["__all__"] = [e.value for e in node.value.elts]
                elif isinstance(t, ast.Name) and wrapped is not None:
                    out[t.id] = wrapped
                elif isinstance(t, ast.Name):
                    out[t.id] = ("const" if _constant(t.id) else "bound",
                                 None)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            name = node.target.id
            out[name] = ("const" if _constant(name) else "bound", None)
    return out


def _wrapped_def(value, bindings: dict):
    """("def", params) of `fn` for a compiled entry point
    `jax.jit(fn, ...)` or `compiled(fn, ...)` of a def of the module, else
    None."""
    if not (isinstance(value, ast.Call) and value.args
            and isinstance(value.args[0], ast.Name)):
        return None
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
    fn = bindings.get(value.args[0].id)
    if name in ("jit", "compiled") and fn is not None and fn[0] == "def":
        return fn
    return None


def _constant(name: str) -> bool:
    """A public upper-case module constant (MAX_SEGMENTS, TSDINC)."""
    return name.isupper() and not name.startswith("_")


def _public_member(name: str) -> bool:
    return not name.startswith("_") or name in ("__init__", "__call__")


def _port_module_path(module: str):
    """The source of a dotted module of the port, or None."""
    rel = module.split(".")[1:]
    base = os.path.join(PORT_PKG, *rel)
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def _resolve(path: str, name: str, depth: int = 0):
    """The binding of `name` in the port module at `path`, following
    from-imports of the port's own modules to their def."""
    kind, what = _parse(path).get(name, (None, None))
    if kind == "import" and what[0].startswith(PORT_NAME) and depth < 8:
        target = _port_module_path(what[0])
        if target is None:     # a submodule bound by `from pkg import mod`
            target = _port_module_path(f"{what[0]}.{what[1]}")
            return ("module", None) if target else (None, None)
        return _resolve(target, what[1], depth + 1)
    return kind, what


def _jax_modules() -> list:
    mods = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                mods.append(os.path.relpath(os.path.join(dirpath, f),
                                            JAX_PKG).replace(os.sep, "/"))
    return sorted(mods)


MODULES = _jax_modules()


def _gaps(module: str) -> list:
    """Every name, parameter and export of the JAX module that the port's
    module lacks, allow-listed ones included: (kind, what) pairs."""
    jax_defs = _parse(os.path.join(JAX_PKG, module))
    port_path = os.path.join(PORT_PKG, module)
    if not os.path.exists(port_path):
        return [("module", module)]
    port = _parse(port_path)
    gaps = []
    for name, (kind, what) in ((n, b) for n, b in jax_defs.items()
                               if n != "__all__"):
        if kind not in ("def", "class") or name.startswith("_"):
            continue
        p_kind, p_params = _resolve(port_path, name)
        if p_kind is None:
            gaps.append(("name", name))
            continue
        if kind == "def" and p_kind == "def":
            for param in _missing_params(what, p_params):
                gaps.append(("param", (name, param)))
    for name in jax_defs.get("__all__", []):
        if name not in port.get("__all__", []):
            gaps.append(("export", name))
    return gaps


def _missing_params(jax_params, port_params) -> list:
    """The JAX parameter names a port function lacks (`key` as renamed)."""
    return [p for p in jax_params if p not in port_params
            and not set(RENAMED_PARAMS.get(p, ((),))[0]) & set(port_params)]


def _member_gaps(module: str) -> list:
    """Every member of a shared class, parameter of a shared method and
    upper-case constant of the JAX module that the port's module lacks,
    allow-listed ones included: ("member", (class, name)),
    ("param", ("class.method", param)) and ("constant", name) pairs."""
    port_path = os.path.join(PORT_PKG, module)
    if not os.path.exists(port_path):
        return []
    gaps = []
    for name, binding in _parse(os.path.join(JAX_PKG, module)).items():
        if name == "__all__":
            continue
        kind, what = binding
        if kind == "const":
            if _resolve(port_path, name)[0] is None:
                gaps.append(("constant", name))
            continue
        if kind != "class" or name.startswith("_"):
            continue
        p_kind, p_members = _resolve(port_path, name)
        if p_kind != "class":
            continue           # a missing class is a gap of _gaps
        for member, (m_kind, m_params) in what.items():
            if not _public_member(member):
                continue
            if member not in p_members:
                gaps.append(("member", (name, member)))
                continue
            pm_kind, pm_params = p_members[member]
            if m_kind == "def" and pm_kind == "def":
                for param in _missing_params(m_params, pm_params):
                    gaps.append(("param", (f"{name}.{member}", param)))
    return gaps


def _allowed(module: str, kind: str, what) -> bool:
    if kind == "module":
        return any(fnmatch.fnmatch(module, pat) for pat in ALLOWED_MODULES)
    if kind in ("name", "export"):
        return (module, what) in ALLOWED_NAMES
    if kind == "member":
        return (module, *what) in ALLOWED_MEMBERS
    if kind == "constant":
        return (module, what) in ALLOWED_CONSTANTS
    return (module, *what) in ALLOWED_PARAMS


@pytest.mark.parametrize("module", MODULES)
def test_port_has_the_modules_names(module):
    """The port's module of the same path binds each public def and class
    of the JAX module, takes each parameter of a shared function (`key` as
    `generator`) and exports its `__all__`, but for the allow-lists."""
    missing = [(kind, what) for kind, what in _gaps(module)
               if not _allowed(module, kind, what)]
    assert not missing, f"{module}: the port lacks {missing}"


@pytest.mark.parametrize("module", MODULES)
def test_port_has_the_modules_members(module):
    """Each class that the port's module shares with the JAX module has
    each public member of the JAX class (methods, properties, fields,
    `__init__`, `__call__`), each shared method takes each parameter of
    the JAX method, and the port's module binds each upper-case constant
    that the JAX module assigns, but for the allow-lists."""
    missing = [(kind, what) for kind, what in _member_gaps(module)
               if not _allowed(module, kind, what)]
    assert not missing, f"{module}: the port lacks {missing}"


def test_allow_lists_name_real_gaps():
    """Every allow-listed module, name, member, constant and parameter is
    still a gap (an entry that the port has since filled goes from the
    list), and every allowed name is in a JAX module that exists."""
    found = {(m, kind, what if kind not in ("param", "member")
              else tuple(what))
             for m in MODULES for kind, what in _gaps(m) + _member_gaps(m)}
    for pat in ALLOWED_MODULES:
        hits = [m for m in MODULES if fnmatch.fnmatch(m, pat)]
        assert hits and all((m, "module", m) in found for m in hits), pat
    for module, name in ALLOWED_NAMES:
        assert module in MODULES, module
        assert ((module, "name", name) in found
                or (module, "export", name) in found), (module, name)
    for module, fn, param in ALLOWED_PARAMS:
        assert (module, "param", (fn, param)) in found, (module, fn, param)
    for module, cls, member in ALLOWED_MEMBERS:
        assert (module, "member", (cls, member)) in found, (module, cls,
                                                            member)
    for module, name in ALLOWED_CONSTANTS:
        assert (module, "constant", name) in found, (module, name)


def test_key_is_a_generator_everywhere():
    """Every shared function whose JAX version draws from `key` takes a
    `generator` in the port, or the `seed` of its generators."""
    seen = 0
    for module in MODULES:
        port_path = os.path.join(PORT_PKG, module)
        if not os.path.exists(port_path):
            continue
        for name, binding in _parse(os.path.join(JAX_PKG, module)).items():
            kind, params = binding if name != "__all__" else (None, None)
            if (kind != "def" or "key" not in params
                    or name.startswith("_") or (module, name) in ALLOWED_NAMES):
                continue
            p_kind, p_params = _resolve(port_path, name)
            assert p_kind == "def" and set(RENAMED_PARAMS["key"][0]) & set(
                p_params), (module, name)
            seen += 1
    assert seen >= 10, seen
