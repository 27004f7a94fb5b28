"""The port's public surface against the JAX package's, read from the
sources with `ast` (nothing is imported, so the whole check costs well
under a second).

For every module that both packages have (but `cli.py`, whose click and
argparse spellings differ; its options are compared apart), each public
item of the reference must have a counterpart in the port:

* a module-level function, a class, a class's method or property (looked
  up through the port class's bases too), and a public attribute that a
  method of the reference class assigns on ``self`` (the port may set it,
  assign it at class level, or offer it as a property or method);
* a function's or method's parameters start with the reference's names in
  the reference's order; the port may append parameters with defaults
  (``device``, ``plain``, ``workers``, ``chunk``, ...), and each literal
  default equals the reference's (``jnp.float32``, ``np.float32`` and
  ``torch.float32`` count as equal).

`ALLOWED` names each item the port leaves out on purpose, with the reason
from ROADMAP "Do not port"; an entry that no longer matches a difference
fails the test too, so the list cannot go stale.

`test_command_line_options` holds the set of ``--options`` of the JAX CLI
and of each ported script to the port's counterpart: the port may add
options, every reference option must be there.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "surfh_tpu", "surfh_tpu_torch"

_BANDED_T = ("ROADMAP 'Do not port': the banded-matmul composed transpose, and the rows and "
             "layered transposes and the other apply_composed_plan_*_t spellings; both "
             "composed directions run kernel #1")
_BATCH = ("ROADMAP 'Do not port': pointing_batch, pointing_cat and banded_mp, alternative "
          "spellings the reference ships turned off")
_PACKED = "ROADMAP 'Do not port': packed banded weights, for the upload through the tunnel"
_PLUMBING = ("ROADMAP 'Do not port': JAX program plumbing, which eager torch and the port's "
             "device_tables / to() replace")
_SHARDING = ("ROADMAP 'Do not port': the JAX-only pieces of parallel/, replaced by one "
             "process per device (a jax.sharding.NamedSharding has no counterpart)")

# "module:qualname" (a default as "module:qualname(param)") → why the port
# leaves it out or spells it otherwise
ALLOWED = {
    "core/bilinear.py:apply_composed_plan_banded_t": _BANDED_T,
    "core/bilinear.py:banded_from_coo": _BANDED_T,
    "core/bilinear.py:apply_composed_plan_layered_t": _BANDED_T,
    "core/bilinear.py:ComposedWindowPlan.layers": _BANDED_T,
    "core/bilinear.py:ComposedWindowPlan.linv": _BANDED_T,
    "core/bilinear.py:apply_composed_plan_rows_t": _BANDED_T,
    "core/bilinear.py:bucket_layers": _BANDED_T,
    "core/bilinear.py:rows_from_layers": _BANDED_T,
    "core/bilinear.py:apply_composed_plan_banded_mp_t": _BATCH,
    "core/bilinear.py:banded_mp_from_coo": _BATCH,
    "core/bilinear.py:banded_cat_from_stack": _BATCH,
    "core/bilinear.py:apply_composed_plan_banded_cat_t": _BATCH,
    "core/bilinear.py:batch_composed_plan": _BATCH,
    "core/bilinear.py:batch_composed_layered_t": _BATCH,
    "core/bilinear.py:apply_composed_plan_layered_t_batched": _BATCH,
    "core/bilinear.py:pack_banded_weights": _PACKED,
    "core/bilinear.py:unpack_banded_weights": _PACKED,
    "core/bilinear.py:take_ib": _PLUMBING + " (jnp.take's bounds mode)",
    "core/bilinear.py:apply_csr_transpose_arrays": _PLUMBING + " (plans as traced arguments)",
    "core/bilinear.py:apply_transpose_plan_arrays": _PLUMBING + " (plans as traced arguments)",
    "core/linop.py:build_transpose": _PLUMBING,
    "core/precision.py:gemm_precision": _PLUMBING,
    "models/spectro.py:SpectroSigRLSCT.forward_fn": _PLUMBING,
    "models/spectro.py:SpectroSigRLSCT.adjoint_fn": _PLUMBING,
    "models/spectro.py:SpectroSigRLSCT.adjoint_fn_const": _PLUMBING,
    "models/spectro.py:SpectroSigRLSCT.solver_args": _PLUMBING,
    "models/spectro.py:SpectroSigRLSCT.materialize_otf": _PLUMBING,
    "models/spectro.py:SpectroSigRLSCT.prime_tables": _PLUMBING,
    "models/spectro.py:SpectroSigRLSCT.device_tables": _PLUMBING,
    "models/blind2d.py:DeconvCube.adjoint_fn": _PLUMBING,
    "models/channel.py:Channel.pointing_batch": _BATCH,
    "models/channel.py:Channel.pointing_cat": _BATCH,
    "parallel/fusion.py:ShardedSpectro.x_sharding": _SHARDING,
    "parallel/fusion.py:ShardedSpectro.y_sharding": _SHARDING,
    "parallel/lambda_sharded.py:LambdaShardedChannel.cube_sharding": _SHARDING,
    "parallel/mesh2d.py:ShardedSpectro2D.x_sharding": _SHARDING,
    "preprocessing/shepard.py:exponential_modified_shepard(row_chunk)": (
        "ROADMAP 'Do not port': the Shepard row chunk is a speed knob that changes no "
        "value; the port's default None takes ROW_CHUNK by device"),
    "utils/profiling.py:trace(log_dir)": (
        "ROADMAP 'Do not port': the fixed /tmp trace directory; the port's default is "
        "relative, so a run writes under its own directory"),
}

_DTYPE_MODULES = {"jnp", "np", "numpy", "torch", "jax.numpy"}


@dataclass
class Cls:
    bases: list
    methods: dict = field(default_factory=dict)  # name → FunctionDef (properties included)
    attrs: set = field(default_factory=set)  # public names assigned on self or in the body


@dataclass
class Module:
    functions: dict = field(default_factory=dict)
    classes: dict = field(default_factory=dict)
    aliases: dict = field(default_factory=dict)  # name = expression
    imports: dict = field(default_factory=dict)  # name → (module path, name) or None


def _self_targets(node):
    """Public names a statement assigns as ``self.<name>``."""
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    out = set()
    for t in targets:
        for n in ast.walk(t):
            if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                    and n.value.id == "self" and not n.attr.startswith("_")):
                out.add(n.attr)
    return out


def _resolve_import(pkg: str, mod_rel: str, node: ast.ImportFrom):
    """Repo-relative module path of a ``from ... import`` inside `pkg`, or None."""
    if node.level == 0:
        if not (node.module or "").startswith(pkg + ".") and node.module != pkg:
            return None
        parts = node.module.split(".")[1:]
    else:
        parts = mod_rel.split("/")[:-1]
        parts = parts[: len(parts) - (node.level - 1)] if node.level > 1 else parts
        parts = parts + (node.module.split(".") if node.module else [])
    return "/".join(parts)


def parse_module(pkg: str, rel: str) -> Module:
    with open(os.path.join(ROOT, pkg, rel)) as fh:
        tree = ast.parse(fh.read())
    m = Module()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            m.functions[node.name] = node
        elif isinstance(node, ast.ClassDef):
            c = Cls([ast.unparse(b).split(".")[-1] for b in node.bases])
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    setter = any(isinstance(d, ast.Attribute) and d.attr in ("setter", "deleter")
                                 for d in item.decorator_list)
                    if not setter:
                        c.methods.setdefault(item.name, item)
                    for n in ast.walk(item):
                        c.attrs |= _self_targets(n)
                elif isinstance(item, (ast.Assign, ast.AnnAssign)):
                    targets = item.targets if isinstance(item, ast.Assign) else [item.target]
                    c.attrs |= {t.id for t in targets
                                if isinstance(t, ast.Name) and not t.id.startswith("_")}
            m.classes[node.name] = c
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    m.aliases[t.id] = node.value
        elif isinstance(node, ast.ImportFrom):
            src = _resolve_import(pkg, rel, node)
            for a in node.names:
                m.imports[a.asname or a.name] = None if src is None else (src, a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                m.imports[a.asname or a.name.split(".")[0]] = None
    return m


_CACHE: dict = {}


def module(pkg: str, rel: str):
    """The parsed module, or None where `pkg` has no such file."""
    key = (pkg, rel)
    if key not in _CACHE:
        for cand in (rel + ".py", rel + "/__init__.py") if not rel.endswith(".py") else (rel,):
            if os.path.isfile(os.path.join(ROOT, pkg, cand)):
                _CACHE[key] = parse_module(pkg, cand)
                break
        else:
            _CACHE[key] = None
    return _CACHE[key]


def lookup(pkg: str, rel: str, name: str, depth: int = 0):
    """What `name` is in module `rel` of `pkg`, following aliases and imports
    inside `pkg`: (kind, node, (module, name)) with kind "function" (node a
    FunctionDef), "class" (a Cls) or "other" (another expression, or an
    import from outside `pkg`; node None), or None where `rel` has no
    `name`."""
    m = module(pkg, rel)
    if m is None or depth > 8:
        return None
    if name in m.functions:
        return "function", m.functions[name], (rel, name)
    if name in m.classes:
        return "class", m.classes[name], (rel, name)
    if name in m.aliases:
        v = m.aliases[name]
        if isinstance(v, ast.Name):
            return lookup(pkg, rel, v.id, depth + 1) or ("other", None, None)
        return "other", None, None
    if name in m.imports:
        src = m.imports[name]
        if src is None:
            return "other", None, None
        return lookup(pkg, src[0], src[1], depth + 1) or ("other", None, None)
    return None


def class_chain(pkg: str, rel: str, cls: Cls, depth: int = 0):
    """`cls` and its bases that `pkg` defines, nearest first."""
    out = [cls]
    if depth > 8:
        return out
    for b in cls.bases:
        hit = lookup(pkg, rel, b)
        if hit is not None and hit[0] == "class":
            out += class_chain(pkg, hit[2][0], hit[1], depth + 1)
    return out


def _default(node):
    """A default's comparable value: a literal, a dtype name, or its source."""
    try:
        return ("literal", ast.literal_eval(node))
    except ValueError:
        pass
    src = ast.unparse(node)
    mod, _, attr = src.rpartition(".")
    if mod in _DTYPE_MODULES and re.fullmatch(r"(float|complex|int)\d+|bool_?", attr):
        return ("dtype", attr)
    return ("expr", src)


def params(fn):
    """[(name, kind, default)] of a def; kind is "pos", "*", "kw" or "**"."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defs = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, "pos", d) for p, d in zip(pos, defs)]
    if a.vararg:
        out.append((a.vararg.arg, "*", None))
    out += [(p.arg, "kw", d) for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    if a.kwarg:
        out.append((a.kwarg.arg, "**", None))
    return out


def compare_params(key: str, ref_fn, port_fn) -> list:
    """(key, message) for each way the port's parameters differ from the
    reference's; a default's key names its parameter, ``key(param)``."""
    r, p = params(ref_fn), params(port_fn)
    r_pos = [x[0] for x in r if x[1] == "pos"]
    p_pos = [x[0] for x in p if x[1] == "pos"]
    p_by_name = {x[0]: x for x in p}
    if p_pos[: len(r_pos)] != r_pos:
        return [(key, f"{key}: parameters ({', '.join(p_pos)}) do not start with the "
                      f"reference's ({', '.join(r_pos)})")]
    out = [(key, f"{key}: the port adds {name!r} without a default")
           for name in p_pos[len(r_pos):] if p_by_name[name][2] is None]
    for name, kind, d in r:
        if kind in ("*", "**"):
            if not any(x[1] == kind for x in p):
                out.append((key, f"{key}: no {kind}{name}"))
            continue
        if name not in p_by_name:
            out.append((key, f"{key}: no keyword {name!r}"))
            continue
        pd = p_by_name[name][2]
        want, have = (None if v is None else _default(v) for v in (d, pd))
        if want != have and not (want and have and want[0] == have[0] == "expr"):
            show = [None if v is None else ast.unparse(v) for v in (d, pd)]
            out.append((f"{key}({name})",
                        f"{key}({name}): default {show[0]} in the reference, {show[1]} here"))
    return out


def shared_modules() -> list:
    """Repo-relative paths of the modules both packages have, but cli.py."""
    found = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, REF)):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), os.path.join(ROOT, REF))
            rel = rel.replace(os.sep, "/")
            if rel != "cli.py" and os.path.isfile(os.path.join(ROOT, PORT, rel)):
                found.append(rel)
    return sorted(found)


def surface_differences(rel: str) -> list:
    """(key, message) for each public item of the reference's `rel` that the
    port lacks or spells otherwise."""
    ref = module(REF, rel)
    diffs = []

    def miss(key, what):
        diffs.append((key, f"{key}: {what}"))

    for name, fn in ref.functions.items():
        if name.startswith("_"):
            continue
        key = f"{rel}:{name}"
        hit = lookup(PORT, rel, name)
        if hit is None:
            miss(key, "missing")
        elif hit[0] == "function":
            diffs += compare_params(key, fn, hit[1])
    for cname, rcls in ref.classes.items():
        if cname.startswith("_"):
            continue
        hit = lookup(PORT, rel, cname)
        if hit is None:
            miss(f"{rel}:{cname}", "missing")
            continue
        if hit[0] != "class":
            continue
        chain = class_chain(PORT, hit[2][0], hit[1])
        for mname, rfn in rcls.methods.items():
            if mname.startswith("_") and mname not in ("__init__", "__call__"):
                continue
            key = f"{rel}:{cname}.{mname}"
            pfn = next((c.methods[mname] for c in chain if mname in c.methods), None)
            if pfn is None:
                if not any(mname in c.attrs for c in chain):
                    miss(key, "missing")
                continue
            diffs += compare_params(key, rfn, pfn)
        for attr in sorted(rcls.attrs):
            if attr in rcls.methods:
                continue
            key = f"{rel}:{cname}.{attr}"
            if not any(attr in c.attrs or attr in c.methods for c in chain):
                miss(key, "attribute missing")
    return diffs


@pytest.mark.parametrize("rel", shared_modules())
def test_public_surface_matches_the_reference(rel):
    diffs = surface_differences(rel)
    found = {k for k, _ in diffs}
    open_ = [m for k, m in diffs if k not in ALLOWED]
    stale = [k for k in ALLOWED if k.split(":")[0] == rel and k not in found]
    assert not open_, "\n".join(open_)
    assert not stale, f"allowlist entries that match no difference: {stale}"


def test_the_allowlist_names_shared_modules():
    mods = set(shared_modules())
    assert {k.split(":")[0] for k in ALLOWED} <= mods
    assert all(v.startswith("ROADMAP 'Do not port'") for v in ALLOWED.values())


# ----------------------------------------------------------------------
# command-line options

SCRIPT_PAIRS = {
    "flagship_cg.py": "torch_flagship_cg.py",
    "quality_surface.py": "torch_quality_surface.py",
    "rank_fidelity_audit.py": "torch_rank_fidelity_audit.py",
    "run_fusion_simulated.py": "torch_run_fusion_simulated.py",
    "correct_mrs_data.py": "torch_correct_mrs_data.py",
    "filter_slices.py": "torch_filter_slices.py",
    "learn_templates.py": "torch_learn_templates.py",
    "convert_s3d.py": "torch_convert_s3d.py",
    "run_operator_demo.py": "torch_operator_demo.py",
    "scatter_pallas_proto.py": "torch_scatter_proto.py",
}


def long_options(path: str) -> set:
    """Every ``--option`` a file passes to click.option or add_argument."""
    with open(os.path.join(ROOT, path)) as fh:
        tree = ast.parse(fh.read())
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in ("option", "add_argument"):
            for a in n.args:  # click spells an on / off pair "--on/--off"
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    out |= {o for o in a.value.split("/") if o.startswith("--")}
    return out


@pytest.mark.parametrize("ref, port", [(f"{REF}/cli.py", f"{PORT}/cli.py")]
                         + [(f"scripts/{a}", f"scripts/{b}") for a, b in SCRIPT_PAIRS.items()])
def test_command_line_options(ref, port):
    want = long_options(ref)
    assert want, f"no options read from {ref}"
    missing = want - long_options(port)
    assert not missing, f"{port} lacks {sorted(missing)}"
