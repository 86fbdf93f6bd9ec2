"""repro_torch.analysis against repro.analysis, on the CPU.

AST layer: each of the reference's five golden fixtures
(``tests/analysis/fixtures``), translated to torch inline here, trips the
port's rule exactly once, at the line and code at which the reference's
engine trips on the original; the engines agree on suppressions, unknown
codes and syntax errors; the port's tree lints clean against an empty
``astlint`` section, and the reference's lint of ``src/`` (which covers the
port's suppressions) stays clean.

Graph layer: for each of the nine registry entries, the port's keys on the
CPU equal the reference checker's keys on the reference's entry, except the
rows of ``KEY_EXCEPTIONS``. The reference's checker reads ``jax.core.Var``,
which jax 0.9 moved to ``jax.extend.core``: a module-scoped shim hands it
that namespace, and its keys are computed once a module. Each check fires
on a planted fault and stays silent on its fixed twin.
"""
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.analysis import lint_paths as ref_lint_paths
from repro.analysis import lint_source as ref_lint_source
from repro_torch.analysis import (DEFAULT_BASELINE, ENTRY_POINTS, check_entry, check_fn,
                                  check_trace, lint_paths, lint_source, load_baseline,
                                  new_findings, package_relpath, trace_entry, trace_fn)
from repro_torch.analysis import cli
from repro_torch.kernels import launch

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "analysis" / "fixtures"

# ----------------------------------------------------------------------------
# AST layer
# ----------------------------------------------------------------------------
#: The reference's golden fixtures in torch, line for line: (fixture,
#: the reference's relpath, the port's relpath, code, torch source).
GOLDEN = [
    ("rpl001_raw_ldexp.py.txt", "repro/core/scaling_fixture.py",
     "repro_torch/core/scaling_fixture.py", "RPL001", '''"""Golden fixture: trips RPL001 exactly once (raw ldexp, tensor exponent).

Linted under relpath repro_torch/core/scaling_fixture.py. The
constant-exponent call below must NOT trip: a literal exponent cannot
overflow the 2.0**e materialization.
"""
import torch


def apply_scale(x, e):
    y = torch.ldexp(x, e)         # RPL001: non-constant exponent
    z = torch.ldexp(x, -40)       # clean: constant exponent
    return y + z
'''),
    ("rpl002_sorted_fold.py.txt", "repro/linalg/fold_fixture.py",
     "repro_torch/linalg/fold_fixture.py", "RPL002", '''"""Golden fixture: trips RPL002 exactly once (sorted() fold in a
bitwise-contract module). Linted under repro_torch/linalg/fold_fixture.py.
The plain dict iteration below must NOT trip: insertion order IS the fold
contract.
"""


def fold(blocks, acc):
    for k in sorted(blocks):      # RPL002: key order != elimination order
        acc = acc - blocks[k]
    for k in blocks:              # clean: insertion-order fold
        acc = acc + blocks[k]
    return acc
'''),
    ("rpl003_host_np.py.txt", "repro/models/layer_fixture.py",
     "repro_torch/models/layer_fixture.py", "RPL003", '''"""Golden fixture: trips RPL003 exactly once (host np. math in a traced
function). Linted under repro_torch/models/layer_fixture.py. The same call
in the undecorated helper must NOT trip, and np dtype accesses are exempt.
"""
import numpy as np
import torch


@torch.compile
def traced(x):
    return np.log(x) + 1.0        # RPL003: host math under torch.compile


def host_helper(x):
    return np.log(np.asarray(x, dtype=np.float64))  # clean: not traced
'''),
    ("rpl004_legacy_kwargs.py.txt", "repro/serve/engine_fixture.py",
     "repro_torch/serve/engine_fixture.py", "RPL004", '''"""Golden fixture: trips RPL004 exactly once (deprecated scheme= kwarg).
Linted under repro_torch/serve/engine_fixture.py. The spec-string call
must NOT trip: positional specs are the supported API.
"""
from repro_torch.core import ozmm


def run(a, b):
    bad = ozmm(a, b, scheme="ozaki2-fp8")   # RPL004: legacy kwarg threading
    good = ozmm(a, b, "ozaki2-fp8/fast@8")  # clean: spec string
    return bad, good
'''),
    ("rpl005_unpinned_matmul.py.txt", "repro/core/residue_fixture.py",
     "repro_torch/core/residue_fixture.py", "RPL005", '''"""Golden fixture: trips RPL005 exactly once (matmul without both
operands cast to float64). Linted under repro_torch/core/residue_fixture.py.
The pinned call must NOT trip.
"""
import torch


def residue_mma(a, b):
    bad = torch.matmul(a, b)                                   # RPL005
    good = torch.matmul(a.to(torch.float64), b.double())        # clean
    return bad, good
'''),
]


@pytest.mark.parametrize("fixture,ref_path,path,code,source", GOLDEN,
                         ids=[g[3] for g in GOLDEN])
def test_golden_translation_trips_like_the_reference(fixture, ref_path, path, code, source):
    ref = ref_lint_source((FIXTURES / fixture).read_text(), ref_path)
    got = lint_source(source, path)
    assert [(f.code, f.line) for f in got] == [(f.code, f.line) for f in ref] \
        == [(code, ref[0].line)], [f.render() for f in got]
    assert got[0].fix_hint
    # every rule is scoped to the package: out of it the source is clean
    assert lint_source(source, "scripts/offline_tool.py") == []


#: torch's other spellings and the scopes, each (relpath, source, codes).
SPELLINGS = [
    ("repro_torch/kernels/x.py", "import torch\ny = torch.exp2(e)\n", ["RPL001"]),
    ("repro_torch/linalg/x.py", "import torch\ny = torch.pow(2.0, e)\n", ["RPL001"]),
    ("repro_torch/core/x.py", "import torch\ny = 2.0 ** e\n", ["RPL001"]),
    ("repro_torch/core/x.py", "import torch\ny = torch.exp2(-40) + torch.pow(2.0, -40) + torch.pow(x, e)\n",
     []),
    ("repro_torch/obs/x.py", "import torch\ny = torch.exp2(e)\n", []),  # out of the numeric core
    ("repro_torch/core/numerics.py", "import torch\ny = torch.ldexp(x, e)\n", []),  # owns ldexp_wide
    ("repro_torch/serve/x.py", "import numpy as np\ny = np.ldexp(x, e)\n", ["RPL001"]),
    ("repro_torch/core/collectives.py", "def f(s):\n    return [t for t in set(s)]\n", ["RPL002"]),
    ("repro_torch/models/x.py", "import torch, numpy as np\n@torch.func.functionalize\ndef f(x):\n"
     "    return np.exp(x)\n", ["RPL003"]),
    ("repro_torch/kernels/x.py", "import torch, numpy as np\n@torch.library.custom_op('a::b', "
     "mutates_args=())\ndef f(x):\n    return np.exp(x)\n", ["RPL003"]),
    ("repro_torch/models/x.py", "y = GemmConfig(scheme='ozaki2-fp8')\n", ["RPL004"]),
    ("repro_torch/precision/x.py", "y = GemmConfig(scheme='ozaki2-fp8')\n", []),
    ("repro_torch/models/x.py", "import torch\ny = torch.mm(a.to(torch.float64), b)\n", ["RPL005"]),
    ("repro_torch/models/x.py", "import torch\ny = torch.bmm(a.double(), b.double())\n", []),
    ("repro_torch/core/numerics.py", "import torch\ny = torch.matmul(a, b)\n", []),
    ("repro_torch/models/x.py", "y = a @ b + torch.einsum('ij,jk->ik', a, b)\n", []),
    # a float32 cast does not pin: TF32 may still narrow the product on the card
    ("repro_torch/models/x.py", "import torch\ny = torch.mm(a.float(), b.to(torch.float32))\n",
     ["RPL005"]),
    ("repro_torch/models/x.py", "import torch\ny = torch.mm(a.to(dtype=torch.int32), b.long())\n",
     []),
]


@pytest.mark.parametrize("path,source,codes", SPELLINGS,
                         ids=[f"{i}-{s[2][0] if s[2] else 'clean'}" for i, s in enumerate(SPELLINGS)])
def test_torch_spellings(path, source, codes):
    assert [f.code for f in lint_source(source, path)] == codes


# The marker is assembled at runtime: written literally inside these strings
# it would make a lint of THIS file read them as suppressions of its lines.
def _suppress(code: str, reason: str = "") -> str:
    tail = f"({reason})" if reason else ""
    return "# reprolint: " + f"disable={code}{tail}"


#: The codes both engines give on each case (the reference's engine tests).
ENGINE_CODES = {"reasoned": [], "bare": ["RPL000", "RPL005"], "unknown": ["RPL000"],
                "syntax": ["RPL000"]}


def _sources(name: str) -> tuple[str, str]:
    """(the reference's source, the port's) of one engine case."""
    if name == "unknown":
        src = "x = 1  " + _suppress("RPL999", "no such rule") + "\n"
        return src, src
    if name == "syntax":
        return "def broken(:\n", "def broken(:\n"
    marker = (_suppress("RPL005", "fixture: bounded by test harness") if name == "reasoned"
              else _suppress("RPL005"))
    body = "def f(a, b):\n    return {}.matmul(a, b)  " + marker + "\n"
    return ("import jax.numpy as jnp\n" + body.format("jnp"),
            "import torch\n" + body.format("torch"))


@pytest.mark.parametrize("name", list(ENGINE_CODES))
def test_engine_agrees_with_the_reference(name):
    ref_src, src = _sources(name)
    ref = sorted(f.code for f in ref_lint_source(ref_src, "repro/core/x.py"))
    got = sorted(f.code for f in lint_source(src, "repro_torch/core/x.py"))
    assert got == ref == ENGINE_CODES[name]


def test_package_relpath_mapping():
    assert package_relpath("src/repro_torch/linalg/blas3.py") == "repro_torch/linalg/blas3.py"
    assert package_relpath("/abs/src/repro_torch/core/plan.py") == "repro_torch/core/plan.py"
    assert package_relpath("repro_torch/models/layers.py") == "repro_torch/models/layers.py"
    assert package_relpath("src/repro/core/plan.py") == "src/repro/core/plan.py"
    assert package_relpath("tools/gen.py") == "tools/gen.py"


def test_port_tree_is_clean_and_the_reference_lint_stays_clean():
    """``reprolint-torch`` exits 0 through an EMPTY astlint section (sites
    are fixed or suppressed with a reason), and the reference's engine, which
    lints all of src/ (the port's suppressions included), finds nothing."""
    data = load_baseline(DEFAULT_BASELINE)
    assert data["astlint"] == []
    findings = lint_paths([REPO / "src" / "repro_torch"])
    assert new_findings(findings, data, "astlint") == [], [f.render() for f in findings]
    assert ref_lint_paths([REPO / "src"]) == []


# ----------------------------------------------------------------------------
# Graph layer: parity with the reference's checker
# ----------------------------------------------------------------------------
#: Keys on one side only: (key, side, reason).
KEY_EXCEPTIONS = [
    *((f"{entry}:RPJ002:mul->sub:int32:{shape}", "port",
       "the port's centered_mod centres with the product p * (r > half); the "
       "reference's selects with jnp.where, no product (values < 2^11)")
      for entry, shape in (("ozmm[fp8-fast]", "8x8"), ("ozmm[fp8-accurate]", "8x8"),
                           ("ozmm[int8-fast]", "8x8"), ("ozmm_prepared[fp8-fast]", "8x8"),
                           ("ozmm_pallas_fused[ref]", "8x8"),
                           ("lu_factor[device-step]", "16x16"))),
    ("decode_slots[paged]:RPJ001:convert:float64->float32:", "reference",
     "a scalar cast of the reference's x64 trace (a weak-typed position "
     "constant); the port's positions are int32 throughout"),
    ("decode_slots[paged]:RPJ002:mul->add:int32:2x2x1", "reference",
     "the port's paged_gather forms the page addresses in int64 (.long() "
     "before the product); the reference's in int32"),
]


@pytest.fixture(scope="module")
def reference_keys():
    """The reference checker's keys for each of its entries, once a module."""
    import jax
    from jax.extend import core as jcore

    import repro.analysis.jaxpr_check as jc
    from repro.analysis.registry import ENTRY_POINTS as REF_ENTRIES

    jax.config.update("jax_enable_x64", True)  # before any entry builds
    shim = types.SimpleNamespace(Var=jcore.Var, ClosedJaxpr=jcore.ClosedJaxpr,
                                 Jaxpr=jcore.Jaxpr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jc, "jax_core", shim)
        return {e.name: {f.key for f in jc.check_entry(e)} for e in REF_ENTRIES}


def test_registry_mirrors_the_reference():
    from repro.analysis.registry import ENTRY_POINTS as REF_ENTRIES

    assert [(e.name, e.policy, e.bitwise, e.inplace) for e in ENTRY_POINTS] == \
        [(e.name, e.policy, e.bitwise, e.donate) for e in REF_ENTRIES]


@pytest.mark.parametrize("entry", ENTRY_POINTS, ids=lambda e: e.name)
def test_graph_keys_match_the_reference(entry, reference_keys):
    port = {f.key for f in check_entry(entry, "cpu")}
    ref = reference_keys[entry.name]
    expect_port_only = {k for k, side, _ in KEY_EXCEPTIONS
                        if side == "port" and k.startswith(entry.name + ":")}
    expect_ref_only = {k for k, side, _ in KEY_EXCEPTIONS
                       if side == "reference" and k.startswith(entry.name + ":")}
    assert port - ref == expect_port_only
    assert ref - port == expect_ref_only
    data = load_baseline(DEFAULT_BASELINE)
    assert {e["key"] for e in data["graph"] if e["key"].startswith(entry.name + ":")} == port
    assert all(e.get("note") for e in data["graph"])


@pytest.mark.parametrize("entry", [e for e in ENTRY_POINTS if e.name.startswith("ozmm[")],
                         ids=lambda e: e.name)
def test_kernel_route_twin_finds_only_baselined_keys_outside_k1(entry):
    """The trace the card's route gives on the CPU (``+pallas``: K1's plain
    version): K1 ran as one scope whose inputs are the 9 int32 frames, and
    the findings outside it are baselined (the card must find nothing else)."""
    tr = trace_entry(entry, "cpu", "+pallas")
    assert [(s.name, s.launched) for s in tr.scopes] == [("ozmm_fused_raw", False)]
    assert [d for d, _ in tr.scopes[0].in_types] == ["int32"] * 9
    assert tr.scopes[0].out_types == (("float64", (128, 128)),)
    findings = check_trace(entry.name, tr, bitwise=True)
    outside = {f.key for f in findings if f.scope is None}
    assert outside <= {e["key"] for e in load_baseline(DEFAULT_BASELINE)["graph"]}
    assert {f.scope for f in findings} <= {None, "ozmm_fused_raw"}


def test_cli_both_layers_on_the_cpu(tmp_path, capsys):
    assert cli.main([str(REPO / "src" / "repro_torch"), "--graph", "--device", "cpu"]) == 0
    assert "graph (cpu): 0 new finding(s), 25 baselined across 9 entry points" \
        in capsys.readouterr().out
    # the refresh procedure: rewriting the section keeps every key and note
    out = tmp_path / "baseline.json"
    out.write_text(DEFAULT_BASELINE.read_text())
    assert cli.main(["--graph-only", "--device", "cpu", "--baseline", str(out),
                     "--update-baseline"]) == 0
    assert load_baseline(out) == load_baseline(DEFAULT_BASELINE)
    assert cli.main(["--list-rules"]) == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="raises only where there is no card")
def test_cli_graph_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--graph-only"])


# ----------------------------------------------------------------------------
# Graph layer: each check on a planted fault and its fixed twin
# ----------------------------------------------------------------------------
def _codes(findings):
    return sorted({f.check for f in findings})


def _f64(*shape):
    return torch.as_tensor(np.random.default_rng(0).standard_normal(shape))


def test_rpj001_narrowing_downcast():
    x = _f64(4, 4)
    found = check_fn("synthetic", lambda x: (x.float() * 2).double(), (x,))
    assert [f.key for f in found] == ["synthetic:RPJ001:convert:float64->float32:4x4"]
    # dead: the cast never reaches an output; widening is no finding
    assert check_fn("synthetic", lambda x: (x.float(), x * 2.0)[1], (x,)) == []
    assert check_fn("synthetic", lambda x: x.double() * 2, (x.float(),)) == []
    # copy_ into a float32 buffer narrows as well
    assert _codes(check_fn("synthetic", lambda x: torch.empty(4, 4).copy_(x), (x,))) == ["RPJ001"]


def test_rpj002_int32_chain_with_python_scalars_and_in_place():
    a = torch.ones((3, 3), dtype=torch.int32)
    assert [f.key for f in check_fn("synthetic", lambda a, b: a * b + a, (a, a))] == \
        ["synthetic:RPJ002:mul->add:int32:3x3"]
    # a Python int is int32 here, as the reference's weak-typed literal
    assert [f.signature for f in check_fn("synthetic", lambda a: 7 - 5 * a, (a,))] == \
        ["RPJ002:mul->sub:int32:3x3"]
    # torch sums an int32 tensor into int64 unless asked for int32
    assert check_fn("synthetic", lambda a: (a * 3).sum(0), (a,)) == []
    assert [f.signature for f in check_fn("synthetic", lambda a: (a * 3).sum(0, dtype=torch.int32),
                                          (a,))] == ["RPJ002:mul->reduce_sum:int32:3x3"]

    def in_place(a):
        t = a.clone()
        t.mul_(3)
        return t.add_(a)

    assert _codes(check_fn("synthetic", in_place, (a,))) == ["RPJ002"]
    # widened, or a product that accumulates nothing
    assert check_fn("synthetic", lambda a, b: a.long() * b.long() + a.long(), (a, a)) == []
    assert check_fn("synthetic", lambda a, b: (a * b).double(), (a, a)) == []


def test_rpj003_in_place_arguments():
    x = _f64(4)
    unused = check_fn("synthetic", lambda x, y: y * 2.0, (x, x.clone()), inplace=(0,))
    assert [f.signature for f in unused] == ["RPJ003:unused-donated:0"]
    assert "never written" in unused[0].message
    passthrough = check_fn("synthetic", lambda x, y: (x, x + y), (x, x.clone()), inplace=(0,))
    assert [f.signature for f in passthrough] == ["RPJ003:passthrough-donated:0"]

    def copied(pool, vals):  # the update went to a copy of the pool
        new = pool.clone()
        new[torch.tensor([1, 2])] = vals
        return new

    def written(pool, vals):  # the paged-cache idiom: a view written in place
        pool.view(2, 2)[0] = vals
        return pool

    assert _codes(check_fn("synthetic", copied, (x.clone(), x[:2].clone()), inplace=(0,))) \
        == ["RPJ003"]
    assert check_fn("synthetic", written, (x.clone(), x[:2].clone()), inplace=(0,)) == []


def test_rpj004_unordered_float_accumulation_only_under_bitwise():
    idx = torch.tensor([1, 1, 3])

    def index_add(x, v):
        return x.index_add(0, idx, v)

    def accumulate(x, v):
        return x.index_put_((idx,), v, accumulate=True)

    for fn in (index_add, accumulate):
        x, v = torch.zeros(8, dtype=torch.float64), torch.ones(3, dtype=torch.float64)
        found = check_fn("synthetic", fn, (x, v), bitwise=True)
        assert [f.signature for f in found] == ["RPJ004:scatter-add:float64:8"]
        assert check_fn("synthetic", fn, (x.clone(), v), bitwise=False) == []
        # integer accumulation is associative: order cannot change the bits
        xi, vi = torch.zeros(8, dtype=torch.int32), torch.ones(3, dtype=torch.int32)
        assert check_fn("synthetic", fn, (xi, vi), bitwise=True) == []


def test_kernel_launch_is_a_node_of_the_graph():
    """A kernel's output is written outside aten (here through numpy, as
    ctypes writes on the card): without the launch record the cast feeding
    it looks dead; with it, the cast reaches the output."""
    @launch.kernel_scope("fake_kernel")
    def kernel(x32, *, mark: bool):
        out = torch.empty(x32.shape, dtype=torch.float64)
        out.numpy()[:] = x32.numpy()
        if mark:
            launch.raise_on_error("fake_kernel", None, 0)
        return out

    x = _f64(4, 4)
    for mark, want in ((True, ["RPJ001"]), (False, [])):
        tr = trace_fn(lambda x: kernel(x.float(), mark=mark), (x,))
        assert [(s.name, s.launched) for s in tr.scopes] == [("fake_kernel", mark)]
        assert _codes(check_trace("synthetic", tr)) == want
    assert launch.RECORDERS == []
