"""The port's multi-device path against the JAX package, word for word.

The port's meshes here are grids of CPU devices driven by one process (the
JAX package's tests run its meshes on the 8 virtual host devices of
tests/conftest.py); every comparison is exact. One JAX context (N=2^13,
8 Q + 4 P towers of 26/27 bits, 2 digits of 4, FIXEDMANUAL, seed 13: the
shape of tests/test_sharded_fused.py, whose kqlp = 12 divides limb axes
of 2 and 4) holds the tables of both sides; its eval key is made of
seeded random residues, which `convert` carries over, and the words fed
to both sides come from seeded numpy generators too. The JAX package's
Pallas kernels run in interpret mode (`ks_fused.INTERPRET`), as its own
tests run them; its modular matmul through `mod_matmul_jnp`.
"""

import ast
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

from openfhe_tpu.lattice import rns_tools as jrt  # noqa: E402
from openfhe_tpu.lattice.basis import make_basis as jmake_basis  # noqa
from openfhe_tpu.lattice.dcrt import Poly as JPoly  # noqa: E402
from openfhe_tpu.math import modops as jmo  # noqa: E402
from openfhe_tpu.math.nbtheory import first_prime, previous_prime  # noqa
from openfhe_tpu.ops import modmatmul as jmm  # noqa: E402
from openfhe_tpu.ops import ntt4step as j4  # noqa: E402
from openfhe_tpu.parallel import ntt_sharded as jns  # noqa: E402
from openfhe_tpu.parallel import sharded_fused as jsf  # noqa: E402
from openfhe_tpu.pke import constants as jc  # noqa: E402
from openfhe_tpu.pke import context as jctx  # noqa: E402
from openfhe_tpu.pke import keys as jkeys  # noqa: E402
from openfhe_tpu.pke import parameters as jprm  # noqa: E402
from openfhe_tpu.pke.keyswitch import hybrid as jhybrid  # noqa: E402
from openfhe_tpu.pke.keyswitch import ks_fused as jks  # noqa: E402

from openfhe_tpu_torch import convert  # noqa: E402
from openfhe_tpu_torch import parallel as par  # noqa: E402
from openfhe_tpu_torch.lattice.basis import make_basis  # noqa: E402
from openfhe_tpu_torch.math.modops import to_u32, u32_tensor  # noqa: E402
from openfhe_tpu_torch.ops import modmatmul, ntt, ntt4step  # noqa: E402
from openfhe_tpu_torch.parallel import ntt_sharded as ns  # noqa: E402
from openfhe_tpu_torch.parallel import sharded as shd  # noqa: E402
from openfhe_tpu_torch.parallel import sharded_fused as sf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(ring_dim=1 << 13, mult_depth=7, scaling_mod_size=26,
          first_mod_size=26, aux_mod_size=27, num_large_digits=2)
LIMB = 4
ROWS = ("limb", None)
# a 31-bit prime (= 1 mod 2^14) within the JAX package's int8-limb range
# (|w| <= 127 * (2^24 + 2^16 + 2^8 + 1))
Q31 = previous_prime(2_139_000_000, 1 << 14)


def _rand(rng, moduli, n, lead=()):
    q = np.array(moduli, np.uint64).reshape(-1, 1)
    v = rng.integers(0, 1 << 62, size=lead + (len(moduli), n),
                     dtype=np.uint64)
    return (v % q).astype(np.uint32)


def _eq(got, want):
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


def _cpu_mesh(limb, dp=1):
    return par.make_mesh(limb, dp, devices=["cpu"])


@pytest.fixture(scope="module")
def jax_side():
    p = jprm.CCParams(scheme=jc.Scheme.CKKSRNS_SCHEME,
                      security_level=jc.SecurityLevel.HEStd_NotSet,
                      scaling_technique=jc.ScalingTechnique.FIXEDMANUAL, **KW)
    cc = jctx.GenCryptoContext(p, seed=13)
    assert (len(cc.moduli_q), len(cc.moduli_p)) == (8, 4)
    n = cc.ring_dim
    # the functions under test are exact in the key's words, so a key of
    # seeded random residues (with its Shoup companions) stands in for
    # EvalMultKeyGen's, which would cost a keygen's compiles
    qp = list(cc.moduli_q) + list(cc.moduli_p)
    rng = np.random.default_rng(13)
    bv, av = (_rand(rng, qp, n, (KW["num_large_digits"],)) for _ in "ba")
    q64 = np.array(qp, np.uint64).reshape(-1, 1)
    sh = lambda v: ((v.astype(np.uint64) << np.uint64(32)) // q64).astype(
        np.uint32)
    ek = jkeys.EvalKey(bv=jnp.asarray(bv), av=jnp.asarray(av),
                       bv_sh=jnp.asarray(sh(bv)), av_sh=jnp.asarray(sh(av)),
                       key_tag="key-r")
    cc.eval_mult_keys[ek.key_tag] = ek
    port_ek = convert.eval_key_from_numpy(
        bv, av, key_tag=ek.key_tag, device="cpu", bv_sh=sh(bv), av_sh=sh(av))
    bq, bp = make_basis(cc.moduli_q, n), make_basis(cc.moduli_p, n)
    port_tabs = lambda size, pad=None: sf.make_sharded_fused_tables_basis(
        bq, bp, size, KW["num_large_digits"], port_ek, pad)
    return dict(cc=cc, ek=ek, port_ek=port_ek, tabs=port_tabs, bq=bq)


@pytest.fixture(scope="module")
def chain(jax_side):
    """JAX's unsharded chain (tensor product + keyswitch_core, then
    rt.drop_last_and_scale, then the product again at kql 7), as
    __graft_entry__.dryrun_multichip builds its oracle, on random words."""
    cc, ek = jax_side["cc"], jax_side["ek"]
    rng = np.random.default_rng(5)
    a = [_rand(rng, cc.moduli_q, cc.ring_dim) for _ in range(4)]

    def mult_relin(a0, a1, b0, b1, size):
        tabs = cc.hybrid_tables(size)
        bl = tabs.basis_ql
        mm = lambda x, y: jmo.mul_mod(x, y, bl.q, bl.r32, bl.r32_sh, bl.m32)
        d0, d1 = jhybrid.keyswitch_core(mm(a1, b1), ek, tabs)
        c1 = jmo.add_mod(mm(a0, b1), mm(a1, b0), bl.q)
        return (jmo.add_mod(mm(a0, b0), d0, bl.q), jmo.add_mod(c1, d1, bl.q))

    mult_relin = jax.jit(mult_relin, static_argnums=4)  # one compile a size
    j = [jnp.asarray(x) for x in a]
    prod = mult_relin(*j, 8)
    rtab = cc.rescale_tables(8)
    drop = jax.jit(lambda x: jrt.drop_last_and_scale(
        JPoly(x, 1), cc.basis_q, rtab).data)
    resc = [drop(x) for x in prod]
    prod2 = mult_relin(*resc, *resc, 7)
    sq = mult_relin(j[0], j[1], j[0], j[1], 8)
    as_np = lambda xs: [np.asarray(x) for x in xs]
    return dict(a=a, prod=as_np(prod), resc=as_np(resc),
                prod2=as_np(prod2), sq=as_np(sq))


# ---------------------------------------------------------------------------
# kernel l and the 4-step NTT
# ---------------------------------------------------------------------------

def test_mod_matmul_twin_matches_jax():
    """Row l's plain twin == JAX's mod_matmul_jnp (int8-limb weights) and
    an independent int64 product, on a 26-bit and a 31-bit prime."""
    moduli = [first_prime(26, 1 << 13), Q31]
    rng = np.random.default_rng(1)
    w = _rand(rng, moduli, 64, (64,)).transpose(1, 0, 2).copy()  # [2,64,64]
    x = _rand(rng, moduli, 128, (64,)).transpose(1, 0, 2).copy()  # [2,64,128]
    x[:, 0, 0] = np.array(moduli) - 1
    q = torch.tensor(moduli, dtype=torch.int64).view(-1, 1)
    got = modmatmul.mod_matmul(u32_tensor(w), u32_tensor(x), q.int())
    limbs = np.moveaxis(jmm.balanced_limbs_host(w.astype(np.int64)), 0, 1)
    want = jmm.mod_matmul_jnp(jnp.asarray(limbs), jnp.asarray(x),
                              jmm.make_mod_matmul_consts(moduli))
    _eq(got, want)
    wl, xl = torch.from_numpy(w.astype(np.int64)), torch.from_numpy(
        x.astype(np.int64))
    lo, hi = torch.bmm(wl, xl & 0xFFFF), torch.bmm(wl, xl >> 16)
    exact = (hi % q[:, :, None] * 65536 + lo) % q[:, :, None]
    assert torch.equal(got.long(), exact)


def test_4step_tables_match_jax():
    n = 1 << 12
    for q in (first_prime(26, 2 * n), Q31):
        for got, want in zip(ntt4step._tower_tables_raw(q, n),
                             j4._tower_tables_raw(q, n)):
            np.testing.assert_array_equal(got, want)


def test_4step_ntt_matches_jax_and_ntt():
    """ntt_fwd_4step / ntt_inv_4step (on kernel l's twin) == JAX's 4-step
    (jnp path) and the port's ntt_fwd / ntt_inv, with a batch axis."""
    n = 1 << 12
    moduli = [first_prime(26, 2 * n), Q31]
    tb, jb = make_basis(moduli, n), jmake_basis(moduli, n)
    x = _rand(np.random.default_rng(2), moduli, n, (2,))
    fwd = ntt4step.ntt_fwd_4step(u32_tensor(x), tb)
    _eq(fwd, j4.ntt_fwd_4step(jnp.asarray(x), jb))
    assert torch.equal(fwd, ntt.ntt_fwd(u32_tensor(x), tb))
    inv = ntt4step.ntt_inv_4step(u32_tensor(x), tb)
    _eq(inv, j4.ntt_inv_4step(jnp.asarray(x), jb))
    assert torch.equal(inv, ntt.ntt_inv(u32_tensor(x), tb))


@pytest.mark.parametrize("limb", [2, 4])
def test_ntt_sharded_matches_jax(limb):
    """The staged NTT on a CPU mesh == JAX's ntt_fwd_sharded /
    ntt_inv_sharded on the virtual mesh (wrong all_to_all chunk orders
    permute words that stay in range: only word equality catches them)."""
    n = 1 << 12
    q0 = first_prime(26, 2 * n)
    moduli = [q0, Q31]
    tb, jb = make_basis(moduli, n), jmake_basis(moduli, n)
    x = _rand(np.random.default_rng(limb), moduli, n)
    jmesh = JMesh(np.array(jax.devices()[:limb]), ("limb",))
    mesh = _cpu_mesh(limb)
    fwd = ns.ntt_fwd_sharded(u32_tensor(x), tb, mesh)
    _eq(fwd, jns.ntt_fwd_sharded(jnp.asarray(x), jb, jmesh))
    inv = ns.ntt_inv_sharded(fwd, tb, mesh)
    _eq(inv, jns.ntt_inv_sharded(jnp.asarray(to_u32(fwd)), jb, jmesh))
    _eq(inv, x)


# ---------------------------------------------------------------------------
# kernels n, o, p: plain twins against JAX's Pallas kernels, per shard
# ---------------------------------------------------------------------------

def _jax_shard(st, idx, limb=LIMB):
    """Shard idx's slice of every sharded leaf of JAX's tables, by its
    table_specs (what shard_map hands the body)."""
    leaves, tree = jax.tree_util.tree_flatten(st)
    specs = tree.flatten_up_to(jsf.table_specs(st))

    def cut(x, spec):
        for ax, name in enumerate(spec):
            if name == "limb":
                return np.split(np.asarray(x), limb, axis=ax)[idx]
        return x
    return jax.tree_util.tree_unflatten(
        tree, [cut(x, s) for x, s in zip(leaves, specs)])


@pytest.fixture(scope="module")
def shard_kernels(jax_side):
    """JAX's three sharded kernels (interpret mode) on shards 1 and 3 of
    limb 4 at kql 8 (kqlp_loc 3), on random words."""
    cc = jax_side["cc"]
    n = cc.ring_dim
    st = jsf.make_sharded_fused_tables(cc, 8)
    nd, alpha, kqlp_loc, kql_loc = st.nd, st.alpha, 3, 2
    rng = np.random.default_rng(9)
    mq, mqlp = list(cc.moduli_q), list(cc.moduli_q) + list(cc.moduli_p)
    y2 = np.concatenate([_rand(rng, mq[j * alpha:(j + 1) * alpha], n)
                         for j in range(nd)])
    pc = _rand(rng, cc.moduli_p, n, (2,))
    c2 = _rand(rng, mq, n)
    out = {}
    jks.INTERPRET = True
    try:
        for idx in (1, 3):
            sl = _jax_shard(st, idx)
            rows = mqlp[idx * kqlp_loc:(idx + 1) * kqlp_loc]
            conv = _rand(rng, rows, n, (nd,))              # [nd, rows, N]
            take = np.minimum(idx * kqlp_loc + np.arange(kqlp_loc), 7)
            conv4 = jnp.asarray(conv.transpose(1, 0, 2).reshape(
                kqlp_loc, nd, st.r, st.c))
            out[idx] = dict(
                conv=conv,
                n=np.asarray(jsf._conv_digits_rows(jnp.asarray(y2), sl,
                                                   kqlp_loc * nd)),
                o=np.asarray(jsf._conv_p_to_q_rows(jnp.asarray(pc), sl,
                                                   kql_loc)),
                p=np.asarray(jsf._ntt_keymul_acc_sharded(
                    conv4, jnp.asarray(c2[take].reshape(kqlp_loc, st.r,
                                                        st.c)),
                    sl, kqlp_loc)).reshape(2, kqlp_loc, n))
    finally:
        jks.INTERPRET = False
    return dict(y2=y2, pc=pc, c2=c2, nd=nd, alpha=alpha, out=out)


@pytest.mark.parametrize("idx", [1, 3])
@pytest.mark.parametrize("row", ["n", "o", "p"])
def test_shard_kernel_twins_match_jax(jax_side, shard_kernels, row, idx):
    """Shard 1 holds Q rows 3-5 (row 3 digit 0's own, rows 4-5 digit 1's),
    shard 3 P rows 9-11 (never own). JAX's n stacks rows tau-major (tau,
    j); the port's are digit-major."""
    k = shard_kernels
    v = sf.shard_view(jax_side["tabs"](8), LIMB, idx, "cpu")
    want = k["out"][idx][row]
    if row == "n":
        y_pad = u32_tensor(k["y2"]).view(k["nd"], k["alpha"], -1)
        got = sf.conv_digits_rows(y_pad, v).transpose(0, 1)
        want = want.reshape(got.shape)
    elif row == "o":
        got = sf.conv_p_to_q_rows(u32_tensor(k["pc"]), v)
    else:
        got = sf.ntt_keymul_acc_rows(u32_tensor(k["out"][idx]["conv"]),
                                     u32_tensor(k["c2"]), v)
    _eq(got, want)


# ---------------------------------------------------------------------------
# the sharded mult + relinearize and the chain
# ---------------------------------------------------------------------------

def _sharded(x, mesh, spec=ROWS):
    return par.shard(u32_tensor(x), mesh, spec)


@pytest.mark.parametrize("limb", [2, 4])
def test_mult_relin_sharded_matches_jax(jax_side, chain, limb):
    mesh = _cpu_mesh(limb)
    a = [_sharded(x, mesh) for x in chain["a"]]
    out = sf.mult_relin_sharded(*a, jax_side["tabs"](8), mesh)
    for got, want in zip(out, chain["prod"]):
        _eq(par.unshard(got, mesh, ROWS), want)


def test_two_level_chain_with_in_region_rescale(jax_side, chain):
    """kql 8 -> in-region rescale (row 7 zeroed) -> kql 7 padded to 8:
    the real rows equal JAX's unsharded chain, the pad row is zero."""
    mesh = _cpu_mesh(LIMB)
    a = [_sharded(x, mesh) for x in chain["a"]]
    prod = sf.mult_relin_sharded(*a, jax_side["tabs"](8), mesh)
    dt = shd.make_sharded_drop_tables(
        types.SimpleNamespace(basis_q=jax_side["bq"]), 8)
    resc = [shd.drop_last_and_scale_sharded(x, dt, 7, mesh) for x in prod]
    out = sf.mult_relin_sharded(*resc, *resc, jax_side["tabs"](7, 8), mesh)
    for got, want in ((resc, chain["resc"]), (out, chain["prod2"])):
        for g, w in zip(got, want):
            g = par.unshard(g, mesh, ROWS)
            _eq(g[:7], w)
            assert not g[7].any()


def test_dp_by_limb_batch(jax_side, chain):
    """A 2 x 2 (dp, limb) mesh with one ciphertext pair per dp row."""
    mesh = _cpu_mesh(2, dp=2)
    a0, a1, b0, b1 = chain["a"]
    pairs = [np.stack([x, y]) for x, y in ((a0, a0), (a1, a1), (b0, a0),
                                           (b1, a1))]
    spec = ("dp", "limb", None)
    out = sf.mult_relin_sharded(*(_sharded(x, mesh, spec) for x in pairs),
                                jax_side["tabs"](8), mesh)
    for o, want0, want1 in zip(out, chain["prod"], chain["sq"]):
        got = par.unshard(o, mesh, spec)
        _eq(got[0], want0)
        _eq(got[1], want1)


# ---------------------------------------------------------------------------
# the portable body (parallel/sharded.py)
# ---------------------------------------------------------------------------

# tests/test_parallel.py holds JAX's shard_map of mult_relin_local and the
# rescale after it bit-exact to the unsharded chain; the port's portable
# body is held to that same chain, on a mesh of 2.

def test_portable_mult_relin_matches_jax(jax_side, chain):
    mesh = _cpu_mesh(2)
    a = [_sharded(x, mesh) for x in chain["a"]]
    out = shd.mult_relin_sharded(*a, jax_side["tabs"](8), mesh)
    for got, want in zip(out, chain["prod"]):
        _eq(par.unshard(got, mesh, ROWS), want)


def test_portable_rescale_matches_jax(jax_side, chain):
    """The in-region rescale keeps kql rows: the real ones equal JAX's
    drop_last_and_scale, the dropped one comes back zero."""
    mesh = _cpu_mesh(2)
    dt = shd.make_sharded_drop_tables(
        types.SimpleNamespace(basis_q=jax_side["bq"]), 8)
    for x, want in zip(chain["prod"], chain["resc"]):
        got = par.unshard(shd.drop_last_and_scale_sharded(
            _sharded(x, mesh), dt, 7, mesh), mesh, ROWS)
        _eq(got[:7], want)
        assert not got[7].any()


# ---------------------------------------------------------------------------
# placement, and the rules every launch follows
# ---------------------------------------------------------------------------

def test_placement_round_trip(jax_side):
    from openfhe_tpu_torch.pke.ciphertext import Ciphertext
    mesh = _cpu_mesh(2, dp=2)
    rng = np.random.default_rng(4)
    x = u32_tensor(_rand(rng, jax_side["cc"].moduli_q, 64))        # [8, 64]
    ct = Ciphertext(elements=(x, x), level=0, noise_deg=1, scale=1.0,
                    slots=32, key_tag="")
    sct = par.shard_ciphertext(ct, mesh)
    assert [p.shape for p in sct.elements[0]] == [(4, 64)] * 4
    assert torch.equal(par.unshard(sct.elements[0], mesh, ROWS), x)
    odd = par.shard_ciphertext(Ciphertext(
        elements=(x[:7],), level=1, noise_deg=1, scale=1.0, slots=32,
        key_tag=""), mesh)                          # 7 towers: replicated
    assert all(torch.equal(p, x[:7]) for p in odd.elements[0])
    batch = par.shard_batch(x, mesh)                # dp cuts, limb copies
    assert [torch.equal(p, x[(i // 2) * 4:(i // 2 + 1) * 4])
            for i, p in enumerate(batch)] == [True] * 4
    assert all(torch.equal(p, x) for p in par.replicate(x, mesh))
    assert [str(d) for d in mesh.flat] == ["cpu"] * 4
    assert mesh.groups("limb") == [[0, 1], [2, 3]]


def test_mesh_needs_a_card_or_a_device_list():
    """No silent CPU mesh: without a device list a mesh takes the visible
    cards, and there are none here."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.ParallelControls().get_mesh()


def test_get_mesh_refuses_another_limb_axis():
    controls = par.ParallelControls()
    mesh = _cpu_mesh(2)
    controls.set_mesh(mesh)
    assert controls.get_mesh() is mesh and controls.get_mesh(2) is mesh
    with pytest.raises(ValueError, match="limb axis 2, not 4"):
        controls.get_mesh(4)


def _calls(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            yield node.func.attr, ast.unparse(node.func.value)


def test_every_launch_goes_through_the_guarded_helper():
    """Only _build.py calls _build.entry: every other module launches
    through _build.launch, which runs under the operands' card."""
    pkg = os.path.join(ROOT, "openfhe_tpu_torch")
    files = [os.path.join(d, f) for d, _, names in os.walk(pkg)
             for f in names if f.endswith(".py")]
    assert any(os.sep + "parallel" + os.sep in f for f in files)
    bad = [os.path.relpath(f, ROOT) for f in files
           if not f.endswith("_build.py")
           and any(attr == "entry" for attr, _ in _calls(f))]
    assert not bad, bad
    launches = {os.path.relpath(f, ROOT) for f in files
                for attr, obj in _calls(f) if attr == "launch"
                and obj == "_build"}
    assert {"openfhe_tpu_torch/ops/modmatmul.py",
            "openfhe_tpu_torch/parallel/sharded_fused.py"} <= launches
