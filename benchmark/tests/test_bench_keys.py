"""The adapters' one reach under the port's public API, held to it.

The CKKS adapter makes its switching keys from the benchmark's draws by
the core of the port's KeySwitchGen, and the BinFHE adapter puts its own
keys where BTKeyGen puts the port's. If the port's key generation comes to
store its keys otherwise, or to keep other state beside them, these tests
fail, and the adapters' `install_keys` is what to bring up to date."""

import dataclasses

import torch

import small
from harness.systems import binfhe as sysbin
from harness.systems import ckks as sysckks
from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD
from openfhe_tpu_torch.binfhe.context import BinFHEContext
from openfhe_tpu_torch.pke.keyswitch import hybrid
from reference import ckks as ref
from reference.ntt import Exact

CPU = torch.device("cpu")


def _state(obj) -> dict:
    """Each attribute's identity, and a container's size: what a call
    that sets or fills an attribute changes."""
    return {k: (id(v), len(v) if isinstance(v, (dict, list)) else None)
            for k, v in vars(obj).items()}


def _changed(before: dict, obj) -> set:
    after = _state(obj)
    return {k for k in after if before.get(k) != after[k]}


def _same_words(a, b):
    assert type(a) is type(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def test_ckks_keys_are_the_ports_keygen_on_the_same_draws(monkeypatch):
    import openfhe_tpu_torch as fhe

    config = small.ckks()
    params = sysckks._params(fhe, config["params"])
    n = config["params"]["ring_dim"]
    g = pow(5, 1, 2 * n)
    public = fhe.GenCryptoContext(params, seed=3, device=CPU)
    sk = public.KeyGen().secret_key
    seen = []
    core = hybrid.keyswitch_gen_core

    def spy(draws, s_old, s_new, *args, **kw):
        seen.append((s_old.s_qp, [d.clone() for d in draws]))
        return core(draws, s_old, s_new, *args, **kw)

    monkeypatch.setattr(hybrid, "keyswitch_gen_core", spy)
    before = _state(public)
    public.EvalMultKeyGen(sk)
    public.EvalAutomorphismKeyGen(sk, [g])
    by_keygen = _changed(before, public)
    monkeypatch.undo()
    assert len(seen) == 2

    ours = fhe.GenCryptoContext(params, seed=4, device=CPU)
    before = _state(ours)
    sysckks.install_keys(ours, sk.s_qp, {1: seen[0], g: seen[1]},
                         tag=sk.key_tag)
    # `_auto_idx_cache`: the gather table of an automorphism, which
    # `_auto_idx` fills at its first use by any call (a rotation too)
    assert _changed(before, ours) == by_keygen - {"_auto_idx_cache"}
    _same_words(ours.eval_mult_keys[sk.key_tag],
                public.eval_mult_keys[sk.key_tag])
    _same_words(ours.eval_automorphism_keys[sk.key_tag][g],
                public.eval_automorphism_keys[sk.key_tag][g])
    # the old secrets the adapter works out are the ones the port keys
    chain = ref.Chain(config["moduli_q"], config["moduli_p"], n, 3, CPU)
    s = sk.s_qp.long()
    assert torch.equal(seen[0][0].long(), Exact.mul(s, s, chain.towers.q))
    assert torch.equal(seen[1][0].long(), chain.automorph(s, g))


def test_binfhe_keys_sit_where_btkeygen_puts_its_own():
    config = small.toy()
    system = sysbin.System(config, small.AND, 5, CPU)
    public = BinFHEContext(seed=1, device=CPU)
    public.GenerateBinFHEContext("TOY", BINFHE_METHOD.GINX)
    sk = public.KeyGen()
    before = _state(public)
    public.BTKeyGen(sk)
    by_keygen = _changed(before, public)

    ours = BinFHEContext(seed=2, device=CPU)
    ours.GenerateBinFHEContext("TOY", BINFHE_METHOD.GINX)
    before = _state(ours)
    sysbin.install_keys(ours, system.z, system.bt_key, system.ks_a,
                        system.ks_b)
    assert _changed(before, ours) == by_keygen == {"sk_n", "bt_key",
                                                   "ks_key"}
    for mine, theirs in ((ours.bt_key, public.bt_key),
                         (ours.sk_n.s, public.sk_n.s),
                         (ours.ks_key.a, public.ks_key.a),
                         (ours.ks_key.b, public.ks_key.b)):
        assert (mine.shape, mine.dtype) == (theirs.shape, theirs.dtype)
    assert (ours.ks_key.mod_ks, ours.ks_key.base_ks) == (
        public.ks_key.mod_ks, public.ks_key.base_ks)
    assert sysbin.program_params(public) == (
        config["n"], config["ring_dim"], config["q"], config["Q"],
        config["q_ks"], config["base_ks"], config["base_g"])
