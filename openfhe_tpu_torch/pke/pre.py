"""Proxy re-encryption (PRE).

Counterpart of `openfhe_tpu/pke/pre.py` (reference analog: base-pre.cpp,
rns-pre.cpp). ReKeyGen is a key-switch key from the delegator's secret to
the delegatee's key, by the delegatee's secret (KeySwitchGen) or public
key (`hybrid.keyswitch_gen_pk`); ReEncrypt switches c1 under it with c0
(plus the mode's noise) as the switch's addends, so that on the card the
switch is one pass of the general fused chain with the final adds in its
last kernel; the mode's noise costs its NTTs (three for an encryption of
zero, one for flooding). The modes
(constants-defs.h:63-68): INDCPA, the plain switch; FIXED_NOISE_HRA, plus
an encryption of zero under the delegatee's public key when one is given;
NOISE_FLOODING_HRA, plus Gaussian flooding of sigma 2^20.

ReEncrypt and ReKeyGen by public key need HYBRID key switching: the JAX
package takes the hybrid tables and P whatever the technique, and under
BV, which has no P towers, both fail with an AttributeError (ROADMAP
queue 3), so the port refuses BV with a ValueError. ReKeyGen by secret key
gives the technique's key, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

from openfhe_tpu_torch.math import modops as mo
from openfhe_tpu_torch.math import sampling
from openfhe_tpu_torch.pke.ciphertext import Ciphertext
from openfhe_tpu_torch.pke.constants import ProxyReEncryptionMode
from openfhe_tpu_torch.pke.keys import EvalKey, PrivateKey, PublicKey
from openfhe_tpu_torch.pke.keyswitch import hybrid
from openfhe_tpu_torch.pke.schemes import rns_pke

NOISE_FLOODING_BITS = 20   # the flooding sigma of NOISE_FLOODING_HRA


def _require_hybrid(cc) -> None:
    if not cc._hybrid():
        raise ValueError("ReEncrypt and ReKeyGen by public key need HYBRID "
                         "key switching (P towers)")


def re_key_gen(cc, old_sk: PrivateKey, new_key) -> EvalKey:
    """(reference CryptoContextImpl::ReKeyGen, cryptocontext.h:3043) By
    secret key any technique's KeySwitchGen; by public key HYBRID only."""
    if isinstance(new_key, PrivateKey):
        return cc.KeySwitchGen(old_sk, new_key)
    if not isinstance(new_key, PublicKey):
        raise TypeError("ReKeyGen takes the new PrivateKey or PublicKey")
    _require_hybrid(cc)
    return hybrid.keyswitch_gen_pk(
        cc._gen, old_sk, new_key, cc.basis_qp, len(cc.moduli_q),
        cc.params.num_large_digits, cc.p_modq, cc.p_modq_sh,
        ns_int=cc.noise_scale_int)


def re_key_gen_pk_core(cc, old_sk: PrivateKey, new_pk: PublicKey,
                       draws) -> EvalKey:
    """ReKeyGen by public key on given draws (`keyswitch_gen_pk_core`)."""
    _require_hybrid(cc)
    return hybrid.keyswitch_gen_pk_core(
        draws, old_sk, new_pk, cc.basis_qp, len(cc.moduli_q),
        cc.params.num_large_digits, cc.p_modq, cc.p_modq_sh,
        ns_int=cc.noise_scale_int)


def re_encrypt_draws(cc, public_key: PublicKey | None = None) -> tuple:
    """The mode's draws: FIXED_NOISE_HRA with a public key those of an
    encryption of zero (u, e0, e1), NOISE_FLOODING_HRA one Gaussian [N] of
    sigma 2^20, INDCPA none."""
    mode = cc.params.pre_mode
    if (mode == ProxyReEncryptionMode.FIXED_NOISE_HRA
            and public_key is not None):
        return rns_pke.encrypt_zero_pk_draws(cc._gen, cc.ring_dim,
                                             cc.params.secret_key_dist)
    if mode == ProxyReEncryptionMode.NOISE_FLOODING_HRA:
        return (sampling.discrete_gaussian(
            cc._gen, (cc.ring_dim,), sigma=float(1 << NOISE_FLOODING_BITS)),)
    return ()


def re_encrypt(cc, ct: Ciphertext, re_key: EvalKey,
               public_key: PublicKey | None = None) -> Ciphertext:
    """(reference ReEncrypt) (c0, c1) switched under the re-encryption
    key."""
    return re_encrypt_core(cc, ct, re_key, public_key,
                           re_encrypt_draws(cc, public_key))


def re_encrypt_core(cc, ct: Ciphertext, re_key: EvalKey,
                    public_key: PublicKey | None, draws) -> Ciphertext:
    """ReEncrypt on the mode's draws (`re_encrypt_draws`). The mode's
    noise joins c0 (and c1) before the switch, as its addends: the JAX
    package adds it after, to the same words mod q."""
    _require_hybrid(cc)
    tabs = cc.hybrid_tables(cc.size_ql(ct.level))
    basis = tabs.basis_ql
    ns = cc.noise_scale_int
    add0, add1 = ct.elements[0], None
    mode = cc.params.pre_mode
    if (mode == ProxyReEncryptionMode.FIXED_NOISE_HRA
            and public_key is not None):
        z0, add1 = rns_pke.encrypt_zero_pk_core(draws, public_key, basis, ns)
        add0 = mo.add_mod(add0, z0, basis.q)
    elif mode == ProxyReEncryptionMode.NOISE_FLOODING_HRA:
        # times t after the residue lift: t * flood passes int32
        add0 = mo.add_mod(add0, rns_pke.small_eval(draws[0], basis, ns),
                          basis.q)
    c0, c1 = hybrid.keyswitch_core(ct.elements[1], re_key, tabs, add0, add1)
    return dataclasses.replace(ct, elements=(c0, c1),
                               key_tag=re_key.key_tag)
