"""Drive the PyTorch port's main paths on one GPU and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
It exits non-zero, printing no result, when there is no card or the port
is not beside it. Phases, none of which catches its own failure:

1. the card's name and power limit (nvidia-smi), then its maximum SM
   clock and SM count and the 32-bit integer rate they give (below);
2. build every kernel of `openfhe_tpu_torch/csrc` (nvcc, in parallel),
   printing each kernel's registers and spills from ptxas;
3. kernel phase: each kernel is compared word for word with its plain
   PyTorch version on the same card inputs, and both are timed with CUDA
   events (median of 20 after warm-up). The NTT and the conversion run at
   the main path's shapes. The NTT's two transforms of `csrc/ntt.cu`, the
   cluster one (`ntt_fwd` / `ntt_inv`, one launch a transform for
   2^4 <= N <= 2^17) and the staged one (`ntt_fwd_staged` /
   `ntt_inv_staged`), are each held against the plain version and so
   against each other, at [31, 2^16], [47, 2^16], 4 of the largest 31-bit
   primes, Rescale's [2, 30, 2^16] and [1, 2^16], a batch of 2 x 3 towers
   at N=2^13 and 4 31-bit towers at N=2^12, 2^14, 2^15 and 2^17 (clusters
   of 1, 1, 2, 4, 8, 8 blocks from 2^12 up); each call of `ntt_fwd` /
   `ntt_inv` must launch the cluster entry once and the staged one never.
   Their `ms` is device time with the host's launch cost taken out
   (`device_ms`), `call_ms` one call; the conversion (kernel k,
   `mod_matmul_rowmod`: `pconv` of csrc/pconv_core.cuh) at the hoisted
   rotation's digit -> complement and P -> Q shapes and at a batch of 2,
   on words below 2^31 not reduced mod the input moduli, against its plain
   version and its former form `mod_matmul_rowmod_eager`, one launch of
   the entry a call and none of the former; the seven kernels of the fused
   key switches at
   level 0 (31 Q towers), level 1 (30) and on a chain of the largest
   31-bit primes (4 Q + 2 P towers, N=2^16) in 2 digits and in 1,
   `intt_scale` also in its K4 form (ext's P rows, 2 elements) and
   `ntt_subscale` also with BGV's t = 65537 in the tables and with one and
   two addends (the final add it takes from Relinearize, KeySwitch and the
   automorphisms). K1t, K1/K4, K3, K45, K6 and K6f (`tensor_intt`,
   `intt_scale` in both forms, `ntt_keymul_acc`, `intt_conv_p`,
   `ntt_subscale`, `ntt_submul_final`, on the cluster NTT) and K2
   (`conv_digits`, y's digits read in place) are also held against their
   former forms (`tensor_intt_staged`, `intt_scale_staged`,
   `ntt_keymul_acc_staged`, `intt_conv_p_staged`, `ntt_subscale_staged`,
   `ntt_submul_final_staged` on the staged NTT passes;
   `conv_digits_rowmod` over the zero-padded digits, the pad
   included), also at levels 3, 11, 15, 23 and 30 (44 down to 17 Q_l*P
   towers, two digits and one), on the 31-bit chain at N=2^12, 2^14, 2^15
   and 2^17 in two digits and in one (clusters of 1, 2, 4, 8) and in one
   digit over 20 and 40 P towers (each of `pconv`'s column widths); each
   call must launch its entry once and the former form never, and both
   are timed as the NTT is (`ms` device time, `call_ms` a call);
4. main path at N=2^16, L=30 (31 Q + 16 P towers, 2 digits), with the
   launch counters reset just before and read just after: context,
   KeyGen, EvalMultKeyGen, rotation keys (1, -1, the EvalSum ladder of
   batch 64, conjugation), encode, Encrypt x3; then at level 0 and at
   level 1 EvalMult (one launch of each kernel of the mult chain; at level
   0 the profiler must see MULT_KERNELS device kernels, all of csrc/),
   Relinearize(EvalMultNoRelin) and EvalRotate (one launch of each kernel
   of the general chain, nothing else; at level 0 one Relinearize must run
   RELIN_KERNELS device kernels, all of csrc/: no plain-torch final add)
   and the same ops through the
   unfused chain (`dataclasses.replace(tables, fused=None)`: the NTT and
   conversion kernels); hoisted rotations (EvalFastRotationPrecompute +
   EvalFastRotation, unfused by design: each two launches of `ntt_fwd`,
   `ntt_inv` and `mod_matmul_rowmod`, none of a former form);
   EvalConjugate; EvalInnerProduct
   (EvalMult + the EvalSum ladder); Rescale; Decrypt. The fused words must
   equal the unfused ones at both levels and the port's plain path run on
   the CPU; the decryptions must be within the limits below; every kernel
   must have been launched;
5. BinFHE (the JAX repo's binfhe benchmark, `bench.py`'s binfhe rows):
   kernel m (`ntt_small_fwd` / `ntt_small_inv`) against its dense plain
   version word for word at a gate batch's shapes, at N=2048 with 2
   towers, N=128 with 4, one ring element at N=1024 and the STD128 RGSW
   key's rows at keygen (its largest launch), each beside `ntt.cu`'s
   transform of the same input (equal words, timed), each printed with
   the card's name and power limit; these small calls cost the
   host more than the card, so their `ms` is device time with the host's
   launch cost taken out (`device_ms`) and `call_ms` the time of one call
   as the other kernels are timed; the blind-rotation kernel
   (`blind_rotate_cggi` / `_dm` / `_lmkcdey`) against the per-step loop
   on the card (`rgsw._eval_acc_*_steps`: kernel m twice a step and plain
   torch around it) word for word, on random words as keys and
   accumulators, at GINX STD128 batch 256 and 1, STD128_LMKCDEY batch 1
   and 64 and STD128_AP batch 64, one launch per blind rotation, plus a
   run split at step SPLIT_STEP that must equal the whole; then, with
   the counters reset just before and read just after, GINX at STD128 over
   a batch of 256 gates with a = i % 2, b = (i // 2) % 2: context, KeyGen,
   BTKeyGen, Encrypt, EvalBinGate AND/OR/NAND/XOR/XNOR, EvalNOT, Bootstrap
   and MAJORITY, every decryption against the truth table; one AND
   launches `ntt_small_fwd` once (the test vector), `blind_rotate_cggi`
   once and `ntt_small_inv` once (the extraction) and nothing else; 4 of
   its gates equal the port's plain path on the CPU with the same keys;
   EvalFunc (x^2 mod 4, periodic) and EvalSign at batch 4; then
   STD128_LMKCDEY at batch 1 and 64 and STD128_AP at batch 64 (AND, truth
   table, the same three launches with their own blind rotation);
6. the limb-sharded path (`openfhe_tpu_torch/parallel/`), on the phase-4
   context and eval key, on meshes built from the visible cards (a card
   repeats when there are fewer cards than shards; the placement is
   printed): kernel l (`mod_matmul`: the int8 tensor cores on byte
   limbs, `mma.sync` m16n8k32 u8) against its plain version and its former
   form (`mod_matmul_simt`, the CUDA cores) at the sharded NTT's stage
   shapes (the Q basis at limb 2 and 4, the 31-bit primes) and at its
   edge (A = 2^15, D = 16, B = 8, every word 2^31 - 2 at q = 2^31 - 1,
   where its int32 limb-pair sums reach 255 * 255 * 2^15); kernels n, o
   and p against theirs on every shard of level 1 at limb 2, level 3 at
   limb 4, the 31-bit chain at limb 2 and its level of 1 Q tower padded to
   2 (whose second digit covers no row of y); n (`conv_digits_rows`: K2's
   `pconv` reading the gathered y in place), o (`conv_p_to_q_rows`: K45's
   `pconv` on the shard's weight columns, both elements over one table)
   and p (`ntt_keymul_acc_rows`: K3's `keymul_cluster` from the shard's
   first global row) also against their former forms
   (`conv_digits_rows_rowmod` over the zero-padded digits,
   `conv_p_to_q_rows_rowmod` the eager conversion,
   `ntt_keymul_acc_rows_staged` on the staged NTT passes); each kernel of
   the phase one launch of its entry a call and none of the former, timed
   as the fused kernels are (`ms` device time, `call_ms` a call); then,
   with the counters reset just before and read just after,
   the sharded NTT at limb 2 and 4 (word-equal to `ntt.cu`, 2L launches
   of `mod_matmul`, none of `mod_matmul_simt`), the sharded EvalMult at
   level 1 / limb 2 and level 3 / limb 4 (word-equal to the single-card
   fused EvalMult, each of its six kernels once per shard, the former
   forms never, nothing else), the
   portable body at level 1 / limb 2,
   the two-level chain (level 3, in-region rescale, level 4 padded to 28
   rows: real rows equal to Rescale and EvalMult, the pad row zero), a dp 2
   x limb 2 mesh with a batch of two pairs and, where two cards are
   visible, shards on distinct cards; the decryption of the rescaled level-3
   product within MULT_TOL; times beside the single-card ops;
7. the leveled CKKS layer, counted only over its fused runs: (a), (b)
   and each chain of (c) from its context's creation to its last fused
   op, the counts summed; every oracle (the unfused chain, the CPU plain
   path, the kernel cases) runs outside those windows:
   (a) FLEXIBLEAUTO at the main path's widths (N=2^16, depth 30, 26/27-bit
   moduli, 2 digits, HEStd_128_classic; 31 Q + 16 P towers), KeyGen,
   EvalMultKeyGen, rotation keys -1 ... -7, MERGE fresh encryptions filling
   all 32768 slots: (a)1 EvalSub, EvalNegate, EvalAdd / EvalSub / EvalMult
   with a scalar and with a plaintext, EvalSquare, EvalMultAndRelinearize,
   EvalLinearWSum of 4, EvalMerge of 8, an add of a [level 1, degree 2]
   and a [level 0, degree 1] operand (FLEXIBLE's scalar-multiply bring)
   and Compress, each word-equal (with level, degree and scale) three
   ways: the fused chains on the card, the unfused chain on the card
   (`unfused_view`: every level's tables without the fused ones) and the
   port's plain path on the CPU (`cpu_twin`); (a)2
   `examples/function_evaluation.py`'s two calls, EvalLogistic and EvalSin
   over [-1, 1] at degree 32 from level 0, and (a)3 EvalLogistic over
   [-8, 8] at degree 119 from level 0 and from the deepest level where its
   result keeps LEVEL_SPARE_BITS above its scale (printed), each fused
   word-equal to unfused, each printed with its wall (CUDA events), its
   launches by kernel and its host share (the encodes of constant vectors,
   `MakeCKKSPackedPlaintext`: an FFT and a CRT on the host, an upload and
   one `ntt_fwd`); every kernel of rows a-h and j must have been launched
   and no former form; (b) FIXEDAUTO at the same widths, depth 6: the add
   of a [level 1, degree 2] and a [level 0, degree 1] operand (the x1
   plaintext multiply), word-equal to the CPU plain path; (c) the chains
   the kernels had not run on, FLEXIBLEAUTOEXT at depth 10 (a 20-bit
   extension tower on top: the JAX package has no 19-bit prime = 1 mod 2N
   from N=2^13 on, `pke/parameters._ext_prime`) and COMPOSITESCALINGAUTO
   at depth 8 with 50-bit scales over two 25-28-bit towers a level: an
   EvalMult-and-Rescale chain to the last level and a scalar add, fused
   word-equal to unfused, and each kernel of the fused key switches
   against its plain version and former form on the chain's level-0
   tables (`fused_cases`). Every decryption within the limits of the note
   below;
8. the integer schemes and the extended basis, each of (a)-(d) counted
   from its context's creation (or its first op) to its last op, every
   oracle outside those windows: (a) BGV at the JAX repo's BGV benchmark
   (`bench.py` `bench_bfvbgv`: N=2^15, depth 10, FLEXIBLEAUTO, t = 65537;
   21 Q + 7 P towers, 3 digits): KeyGen, EvalMultKeyGen, rotation keys
   +-1, MakePackedPlaintext, Encrypt, EvalMult (one launch of each kernel
   of the mult chain, with t in the fused tables: K45's t^-1 and K6f's t;
   MULT_KERNELS device kernels, all of csrc/), EvalMult by a plaintext,
   EvalAdd, three EvalMults down the chain (each ModReduce two towers),
   ModReduce, EvalRotate +1 and -1; every decryption equal to numpy mod
   t; the chain and the rotation fused == unfused
   (`dataclasses.replace(tabs, fused=None)`, the mod-down tables with t);
   K6 and K6f with t against their twins and staged forms at level 0 and
   level 4; (b) BFV at `bench_bfvbgv`'s N=2^14, depth 2, t = 65537 (6 Q +
   2 P towers): EvalMult (the tensor product on kernels a, b and k, then
   Relinearize on the general fused chain) and a second EvalMult under
   HPS, HPSPOVERQLEVELED at depth 3 (its third product drops a tower) and
   EncryptionTechnique EXTENDED, decryptions exact, Relinearize and the
   second product fused == unfused; (c) BV key switching (digit_size 0,
   one conversion a tower) on (a)'s chain: EvalMult and EvalRotate, exact;
   (d) on phase 4's context, EvalFastRotationExt of the level-0 product
   (scale 2^52) over rotations 1, 2, 3, summed by EvalAddExt, one
   KeySwitchDown, then Rescale, held to EXT_SUM_TOL against the sum of
   Rescale(EvalRotate) and the rotated decryption of Rescale(prod), and at
   level 20 word for word against the port's plain path on the CPU;
9. CKKS bootstrapping (`pke/fhe/ckks_bootstrap.py`, `fbt.py`,
   `schemelet.py`), which launches only kernels the phases above hold
   (the NTTs, the conversion in the composite ModRaise and the hoisted
   rotations, the fused key switches of EvalMult / EvalSquare /
   EvalRotate / EvalConjugate): (a) `bench.py`'s bench_boot16 at full
   width (N=2^16, depth 24, COMPOSITESCALINGAUTO at 50-bit scales over two
   towers a level, 51-bit first level, 26-bit P towers, 3 digits,
   HEStd_NotSet, seed 7; 2^11 slots, level budget (3, 3); z uniform in
   [-0.5, 0.5) from default_rng(0), the ciphertext two levels from the
   end): context, KeyGen, EvalMultKeyGen, EvalBootstrapKeyGen, then a
   cold and a warm EvalBootstrap, each counted from a cleared counter
   (its walls with CUDA events, the encodes of its plaintexts and their
   share of the wall, its hoisted and plain rotations); the warm one's
   launches are the kernels line's `launches_per_bootstrap`, its device
   busy time, idle gaps and top device ops come from torch.profiler; the
   decryption must keep BOOT16_BITS of precision, the output more than
   two towers, and the words must equal those of the same context through
   the unfused chain (`unfused_view`); the peak device memory is printed;
   (b) bench_boot (N=2^12, depth 20, 256 slots, budget (2, 2)): the card's
   EvalBootstrap word-equal to the port's plain path on the CPU from the
   same keys and ciphertext (`cpu_twin`), BOOT_BITS; (c) on (b)'s
   context EvalBootstrapStCFirst (STC_BITS) and the two-round
   EvalBootstrap (more than TWO_ROUND_GAIN bits over one round), then
   EvalFBT of a p = 8 LUT at `examples/functional_bootstrapping_ckks.py`'s
   configuration on N=2^12 (FBT_CONFIG): the LUT back exactly after
   rounding. Every kernel of the path must have been launched in (a)'s
   runs and no former form;
10. BinFHE's composite-Q ring and CKKS <-> FHEW scheme switching
   (`binfhe/rgsw_wide.py`, `pke/schemeswitch.py`), which launch only
   kernels the phases above hold: (a) GINX at STD192 (Q = q1 q2 of 38
   bits, n = 821, N = 2048, d2 = 4) over `bench.py`'s binfhe batch of 256
   gates with a = i % 2, b = (i // 2) % 2, counted from the context on:
   context, KeyGen, BTKeyGen, Encrypt, EvalBinGate AND/OR/NAND/XOR/XNOR,
   EvalNOT, Bootstrap and MAJORITY, every decryption against the truth
   table; one AND launches one `blind_rotate_cggi_wide` (the n steps of
   every gate, `csrc/blind_rotate.cu`) and kernel m once each way (the
   test vector's forward NTT, the extraction's inverse NTT), with plain
   torch around them; 4 of its gates equal the port's plain path on the
   CPU with the same keys; the batch's wall (CUDA events), gates/s, the
   device busy share under torch.profiler and the peak memory; the
   kernel, with the context's key and random accumulators at batch 256
   and 1, word-equal to the per-step loop on the card
   (`rgsw_wide._eval_acc_cggi_wide_steps`, two kernel-m launches a step,
   one call each) and to the direct wrapper call, and at 256 steps [0,
   SPLIT_STEP) then the rest equal to the whole, its device time beside
   its bound and the loop's; EvalFunc x^2 mod 4 at batch 4; STD192Q (34
   bits) one AND; STD192_LMKCDEY raises ValueError; (b) `examples/scheme_switching.py` at 128-bit security:
   N=2^16 under HEStd_128_classic, FLEXIBLEAUTO, 28/30-bit moduli, depth
   16, 16 slots, the STD128 FHEW side (n = 1305) at q_LWE = 2^17: setup
   and keys (the inner BinFHE context on the card), EvalCKKStoFHEW of the
   integers 0 ... 15 (every LWE sample decrypts to its value) and one
   EvalCompareSchemeSwitching of 16 pairs, each with its wall, its host
   encodes and their share, its launches by kernel and the plaintext
   cache's entries before and after; the compare's FHEW half (EvalSign of
   EvalCKKStoFHEW(ct1 - ct2), the same words) must give every sign right
   and its result must decrypt to finite values; its error against the
   signs and the first stages of its FHEW -> CKKS half (the partial
   decryption A s, B - A s, the Chebyshev seed, the double-angle steps,
   each against its exact value) are printed: at N=2^16 the 28-bit
   scales of the JAX package's design leave the partial decryption an
   error that the STD128 side's K = 128 amplifies past the signs (PERF.md
   §6, ROADMAP queue 3), which (c) holds at N=2^12;
   the compare may add only its S2C diagonals to the cache (none of
   EvalFHEWtoCKKS's 2048) and keep less than SSW_MEM_LIMIT_GB of device
   memory, and must launch every kernel of the path (the NTTs, the
   conversion, the fused key switches, kernel m and `blind_rotate_cggi`)
   and no former form; (c) at N=2^12, depth 20, the TOY FHEW side:
   EvalCompareSchemeSwitching and EvalMin / EvalMaxSchemeSwitching over 4
   values on the card word-equal to the port's plain path on the CPU from
   the same keys and ciphertexts (the tournament's encryption of ones is
   one, on both sides), the min, max and argmin indicator within their
   limits, the compare's FHEW -> CKKS stage errors printed as in (b),
   `blind_rotate_cggi` launched;
11. the protocols (`pke/multiparty.py`, `pke/pre.py`,
   `utils/serialization.py`), which launch only kernels the phases above
   hold (rows a, b and k, the mult chain and the general chain), each part
   counted from its context's creation (or its first op) to its last op
   with its wall (CUDA events), launches by kernel, host share (the CRT
   lifts and lowers, the encodes and decodes, ShareKeys' Horner,
   (de)serialization: HOST_STEPS) and peak memory, every oracle outside those windows: (a)
   threshold CKKS at phase 7(a)'s widths (N=2^16, depth 30, 26/27-bit, 2
   digits, HEStd_128_classic, FLEXIBLEAUTO; 31 Q + 16 P towers) with
   MULTIPARTY: three parties' MultipartyKeyGen, the joint relinearization
   key (KeySwitchGen, two MultiKeySwitchGen and MultiAddEvalKeys, three
   MultiMultEvalKey, MultiAddEvalMultKeys) and joint rotation keys for
   +-1 (MultiEvalAutomorphismKeyGen, MultiAddAutomorphismKeys), all with
   their Shoup companions; encryptions of |z| <= Z_MAX under the joint
   key, EvalMult (one launch of each kernel of the mult chain; MULT_KERNELS
   device kernels under the profiler, all of csrc/), Rescale, EvalRotate
   +-1 (one launch of each kernel of the general chain), EvalMult at level
   1; Lead, Main, Main and Fusion within MP_TOL / MP_MULT_TOL (twice phase
   4's TOL / MULT_TOL: the joint secret of three shares has three times a
   key's variance); fused == unfused (`unfused_view`) at levels 0 and 1 and
   the level-1 EvalMult word-equal to the port's plain path on the CPU
   (`cpu_twin`) from the same keys; ShareKeys(5, 3) and RecoverSharedKey
   over parties 1, 3, 5 giving back party 1's key word for word; (b) on
   (a)'s context, inputs brought down to IB_TOWERS towers: 2-party IntBoot
   (AdjustScale, Decrypt twice, Encrypt, Add) under the first two
   parties' key and 3-party IntMPBoot (AdjustScale, RandomElementGen,
   three Decrypts, Add, Encrypt) under the joint key, each step's wall and
   host share printed, both outputs on the full chain within IB_NOISE
   times a fresh threshold decryption's error under the same key (and
   IB_TOL), then EvalMult of the IntMPBoot output under the joint
   relinearization key (the mult chain once) within the same limit after
   Rescale; (e) serialization
   on the card of (a)'s ciphertext, joint public key, party 2's secret
   share, joint relinearization key and rotation map, binary and JSON:
   each round trip gives the words back (keys with their companions) and
   the same bytes again, the reloaded relinearization key's EvalMult the
   original's words on MULT_KERNELS device kernels of csrc/, the blobs'
   bytes and times printed, the context record deduplicated on the card;
   (f) EvalHermiteTrigSeries of x^2 mod 4 (p = HERMITE_P, order 1) on an
   encryption of exp(2 pi i x / 4), against the series in numpy within
   HERMITE_NOISE times the series' gain at (b)'s fresh error (and
   HERMITE_TOL); (c) PRE at `bench_bfvbgv`'s BGV (N=2^15, depth 10, t = 65537;
   21 Q + 7 P towers, 3 digits) under INDCPA, FIXED_NOISE_HRA and
   NOISE_FLOODING_HRA: Alice -> Bob by secret key, Bob -> Carol by public
   key, at level 0 and after an EvalMult; each ReEncrypt one launch of
   each kernel of the general chain with t in K6's tables and c0 (plus
   the mode's noise) as its addends, and besides only the noise's
   `ntt_fwd` (three for FIXED_NOISE_HRA's encryption of zero under
   Carol's key, one for flooding); Carol's decryptions equal numpy mod t;
   fused == unfused on the same draws; (d) NOISE_FLOODING_MULTIPARTY for
   BFV at `bench_bfvbgv`'s N=2^14, depth 2, and BGV at (c)'s widths: the
   towers with flooding and without printed, 2-party keys and joint
   relinearization key, EvalMult, an exact threshold decryption whose
   extra-limb mask is switched exactly Q' -> Q on the card;
12. the lattice toolbox (`lattice/trapdoor.py`, `dgsampling.py`,
   `field2n.py`, `ringq.py`, `math/dgg.py`, `cyclotomic.py`), the native
   host library (`native.py`) and `examples_torch/`, each part counted
   from a cleared counter with its host wall: (a) TrapdoorGen and
   GaussSamp at n = 1024, q = first_prime(28, 2n), base 2 (k = 28), on
   kernel m and nothing else of a, b, m; (b) the same at n = 16384
   (dgsampling's N_MAX), base 32 (k = 6), on kernels a/b; each with A [e;
   r; I] == G, A x == u word for word (GaussSamp twice) and |x| below
   LAT_NORM_FACTOR spectral bounds; (c) the CPU's plain path on (a)'s
   recorded variates giving its A, T and x word for word, and Field2n at
   n = 16384 (round trip, Times, Inverse) within FIELD_TOL of the CPU's;
   (d) `sample_integers` over 2^20 random centers at sigma 3.19, 40 (the
   table) and 2^22 (the rounding path), mean and spread within SAMPLE_SE
   standard errors, 2^16 of them replayed on the CPU equal; (e)
   multiply_arb and the round trip at m = 4095 (phi 1728, the convolution
   at 2 x 8192: three launches each of kernels a and b) word-equal to the
   CPU's; (f) the CKKS decode of phase 4's ciphertext (N=2^16, 31 towers)
   through the native library and the exact Python path, both timed,
   within 2 ulps; (g) the five examples at their own sizes, BFV and BGV
   exact, CKKS within EXAMPLE_CKKS_TOL, the samplers' statistics;
13. the other examples of `examples_torch/`, each counted from a cleared
   counter with its host wall: (a) OWN_EXAMPLES, every file of
   `examples_torch/` but phase 12's five, at their own parameters (the JAX
   examples'), every check an example returns holding (integer, LWE and
   PRE results exact, CKKS within the JAX example's tolerance); (b)
   FULL_WIDTH: `boolean`, `boolean_pke` and `boolean_truth_tables` at
   STD128, `boolean_ap` at STD128_AP, `boolean_lmkcdey` at STD128_LMKCDEY,
   each launching its set's blind rotation (row m'), and
   `simple_integers_bgvrns`, `simple_complex_numbers` and `threshold_fhe`
   at HEStd_128_classic with ring_dim=0 (the port's security tables
   choose N), the first launching the fused chain's rows c-g, h and j
   (EvalMult and EvalRotate), the second c-g, the third (EvalAdd only) the
   NTTs of rows a and b; each with its N (or n, N), wall and launches by
   `csrc/` entry printed;
14. one `{"kernels": [...]}` line and, last, the `{"ok": true, ...}`
   line.

bound_ms is the least time the card could take for a call: the larger of
its bytes (each input read once, each output written once) at 3.35 TB/s
and its 32-bit integer operations at the card's 32-bit integer issue
ceiling: 128 thread-instructions a clock an SM (four schedulers, one warp
instruction each a clock) x the card's SM count x the maximum SM clock
nvidia-smi reports (`clocks.max.sm`), printed beside the card's name and
power limit; about 33.5 T/s on an H100 SXM. The CUDA C++ Programming
Guide's throughput table (compute capability 9.0) gives 64 results a
clock an SM for each class of 32-bit integer instruction, but multiplies
(IMAD, IMUL, mul.hi: the FMA-heavy pipe) and adds, logic, shifts,
compares and selects (the ALU pipe) issue side by side, so a mix can
reach 128. The counts here are mixes (a Shoup product is 3 multiplies of
its 5 operations, a butterfly 3 of 10); where more than half of a count
is multiplies, the multiply pipe holds it above this bound, so the bound
is a floor, never above what the card can do. The card's tensor cores do
no 32-bit integer products. Operations count what the function needs: a
conversion counts only its nonzero weights, a key product skips the NTT
of the digit's own rows (and reads only the extended digits' other
rows). Kernel l's modular matmul runs on the int8 tensor cores, whose
products are a third term of its bound: 2 x 16 byte-limb products a term
at INT8_TC_OPS_PER_S (the H100's dense int8 rate), beside its bytes and
its epilogue's MATMUL_EPILOGUE_OPS 32-bit operations an output word; its
former form on the CUDA cores counts MATMUL_TERM_OPS a term (the 62-bit
product, two 32-bit multiplies, and its 64-bit sum, two adds). A
conversion on pconv (k, K2, K45's second launch, the sharded n and o)
counts LAZY_TERM_OPS a term (the lazy Shoup product and its 64-bit sum)
and REDUCE_WIDE_OPS an output word (its one reduction); the eager
conversion's and the key product's terms count ROWMOD_TERM_OPS.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 128   # both integer pipes, 64 a clock each
INT32_OPS_PER_S = None     # int32_rate(), from the card, before any bound
BUTTERFLY_OPS = 10     # Shoup multiply 5, add_mod 2, sub_mod 3
SHOUP_OPS = 5
ROWMOD_TERM_OPS = 7    # Shoup multiply 5 + add_mod 2
LAZY_TERM_OPS = 5      # pconv's term: mul.hi, mul, mad + 64-bit add 2
REDUCE_WIDE_OPS = 11   # a 64-bit sum reduced once: Shoup multiply 5,
                       # Barrett step 4 (mul.hi, mad, csub 2), add_mod 2
MATMUL_TERM_OPS = 4    # 62-bit product 2 + 64-bit sum 2
INT8_TC_OPS_PER_S = 1.979e15   # dense int8 tensor-core rate of an H100
LIMB_PAIRS = 16        # kernel l's byte-limb products a term
MATMUL_EPILOGUE_OPS = 141   # kernel l, an output word: 16 sums into 7
                            # groups (9 64-bit adds, 18), each group's
                            # reduce_wide (77) and lazy Shoup product into
                            # the 64-bit sum (35), the sum's reduce_wide
MULMOD_OPS = 10        # a 64-bit product reduced mod q
CENTRE_OPS = 3         # compare, select, subtract
DIGIT_OPS = 6          # a balanced digit: shift, shift, subtract, shift,
                       # the sign fix (compare and add)
GARNER_OPS = 24        # x1 mod q2 and (x2 - x1) q1^-1 mod q2 (10 each),
                       # the difference's select (2), x1 + q1 t (2)
WORD = 4
SLICE1 = ("ntt_fwd", "ntt_inv", "mod_matmul_rowmod")
# the former forms: the staged NTT (csrc/ntt.cu) and K1t, K1/K4, K3, K45,
# K6 and K6f on the staged NTT passes (csrc/ks_fused.cu), for rings above
# 2^17, K2 on rowmod_core.cuh over the zero-padded digits and kernel k's
# eager conversion (csrc/rowmod.cu): the yardstick the new forms are held
# against here; no launch on the main path
STAGED = ("ntt_fwd_staged", "ntt_inv_staged", "tensor_intt_staged",
          "intt_scale_staged", "ntt_keymul_acc_staged", "intt_conv_p_staged",
          "ntt_subscale_staged", "ntt_submul_final_staged",
          "conv_digits_rowmod", "mod_matmul_rowmod_eager")
# the kernels on the cluster NTT
FUSED_CLUSTER = ("tensor_intt", "intt_scale", "ntt_keymul_acc",
                 "intt_conv_p", "ntt_subscale", "ntt_submul_final",
                 "ntt_keymul_acc_rows")
# the kernels held beside their former forms (`cluster_case`,
# `rowmod_case`, `matmul_case`)
FORMER = {"tensor_intt": "tensor_intt_staged",
          "intt_scale": "intt_scale_staged",
          "ntt_keymul_acc": "ntt_keymul_acc_staged",
          "intt_conv_p": "intt_conv_p_staged",
          "ntt_subscale": "ntt_subscale_staged",
          "ntt_submul_final": "ntt_submul_final_staged",
          "conv_digits": "conv_digits_rowmod",
          "mod_matmul_rowmod": "mod_matmul_rowmod_eager",
          "mod_matmul": "mod_matmul_simt",
          "conv_digits_rows": "conv_digits_rows_rowmod",
          "conv_p_to_q_rows": "conv_p_to_q_rows_rowmod",
          "ntt_keymul_acc_rows": "ntt_keymul_acc_rows_staged"}
SMALL = ("ntt_small_fwd", "ntt_small_inv")
BLIND = ("blind_rotate_cggi", "blind_rotate_dm", "blind_rotate_lmkcdey")
# the composite-Q ring's blind rotation (phase 10 (a))
BLIND_WIDE = ("blind_rotate_cggi_wide",)
FUSED = ("tensor_intt", "intt_scale", "conv_digits", "ntt_keymul_acc",
         "intt_conv_p", "ntt_subscale", "ntt_submul_final")
# the kernels of one EvalMult, and of one Relinearize or automorphism
MULT_CHAIN = ("tensor_intt", "conv_digits", "ntt_keymul_acc", "intt_conv_p",
              "ntt_submul_final")
# device kernels of one EvalMult at N=2^16: K1t, K2, K3, K45's INTT and
# conversion, K6f; nothing else (no digit pad)
MULT_KERNELS = 6
# device kernels of one Relinearize at N=2^16: K1 (one cluster INTT), K2,
# K3, K45's INTT and conversion, K6 with the final add; nothing else
RELIN_KERNELS = 6
KS_CHAIN = ("intt_scale", "conv_digits", "ntt_keymul_acc", "intt_conv_p",
            "ntt_subscale")
# the former forms of l (csrc/modmatmul.cu: the CUDA cores) and of the
# sharded n, o and p (csrc/sharded.cu: n and o on rowmod_core.cuh, n over
# the zero-padded digits, p on the staged NTT passes): their yardsticks
# (`matmul_case`, `shard_cases`); no launch on the path
SHARDED_STAGED = ("mod_matmul_simt", "conv_digits_rows_rowmod",
                  "conv_p_to_q_rows_rowmod", "ntt_keymul_acc_rows_staged")
SHARDED = ("mod_matmul", "conv_digits_rows", "conv_p_to_q_rows",
           "ntt_keymul_acc_rows") + SHARDED_STAGED
# the kernels of one sharded EvalMult, each once per shard
SHARDED_CHAIN = ("tensor_intt", "conv_digits_rows", "ntt_keymul_acc_rows",
                 "intt_scale", "conv_p_to_q_rows", "ntt_submul_final")
# P tower counts of the one-digit K45 cases: pconv's 2- and 1-column forms
WIDE_P = (20, 40)
LIMBS = (2, 4)
ROWS = ("limb", None)
WHERE = {
    "ntt_fwd": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "ntt_inv": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "ntt_fwd_staged": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "ntt_inv_staged": ("csrc/ntt.cu", "openfhe_tpu/ops/ntt_fused.py:205"),
    "mod_matmul_rowmod": ("csrc/rowmod.cu",
                          "openfhe_tpu/ops/modmatmul.py:232"),
    "mod_matmul_rowmod_eager": ("csrc/rowmod.cu",
                                "openfhe_tpu/ops/modmatmul.py:232"),
    "tensor_intt": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:366"),
    "tensor_intt_staged": ("csrc/ks_fused.cu",
                           "openfhe_tpu/pke/keyswitch/ks_fused.py:366"),
    "intt_scale": ("csrc/ks_fused.cu",
                   "openfhe_tpu/pke/keyswitch/ks_fused.py:422, "
                   "openfhe_tpu/pke/keyswitch/ks_fused.py:476"),
    "intt_scale_staged": ("csrc/ks_fused.cu",
                          "openfhe_tpu/pke/keyswitch/ks_fused.py:422, "
                          "openfhe_tpu/pke/keyswitch/ks_fused.py:476"),
    "conv_digits": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:513"),
    "ntt_keymul_acc": ("csrc/ks_fused.cu",
                       "openfhe_tpu/pke/keyswitch/ks_fused.py:690"),
    "intt_conv_p": ("csrc/ks_fused.cu",
                    "openfhe_tpu/pke/keyswitch/ks_fused.py:618"),
    "ntt_keymul_acc_staged": ("csrc/ks_fused.cu",
                              "openfhe_tpu/pke/keyswitch/ks_fused.py:690"),
    "intt_conv_p_staged": ("csrc/ks_fused.cu",
                           "openfhe_tpu/pke/keyswitch/ks_fused.py:618"),
    "ntt_submul_final_staged": ("csrc/ks_fused.cu",
                                "openfhe_tpu/pke/keyswitch/ks_fused.py:802"),
    "conv_digits_rowmod": ("csrc/ks_fused.cu",
                           "openfhe_tpu/pke/keyswitch/ks_fused.py:513"),
    "ntt_subscale": ("csrc/ks_fused.cu",
                     "openfhe_tpu/pke/keyswitch/ks_fused.py:747"),
    "ntt_subscale_staged": ("csrc/ks_fused.cu",
                            "openfhe_tpu/pke/keyswitch/ks_fused.py:747"),
    "ntt_submul_final": ("csrc/ks_fused.cu",
                         "openfhe_tpu/pke/keyswitch/ks_fused.py:802"),
    "ntt_small_fwd": ("csrc/ntt_small.cu", "openfhe_tpu/ops/ntt_small.py:157"),
    "ntt_small_inv": ("csrc/ntt_small.cu", "openfhe_tpu/ops/ntt_small.py:157"),
    "blind_rotate_cggi": ("csrc/blind_rotate.cu",
                          "openfhe_tpu/ops/ntt_small.py:157, "
                          "openfhe_tpu/binfhe/rgsw.py:198"),
    "blind_rotate_dm": ("csrc/blind_rotate.cu",
                        "openfhe_tpu/ops/ntt_small.py:157, "
                        "openfhe_tpu/binfhe/rgsw.py:357"),
    "blind_rotate_lmkcdey": ("csrc/blind_rotate.cu",
                             "openfhe_tpu/ops/ntt_small.py:157, "
                             "openfhe_tpu/binfhe/rgsw.py:571"),
    "blind_rotate_cggi_wide": ("csrc/blind_rotate.cu",
                               "openfhe_tpu/ops/ntt_small.py:157, "
                               "openfhe_tpu/binfhe/rgsw_wide.py:273"),
    "mod_matmul": ("csrc/modmatmul.cu", "openfhe_tpu/ops/modmatmul.py:138"),
    "mod_matmul_simt": ("csrc/modmatmul.cu",
                        "openfhe_tpu/ops/modmatmul.py:138"),
    "conv_digits_rows": ("csrc/sharded.cu",
                         "openfhe_tpu/parallel/sharded_fused.py:318"),
    "conv_digits_rows_rowmod": ("csrc/sharded.cu",
                                "openfhe_tpu/parallel/sharded_fused.py:318"),
    "conv_p_to_q_rows": ("csrc/sharded.cu",
                         "openfhe_tpu/parallel/sharded_fused.py:348"),
    "conv_p_to_q_rows_rowmod": ("csrc/sharded.cu",
                                "openfhe_tpu/parallel/sharded_fused.py:348"),
    "ntt_keymul_acc_rows": ("csrc/sharded.cu",
                            "openfhe_tpu/parallel/sharded_fused.py:396"),
    "ntt_keymul_acc_rows_staged": (
        "csrc/sharded.cu", "openfhe_tpu/parallel/sharded_fused.py:396"),
}
# kernel m's cases: (N, towers, rows, what the shape is); ntt_small_cases
# adds the STD128 RGSW key's rows at keygen, read from its parameters
SMALL_CASES = ((1024, 1, 1536, "the per-step loop's digits: 256 x d2 6"),
               (1024, 1, 512, "a gate batch's extraction: 256 x 2"),
               (2048, 2, 64, "the STD192 ring's shape"),
               (128, 4, 8, "smallest ring, 4 towers"),
               (1024, 1, 1, "one ring element: the lattice toolbox's"))
GINX_SET = "STD128"       # bench.py's GINX configuration
LMK_SET = "STD128_LMKCDEY"
AP_SET = "STD128_AP"
GATE_BATCH = 256          # bench.py's GINX batch
LMK_BATCHES = (1, 64)     # bench.py's LMKCDEY batches
AP_BATCH = 64
FUNC_BATCH = 4
GATE_REPS = 3
BLIND_REPS = 5
LOOP_REPS = 2             # the per-step loop takes about half a second
SPLIT_STEP = 100
SIGN_MOD = 1 << 17
# CKKS noise at 26-bit scales and N=2^16: a fresh encryption's slot error
# e has a std of about 2.5e-3 (max over the 32768 slots about 1.5e-2), and
# the product's error z*(e_a + e_b) grows with |z|; inputs |z| <= 1/4 keep
# it under TOL. The product of the two decrypted inputs carries the same
# fresh noise, so EvalMult + Rescale must land closer to it: what is left
# is mostly the rescale's rounding (tau0 + tau1*s, about 2e-4 per slot).
#
# A key switch ends in ApproxModDown, whose P -> Q conversion is approximate:
# it leaves -(Y0 + Y1*s) in the coefficients, Y = sum_i y_i / p_i over the
# 16 P towers, mean c = sum_i (p_i - 1) / (2 p_i) ~ 8 on every coefficient
# (the residues are not centred; the JAX package and the reference do the
# same). Its mean part -c(1 + (1,...,1)*s) is a low-frequency polynomial
# that, at a 2^26 scale, moves the few slots near X = 1 by up to ~1 (a
# numpy model over random secrets: 0.4-1.8), so a rotation at level 0
# cannot be held to MULT_TOL. Two checks follow from that:
#   * at the product's scale 2^52 the key switch's error vanishes in the
#     rescale: Rescale(rotate(prod)) against the rotated decryption of
#     Rescale(prod) differs by two rescale roundings, each at most
#     1.5e-3 per slot on the H100 (PERF.md), so MULT_TOL holds;
#   * at level 0 the error of rotate(ct_a) against the rotated decryption,
#     minus the mean part computed from this run's secret
#     (`modown_mean_slots`), leaves the fluctuation Y - c (per coefficient
#     std sqrt(16/12) * sqrt(2N/3) ~ 240, slot max 5e-3 to 8e-3 in the
#     model) and the key's own error e_j times the extended digits over P
#     (digit 0 is 2^-8 of P; slot max 7e-3 to 2.4e-2 in the model, which
#     cannot be predicted without e_j): ROT_RESID_TOL = 6e-2. A wrong
#     rotation leaves |z_i+1 - z_i-1|, up to 0.5.
# EvalSum of batch 64 runs at the product's scale too (EvalInnerProduct,
# then Rescale) and is held against the same ladder run in numpy on
# dec(Rescale(prod)): each of its slots sums 64 slots, each with its own
# rescale rounding (complex std ~3.3e-4), so std 8 * 3.3e-4 ~ 2.6e-3 and a
# max over 32768 slots near 4.5 std ~ 1.2e-2, plus the sum's own rescale
# rounding (<= 2.1e-3 complex): SUM_TOL = 2e-2.
Z_MAX = 0.25
TOL = 1e-2
MULT_TOL = 4e-3
ROT_RESID_TOL = 6e-2
SUM_BATCH = 64
SUM_TOL = 2e-2
REPS = 20
PROFILE_TRIES = 5
SPIN_CYCLES = 2_000_000   # about 1 ms at the H100's clock

# phase 7: the leveled CKKS layer (FLEXIBLEAUTO at the main path's widths)
LEVELED_SEED = 17
MERGE = 8                 # EvalMerge of 8 (rotation keys -1 ... -7)
WSUM = (0.5, -1.25, 2.0, -0.75)
FUNC_DEGREE = 32          # examples/function_evaluation.py's two calls
LOGISTIC_WIDE = (-8.0, 8.0, 119)
LEVEL_SPARE_BITS = 10     # above the result's scale at its level
# (c): technique, depth, other parameters
CHAINS = (("FLEXIBLEAUTOEXT", 10, {}),
          ("COMPOSITESCALINGAUTO", 8, dict(scaling_mod_size=50,
                                           first_mod_size=56)))
CHAIN_SPREAD = 0.03       # the chain's factor y ~ U(0.97, 1.03)
CHAIN_ADD = 0.0625
# Phase 7's noise note. Its inputs are fresh encryptions of |z| <= Z_MAX
# at 2^26 scales, whose slot error reaches about 1.5e-2 (6 std of 2.5e-3,
# see above), so the ops that keep a fresh error unscaled are held to
# 3e-2, twice it. The rest follow the same error through what the op does
# to it: EvalSub adds two (sqrt 2), EvalLinearWSum 4 weighs four by WSUM
# (norm 2.5), a product by |z| <= 1/4 shrinks it (EvalMult by a
# plaintext, EvalMultAndRelinearize), EvalSquare doubles that, the x1
# multiply of (b) adds z^2 y + z's. A function's result carries the input
# error times the function's slope (sin 1, the logistic 1/4) plus the
# series' own rescale roundings, on top of the Chebyshev interpolant's
# error, which `cheb_error` computes in numpy at the call's degree (below
# 1e-14 at degree 32 on [-1, 1] and at degree 119 on [-8, 8]). Each limit
# is about twice the error of one CPU run of the port's plain path at the
# same parameters and seeds (a scratch run, not a test; it measured
# EvalSub 2.3e-2, the single fresh errors 1.5e-2, EvalMult scalar 1.1e-2,
# EvalMult plaintext 3.4e-3, EvalSquare 6.7e-3, EvalMultAndRelinearize
# 4.3e-3, EvalLinearWSum 4.1e-2, EvalMerge 3.8e-3, the bring 1.5e-2,
# Compress 4.4e-3, the degree-32 logistic 4.1e-3 and sine 1.3e-2, the
# degree-119 logistic 6.3e-3 from level 0 and 6.8e-3 from level 21, (b)
# 2.6e-2, the FLEXIBLEAUTOEXT chain 5.7e-3 and the composite chain, at
# 2^50 scales, 1.9e-9).
LEVELED_LIMITS = {
    "EvalSub": 4e-2, "EvalNegate": 3e-2, "EvalAdd scalar": 3e-2,
    "EvalSub scalar": 3e-2, "EvalMult scalar": 2.5e-2,
    "EvalAdd plaintext": 3e-2, "EvalSub plaintext": 3e-2,
    "EvalMult plaintext": 1e-2, "EvalSquare": 1.5e-2,
    "EvalMultAndRelinearize": 1e-2, "EvalLinearWSum 4": 8e-2,
    f"EvalMerge {MERGE}": 1e-2, "EvalAdd (1, 2) + (0, 1)": 3e-2,
    "Compress": 1e-2, "FIXEDAUTO x1": 5e-2, "FLEXIBLEAUTOEXT": 1.5e-2,
    "COMPOSITESCALINGAUTO": 1e-8}
# the noise allowance of each function call, added to `cheb_error`
FUNC_NOISE = {"EvalLogistic": 1e-2, "EvalSin": 3e-2,
              "EvalLogistic wide": 1.5e-2}

# phase 9: CKKS bootstrapping. (ring, depth, slots, level budget) of
# `bench.py`'s bench_boot16 (a) and bench_boot (b, c); both
# COMPOSITESCALINGAUTO at 50-bit scales (`boot_bench_params`)
BOOT_SEED = 7
BOOT16 = (1 << 16, 24, 1 << 11, (3, 3))
BOOT12 = (1 << 12, 20, 256, (2, 2))
# the reference's documented single-round floor
# (tests/test_bootstrap.py:163-165), and StCFirst's
BOOT16_BITS = BOOT_BITS = 10.0
STC_BITS = 4.0
TWO_ROUND_GAIN = 0.3      # tests/test_bootstrap.py:93
# (c) EvalFBT at examples/functional_bootstrapping_ckks.py's configuration
# (FLEXIBLEAUTO, 28/30-bit moduli, depth 22, 8 slots, p = 8) on N=2^12,
# the largest ring of 2^9-2^12
FBT_CONFIG = (1 << 12, 22, 8, 8)
FBT_DIGITS = np.array([0, 3, 1, 7, 2, 6, 5, 4])
FBT_LUT = np.array([1, 2, 4, 0, 6, 3, 7, 5])

# phase 10: BinFHE's composite-Q ring (a) and CKKS <-> FHEW scheme
# switching (b, c)
WIDE_SET = "STD192"       # Q = q1 q2 of 38 bits, n = 821, N = 2048
WIDE_Q_SET = "STD192Q"    # 34 bits: one AND
WIDE_SEED = 13
# (b) examples/scheme_switching.py at 128-bit security: N=2^16 under
# HEStd_128_classic, FLEXIBLEAUTO, 28/30-bit moduli, the STD128 FHEW side
# and 16 slots (the example's sparse packing), q_LWE = 2^17 (the
# example's; at SchSwchParams' default 2^25 the JAX package's EvalSign
# returns wrong signs, ROADMAP queue 3). Depth 16: the compare's
# FHEW -> CKKS half ends at level 14 at STD128 (K = 128: 257 Chebyshev
# coefficients)
SSW_SEED = 19
SSW_RING = 1 << 16
SSW_DEPTH = 16
SSW_SLOTS = 16
SSW_LARGE_PREC = 17
SSW_P_LWE = 16            # EvalCKKStoFHEW of the integers 0 ... 15
SSW_CMP_P = 8             # EvalCompareSwitchPrecompute's p_LWE (example)
# least |x1 - x2| of the compared pairs. EvalSign's floors at q_LWE =
# 2^17 carry the functional bootstraps' noise, which at the STD128 side
# (n = 1305, N = 2048, the 27-bit Q and baseG = 128 of the JAX package's
# switching ring) is of the order of beta = 128 units of 2^17 or above: a
# floor can slip by one digit, 2^11 units, which flips a sign only for
# |x1 - x2| below about 1/8 (p_LWE = 8 puts 1 at 2^14 units)
SSW_GAP = 0.3
SSW_CMP_TOL = 0.1         # tests/test_schemeswitch.py's limit
# the 2048 diagonals would keep ~9.7 GB at 18 towers; the compare must
# leave far less behind (it keeps the key-switch and rescale tables of
# the 14 levels it passes: 0.79 GiB on an H100 80GB HBM3 at 700 W)
SSW_MEM_LIMIT_GB = 2.0
# (c) the card against the CPU's plain path: N=2^12, depth 20 (two
# tournament rounds), the TOY FHEW side (the CPU's per-step STD128 EvalSign
# takes minutes), min / max over 4 values
SSW_TWIN = (1 << 12, 20, "TOY")
SSW_VALS = np.array([0.6, 0.2, 0.8, 0.4])
SSW_MINMAX_TOL = 0.05

# phase 8: the integer schemes and the extended basis
INT_SEED = 23
BFV_LEVELED_DEPTH = 3     # its third product drops a tower (depth 2: none)
EXT_ROTS = (1, 2, 3)
EXT_CPU_LEVEL = 20        # the CPU twin's level: 11 Q towers, one digit
# The extended-basis ladder runs at the product's scale 2^52 and is
# rescaled once: against the sum of the three rotations of dec(Rescale(
# prod)) it carries four rescale roundings (its own and one of each
# rotation's operand), against the sum of three Rescale(EvalRotate(prod,
# r)) four too, each at most 1.5e-3 a slot and about 3.3e-4 in std
# (complex), so a max over 32768 slots near 4.5 std of the sum, ~3e-3:
# twice MULT_TOL, the limit of one rotation's two roundings in phase 4.
EXT_SUM_TOL = 2 * MULT_TOL

PROTO_SEED = 29
MP_PARTIES = 3
# The joint secret s1 + s2 + s3 of three ternary shares has variance 2 a
# coefficient (one key's 2/3), so the noise terms that carry s grow by
# sqrt(3) ~ 1.73 and the threshold decryption's smudging (sigma 3.19 a
# party) adds nothing visible at scale 2^26: twice phase 4's limits.
MP_MULT_TOL = 2 * MULT_TOL
MP_TOL = 2 * TOL
IB_TOWERS = 5             # the interactive bootstrap's input: 5 Q towers
# A refreshed ciphertext carries its input's noise and the noise of the
# refresh's fresh encryption, each about that of a fresh encryption under
# the same joint key, so sqrt(2) of one: its error is held to IB_NOISE
# times the error of a fresh threshold decryption of the same values
# under the same key, measured in the same run (at N=2^16 and scales near
# 2^26 that error is itself ~1e-2, so tests/test_interactive_boot.py's
# 1e-2 at N=512 does not carry over), and below IB_TOL.
IB_NOISE = 3.0
IB_TOL = 0.1
SHARE = (5, 3)            # ShareKeys(5, 3), recovered from parties 1, 3, 5
HERMITE_P = 4             # EvalHermiteTrigSeries of x^2 mod 4, order 1
# The series sum_j c_j z^j moves an input error e by at most
# sum_j j |c_j| e (0.5 e here: c = 0.25, 0, -0.25), and the input is a
# fresh encryption under the joint key of values of modulus 1: its error
# is held to HERMITE_NOISE times that bound at the fresh threshold
# decryption's error measured in (b), and below HERMITE_TOL.
HERMITE_NOISE = 3.0
HERMITE_TOL = 0.1
PRE_MODES = ("INDCPA", "FIXED_NOISE_HRA", "NOISE_FLOODING_HRA")
# the port's host-side steps, timed for each part's host share: the CRT
# lifts and lowers (encode, decode, the interactive bootstrap's exact
# extensions and rounding), ShareKeys' Horner and (de)serialization (its
# copies between the card and the host included)
HOST_STEPS = (("openfhe_tpu_torch.math.crt",
               ("interpolate", "interpolate_centered",
                "interpolate_centered_float", "to_residues_host")),
              ("openfhe_tpu_torch.pke.encoding.ckks_packed",
               ("encode_to_coeffs", "decode_from_coeffs")),
              ("openfhe_tpu_torch.pke.multiparty", ("share_keys",)),
              ("openfhe_tpu_torch.utils.serialization",
               ("serialize", "deserialize", "serialize_eval_mult_keys",
                "deserialize_eval_mult_keys",
                "serialize_eval_automorphism_keys",
                "deserialize_eval_automorphism_keys")))

# phase 12: the lattice toolbox, the native host library and the examples
LAT_SEED = 31
# (ring, gadget base): n = 1024 with base 2 (k = 28) runs kernel m; n =
# 16384, dgsampling's N_MAX (the largest ring its error constant covers),
# with base 32 (k = 6) runs kernels a/b; q = first_prime(28, 2n)
LAT_RINGS = ((1 << 10, 2), (1 << 14, 32))
LAT_Q_BITS = 28
# GaussSamp's x has its largest coefficient near 4.3 spectral bounds at
# n = 1024-16384 (the port's plain path on the CPU, a scratch run);
# tests/test_trapdoor.py holds the JAX package's to 10: the same here
LAT_NORM_FACTOR = 10.0
# Field2n on the card against the CPU: cuFFT and the CPU's FFT round
# differently, about 1e-15 relative at n = 2^14
FIELD_TOL = 1e-9
SAMPLE_LOG_COUNT = 20
SAMPLE_SIGMAS = (3.19, 40.0, float(1 << 22))    # table, table, rounding
SAMPLE_REPLAY = 1 << 16     # centers the CPU replays from the card's draws
SAMPLE_SE = 5.0             # statistical limits, in standard errors
BLUESTEIN_M = 4095          # phi 1728; its convolution a ring of 2 x 8192
EXAMPLES = ("simple_integers", "simple_real_numbers", "pre", "sampling",
            "external_prng")
EXAMPLE_CKKS_TOL = 1e-3     # simple_real_numbers at 28-bit scales

# phase 13: the other 48 examples at their own parameters, then the gate
# examples at the STD128 sets and three PKE examples at 128-bit security,
# their N chosen by the port's security tables (ring_dim=0)
OWN_EXAMPLES = tuple(sorted(
    p.stem for p in (Path(__file__).resolve().parent / "examples_torch")
    .glob("*.py") if p.stem not in ("__init__", *EXAMPLES)))
# (example, its keyword arguments, the kernels it must launch): a gate
# example its set's blind rotation (row m'), a PKE example the fused chain
# of its ops (EvalMult: rows c-g; EvalRotate: h, d, e, f, j), and
# threshold_fhe, whose only op under the joint key is EvalAdd, the NTTs of
# its encryption and decryption shares (rows a and b); the JAX
# example's t = 12289 admits no 128-bit ring at depth 2 (the tables need
# t = 1 mod 2N), so the BGV one takes the reference example's 65537
FULL_WIDTH = (
    ("boolean", dict(param_set="STD128"), ("blind_rotate_cggi",)),
    ("boolean_pke", dict(param_set="STD128"), ("blind_rotate_cggi",)),
    ("boolean_ap", dict(param_set="STD128_AP"), ("blind_rotate_dm",)),
    ("boolean_lmkcdey", dict(param_set="STD128_LMKCDEY"),
     ("blind_rotate_lmkcdey",)),
    ("boolean_truth_tables", dict(param_set="STD128"),
     ("blind_rotate_cggi",)),
    ("simple_integers_bgvrns", dict(plaintext_modulus=65537, ring_dim=0,
                                    security_level="HEStd_128_classic"),
     ("tensor_intt", "conv_digits", "ntt_keymul_acc", "intt_conv_p",
      "ntt_submul_final", "intt_scale", "ntt_subscale")),
    ("simple_complex_numbers", dict(ring_dim=0,
                                    security_level="HEStd_128_classic"),
     ("tensor_intt", "conv_digits", "ntt_keymul_acc", "intt_conv_p",
      "ntt_submul_final")),
    ("threshold_fhe", dict(ring_dim=0, security_level="HEStd_128_classic"),
     ("ntt_fwd", "ntt_inv")),
)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median time of fn() in ms, CUDA events around each call (the
    host's launch cost included where the card waits for it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of fn() in ms with the host's launch cost taken
    out: the card first spins for about a millisecond (`torch.cuda._sleep`),
    so fn's launches are queued before its first kernel starts and the
    events time the kernels back to back. For calls whose device time is
    below their host time (kernel m at a gate's shapes); a host
    synchronisation inside fn puts its host time back in."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def int32_rate() -> tuple:
    """(32-bit integer op/s, max SM clock in MHz, SMs) of card 0: 128 a
    clock an SM (the issue ceiling over both integer pipes) x the SMs x the
    maximum SM clock nvidia-smi reports. Raises if nvidia-smi cannot tell
    the clock."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    require(mhz > 0 and sms > 0, f"no SM clock or count: {mhz} MHz, {sms}")
    return INT32_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6, mhz, sms


def bound(nbytes: float, ops: float, tc_ops: float = 0):
    """(ms, what bounds it): the largest of the bytes at HBM_BYTES_PER_S,
    the 32-bit integer operations at INT32_OPS_PER_S and the int8
    tensor-core operations at INT8_TC_OPS_PER_S."""
    require(INT32_OPS_PER_S is not None, "the integer rate is not set")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / INT32_OPS_PER_S, tc_ops / INT8_TC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_residues(gen, moduli, n, lead=()):
    q = torch.tensor(moduli, dtype=torch.int64, device="cuda").view(-1, 1)
    raw = torch.randint(0, 1 << 62, tuple(lead) + (len(moduli), n),
                        generator=gen, device="cuda", dtype=torch.int64)
    x = torch.remainder(raw, q)
    x[..., 0] = q[:, 0] - 1                 # the largest residue, each tower
    return x.int()


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def ntt_cases(ntt, basis, gen, label, lead=()):
    """The cluster and the staged transform of csrc/ntt.cu against the
    plain version on one basis, word for word, each timed; every call of
    ntt_fwd / ntt_inv launches the cluster entry once where
    `cluster_geometry` takes the ring (else the staged one). Returns a
    case dict per entry point."""
    n, k = basis.ring_dim, basis.k
    x = rand_residues(gen, basis.moduli, n, lead)
    shape = list(x.shape)
    geom = ntt.cluster_geometry(n)
    out = {}
    for name, kern, staged, ref in (
            ("ntt_fwd", ntt.ntt_fwd, ntt._ntt_fwd_staged_cu,
             ntt._ntt_fwd_ref),
            ("ntt_inv", ntt.ntt_inv, ntt._ntt_inv_staged_cu,
             ntt._ntt_inv_ref)):
        both = (name, name + "_staged")
        got, per = count_launches(lambda: kern(x, basis), both)
        want, by_stages = ref(x, basis), staged(x, basis)
        torch.cuda.synchronize()
        err, err_staged = max_abs_err(got, want), max_abs_err(by_stages,
                                                              want)
        require(err == 0 and err_staged == 0,
                f"{name} {label} {shape} differs from its plain version "
                f"(max abs err: cluster {err}, staged {err_staged})")
        want_per = dict(zip(both, (1, 0) if geom else (0, 1)))
        require(per == want_per, f"{name} {label} {shape} launched {per}, "
                f"expected {want_per}")
        # x and out once each, twiddles and their companions once each
        nbytes = 4 * (2 * x.numel() + 2 * k * n)
        ops = x.numel() // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS
        if name == "ntt_inv":
            ops += x.numel() * SHOUP_OPS
        b_ms, b_by = bound(nbytes, ops)
        plain_ms = cuda_ms(lambda: ref(x, basis))
        staged_ms = device_ms(lambda: staged(x, basis))
        staged_call_ms = cuda_ms(lambda: staged(x, basis))
        common = dict(shape=shape, moduli=label, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
        out[name] = dict(common, max_abs_err=err,
                         ms=device_ms(lambda: kern(x, basis)),
                         call_ms=cuda_ms(lambda: kern(x, basis)),
                         staged_ms=staged_ms, staged_call_ms=staged_call_ms,
                         launches_per_call=per[name],
                         cluster=list(geom) if geom else None)
        out[name + "_staged"] = dict(common, max_abs_err=err_staged,
                                     ms=staged_ms, call_ms=staged_call_ms)
    return out


def rowmod_case(mm, tab, d_basis, gen, label, lead=()):
    """Kernel k (`mod_matmul_rowmod`) against its plain version and its
    former form `mod_matmul_rowmod_eager`, word for word, on words below
    2^31 that are not reduced mod the input moduli; each call must launch
    the entry once and the former form never. `ms` is device time
    (`device_ms`) and `call_ms` a call, each beside the former form's in
    this run. Returns the case of each entry."""
    name = "mod_matmul_rowmod"
    former = FORMER[name]
    a_dim, d_dim = tab.bhat_mod_d.shape
    n = d_basis.ring_dim
    y = rand_residues(gen, [2 ** 31 - 1] * a_dim, n, lead)
    w = (tab.bhat_mod_d, tab.bhat_mod_d_sh, d_basis.q)
    kern = lambda: mm.mod_matmul_rowmod(y, *w, d_basis.red64)
    eager = lambda: mm.mod_matmul_rowmod_eager(y, *w)
    ref = lambda: mm._mod_matmul_rowmod_ref(y, tab.bhat_mod_d, d_basis.q)
    got, per = count_launches(kern, (name, former))
    want, by_eager = ref(), eager()
    torch.cuda.synchronize()
    err, err_eager = max_abs_err(got, want), max_abs_err(by_eager, want)
    require(err == 0 and err_eager == 0,
            f"{name} {label} differs from its plain version (max abs err: "
            f"{name} {err}, {former} {err_eager})")
    require(per == {name: 1, former: 0},
            f"{name} {label} launched {per}, expected one launch of {name}")
    batch = y.numel() // (a_dim * n)
    # y and out once, the weights and companions, d and its red64 row
    nbytes = WORD * ((a_dim + d_dim) * n * batch + 2 * a_dim * d_dim
                     + 4 * d_dim)
    b_ms, b_by = bound(nbytes, pconv_ops(batch * n * d_dim, a_dim))
    eager_ms, eager_call_ms = device_ms(eager), cuda_ms(eager)
    common = dict(shape=list(lead) + [a_dim, d_dim, n], moduli=label,
                  plain_ms=cuda_ms(ref), bound_ms=b_ms, bound_by=b_by)
    return {name: dict(common, max_abs_err=err, ms=device_ms(kern),
                       call_ms=cuda_ms(kern), staged_ms=eager_ms,
                       staged_call_ms=eager_call_ms, former=former,
                       launches_per_call=per[name], cluster=None),
            former: dict(common, max_abs_err=err_eager, ms=eager_ms,
                         call_ms=eager_call_ms)}


def pconv_ops(outputs: int, terms: int) -> int:
    """Operations of a lazy conversion: `outputs` words of `terms` terms
    each, every word reduced once."""
    return outputs * (terms * LAZY_TERM_OPS + REDUCE_WIDE_OPS)


def fused_work(tabs, adds: int = 0) -> dict:
    """(bytes, operations) of each fused kernel at one table set: each
    input and output once, twiddles and keys included; the conversions'
    operations count their nonzero weights only. `intt_scale_p` is
    intt_scale's K4 form (2 elements of kp rows). K1t moves a1, b1, c2, y
    and the inverse twiddles once each; K6 reads `adds` addends of kql
    rows (0, 1 or 2) and adds each word of them."""
    n, kql, kp, nd = (tabs.basis_qlp.ring_dim, tabs.kql, tabs.kp, tabs.nd)
    kqlp, log_n = kql + kp, n.bit_length() - 1
    digits = [min(tabs.alpha, kql - j * tabs.alpha) for j in range(nd)]
    ntt = lambda rows: rows * n // 2 * log_n * BUTTERFLY_OPS
    t_ops = 0 if tabs.t_is_one else SHOUP_OPS
    return {
        "tensor_intt": (WORD * n * 6 * kql,
                        kql * n * (MULMOD_OPS + SHOUP_OPS) + ntt(kql)),
        "intt_scale": (WORD * n * 4 * kql, ntt(kql) + kql * n * SHOUP_OPS),
        "intt_scale_p": (WORD * n * 6 * kp,
                         ntt(2 * kp) + 2 * kp * n * SHOUP_OPS),
        "conv_digits": (WORD * n * (kql + nd * kqlp),
                        sum(pconv_ops(n * (kqlp - a), a) for a in digits)),
        # the extended digits' rows other than their own, c2, the key rows,
        # ext, the twiddles of the towers that transform at least once
        "ntt_keymul_acc": (WORD * n * (sum(kqlp - a for a in digits) + kql
                                       + 4 * nd * kqlp + 2 * kqlp
                                       + 2 * (kqlp if nd > 1
                                              else kqlp - digits[0])),
                           ntt(sum(kqlp - a for a in digits))
                           + 2 * nd * kqlp * n * ROWMOD_TERM_OPS),
        "intt_conv_p": (WORD * n * (2 * kp + 2 * kp + 2 * kql),
                        ntt(2 * kp) + 2 * kp * n * SHOUP_OPS
                        + pconv_ops(2 * kql * n, kp)),
        "ntt_subscale": (WORD * n * (8 + adds) * kql,
                         ntt(2 * kql) + 2 * kql * n * (SHOUP_OPS + 3
                                                       + t_ops)
                         + adds * kql * n * 2),
        "ntt_submul_final": (WORD * n * 12 * kql,
                             ntt(2 * kql) + kql * n * (3 * MULMOD_OPS + 12)
                             + 2 * kql * n * (SHOUP_OPS + 5 + t_ops)),
    }


def cluster_case(name, kern, staged, ref, args, tabs, work, label,
                 shape=None) -> dict:
    """A kernel against its plain twin and its former form `staged`
    (entry FORMER[name]), word for word; each call of kern must launch its
    entry once and the former one never. `ms` is device time (`device_ms`)
    and `call_ms` a call, each beside the former form's (`staged_ms`,
    `staged_call_ms`) in this run. Returns the case of each entry."""
    from openfhe_tpu_torch.ops.ntt import cluster_geometry
    both = (name, FORMER[name])
    got, per = count_launches(lambda: kern(*args, tabs), both)
    want, by_stages = ref(*args, tabs), staged(*args, tabs)
    torch.cuda.synchronize()
    if isinstance(got, tuple):          # K1t: (c2, y)
        got, want, by_stages = map(torch.stack, (got, want, by_stages))
    err, err_staged = max_abs_err(got, want), max_abs_err(by_stages, want)
    require(err == 0 and err_staged == 0,
            f"{name} {label} differs from its plain version (max abs err: "
            f"cluster {err}, staged {err_staged})")
    require(per == {name: 1, FORMER[name]: 0},
            f"{name} {label} launched {per}, expected one launch of {name}")
    b_ms, b_by = bound(*work)
    staged_ms = device_ms(lambda: staged(*args, tabs))
    staged_call_ms = cuda_ms(lambda: staged(*args, tabs))
    common = dict(shape=shape or [tabs.kql, tabs.kp, tabs.nd,
                                  tabs.basis_qlp.ring_dim],
                  moduli=label, plain_ms=cuda_ms(lambda: ref(*args, tabs)),
                  bound_ms=b_ms, bound_by=b_by)
    return {name: dict(common, max_abs_err=err,
                       ms=device_ms(lambda: kern(*args, tabs)),
                       call_ms=cuda_ms(lambda: kern(*args, tabs)),
                       staged_ms=staged_ms, staged_call_ms=staged_call_ms,
                       former=FORMER[name], launches_per_call=per[name],
                       cluster=(list(cluster_geometry(
                           tabs.basis_qlp.ring_dim))
                           if name in FUSED_CLUSTER else None)),
            FORMER[name]: dict(common, max_abs_err=err_staged,
                               ms=staged_ms, call_ms=staged_call_ms)}


def fused_cases(ksf, tabs, key, gen, label, names=FUSED) -> list:
    """Each kernel of the fused key switches (of `names`) vs its plain
    twin and its former form (`cluster_case`; K2's former form is run on
    `_pad_digits` of its input) on one table set, on random residues (and
    a random key with companions); `intt_scale` in its K1 form and its K4
    form (both elements' P rows of ext, read in place). Returns (entry,
    case) pairs."""
    n, nd = tabs.basis_qlp.ring_dim, tabs.nd
    mq, mqlp = tabs.basis_ql.moduli, tabs.basis_qlp.moduli
    a = [rand_residues(gen, mq, n) for _ in range(4)]
    y = rand_residues(gen, mq, n)
    conv = rand_residues(gen, mqlp, n, (nd,))
    ext = rand_residues(gen, mqlp, n, (2,))
    convq = rand_residues(gen, mq, n, (2,))
    keys = (key.bv, key.bv_sh, key.av, key.av_sh)
    p_rows = lambda fn: (lambda x, t: fn(x, t, p_rows=True))
    pad = lambda y, t: ksf.conv_digits_rowmod(ksf._pad_digits(y, t), t)
    work = fused_work(tabs)
    # (entry, kernel, former form, twin, inputs, work, label)
    calls = [
        ("tensor_intt", ksf.tensor_intt, ksf.tensor_intt_staged,
         ksf._tensor_intt_ref, (a[1], a[3]), work["tensor_intt"], label),
        ("intt_scale", ksf.intt_scale, ksf.intt_scale_staged,
         ksf._intt_scale_ref, (a[2],), work["intt_scale"], label),
        ("intt_scale", p_rows(ksf.intt_scale),
         p_rows(ksf.intt_scale_staged), p_rows(ksf._intt_scale_ref),
         (ext,), work["intt_scale_p"],
         f"{label}, K4 form: ext's P rows x 2"),
        ("conv_digits", ksf.conv_digits, pad, ksf._conv_digits_ref, (y,),
         work["conv_digits"], label),
        ("ntt_keymul_acc", ksf.ntt_keymul_acc, ksf.ntt_keymul_acc_staged,
         ksf._ntt_keymul_acc_ref, (conv, a[0], *keys),
         work["ntt_keymul_acc"], label),
        ("intt_conv_p", ksf.intt_conv_p, ksf.intt_conv_p_staged,
         ksf._intt_conv_p_ref, (ext,), work["intt_conv_p"], label),
        ("ntt_subscale", ksf.ntt_subscale, ksf.ntt_subscale_staged,
         ksf._ntt_subscale_ref, (convq, ext), work["ntt_subscale"], label),
        ("ntt_submul_final", ksf.ntt_submul_final,
         ksf.ntt_submul_final_staged, ksf._ntt_submul_final_ref,
         (convq, ext, *a), work["ntt_submul_final"], label),
    ]
    out = []
    for name, kern, staged, ref, args, cost, case_label in calls:
        if name in names:
            out += cluster_case(name, kern, staged, ref, args, tabs, cost,
                                case_label).items()
    return out


def rand_key(gen, moduli, n):
    """A random eval key over `moduli` (two digits) with its companions."""
    from openfhe_tpu_torch.pke.keys import EvalKey
    from openfhe_tpu_torch.pke.keyswitch import hybrid
    return hybrid.shoup_companions(EvalKey(
        bv=rand_residues(gen, moduli, n, (2,)),
        av=rand_residues(gen, moduli, n, (2,))), moduli)


def cluster_shape_cases(ksf, gen, rings, wide, n):
    """K3, K45, K6f and K2 (`cluster_case`) on 4 Q + 2 P towers of each
    (ring, moduli) of `rings`, in two digits and in one (clusters of 1 to 8
    blocks; a cluster of one syncs its block between digit transforms);
    then at ring n in one digit over 4 Q + kp P towers of `wide` for each
    kp of WIDE_P, which `pconv` takes with 2 columns a thread (up to 32
    rows) and 1 (up to 64). Yields (entry, case)."""
    from openfhe_tpu_torch.lattice.basis import make_basis
    shapes = []
    for ring, moduli in rings:
        basis, key = (make_basis(moduli[:6], ring, device="cuda"),
                      rand_key(gen, moduli[:6], ring))
        for nd in (2, 1):
            shapes.append((ksf.make_fused_ks_tables(basis, 4, 4, nd), key,
                           f"N=2^{ring.bit_length() - 1}, largest 31-bit "
                           f"primes (4 Q + 2 P), {('one', 'two')[nd - 1]} "
                           "digit" + "s" * (nd - 1)))
    for kp in WIDE_P:
        moduli = wide[:4 + kp]
        shapes.append((ksf.make_fused_ks_tables(
            make_basis(moduli, n, device="cuda"), 4, 4, 1),
            rand_key(gen, moduli, n),
            f"largest 31-bit primes (4 Q + {kp} P), one digit"))
    for tabs, key, label in shapes:
        yield from fused_cases(ksf, tabs, key, gen, label,
                               tuple(FORMER))


def modown_mean_slots(cc, sk, scale: float) -> np.ndarray:
    """Slot values of the mean part of a key switch's ApproxModDown
    rounding, -c (1 + (1,...,1)*s) with c = sum_i (p_i - 1) / (2 p_i) over
    the P towers (see the noise note above), from this run's secret."""
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.ops.ntt import _ntt_inv_ref
    from openfhe_tpu_torch.pke.encoding import ckks_packed
    n, q0 = cc.ring_dim, cc.moduli_q[0]
    s = _ntt_inv_ref(sk.s_qp[:1].cpu(), make_basis(cc.moduli_q[:1], n))
    s = s[0].numpy().astype(np.int64)
    s = np.where(s > q0 // 2, s - q0, s)
    c = sum((p - 1) / (2 * p) for p in cc.moduli_p)
    ones_s = 2 * np.cumsum(s) - s.sum()       # (1,...,1) * s, negacyclic
    return ckks_packed.decode_from_coeffs(-c * (1.0 + ones_s), n, cc.slots,
                                          scale)


def count_launches(fn, names):
    """fn() and the launches it made, per kernel name."""
    from openfhe_tpu_torch import _build
    before = dict(_build.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: _build.LAUNCHES[k] - before.get(k, 0) for k in names}


def device_kernels(fn, want: int | None = None) -> list:
    """The names of the device kernels one call of fn runs, a name per
    launch (`trace_evalmult.profile_device`: a profiler step that starts
    the tracing, then the recorded call). Late in a long process a
    session that recorded from its first call came up short: 1 of a BGV
    EvalMult's 6 kernels in PR 15's runs, 0 of 6 five times in one of PR
    16's, where a fresh process recorded all 6. With `want`, a profile
    that records fewer is printed and taken again, up to PROFILE_TRIES
    profiles; one that records more is returned as it is, for the
    caller's check to refuse."""
    from openfhe_tpu_torch.trace_evalmult import profile_device
    for attempt in range(PROFILE_TRIES):
        names = list(profile_device(fn)["launches"].elements())
        if want is None or len(names) >= want:
            break
        print(f"profile {attempt + 1} recorded {len(names)} device "
              f"kernels, expected {want}: {[n[:60] for n in names]}")
    return names


def rgsw_keygen_case() -> tuple:
    """Kernel m's largest launch, a SMALL_CASES entry: the a and e rows of
    GINX_SET's RGSW bootstrapping key at keygen, [n, 2, d2] rows of N
    (`rgsw.keygen_cggi_pair`), each one `ntt_fwd`."""
    from openfhe_tpu_torch.binfhe.context import BinFHEContext
    p = BinFHEContext(device="cpu").GenerateBinFHEContext(GINX_SET).rgsw
    return (p.ring_dim, 1, p.n_lwe * 2 * p.digits_g2,
            f"{GINX_SET} RGSW key's rows at keygen: {p.n_lwe} x 2 x "
            f"d2 {p.digits_g2}")


def ntt_small_cases(gen, card: str) -> dict:
    """Kernel m vs its dense plain version, and beside it ntt.cu's
    transform of the same input (equal words), each timed and printed
    with the card's name and power limit."""
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.math import nbtheory
    from openfhe_tpu_torch.ops import ntt, ntt_small
    out = {name: [] for name in SMALL}
    for n, k, rows, label in SMALL_CASES + (rgsw_keygen_case(),):
        moduli, q = [], 1 << 27
        while len(moduli) < k:
            q = nbtheory.previous_prime(q, 2 * n)
            moduli.append(q)
        basis = make_basis(moduli, n, device="cuda")
        x = rand_residues(gen, moduli, n, (rows // k,))
        log_n = n.bit_length() - 1
        for name, kern, ref, tile in (
                ("ntt_small_fwd", ntt_small.ntt_small_fwd,
                 ntt_small._ntt_small_fwd_ref, ntt._ntt_fwd_cu),
                ("ntt_small_inv", ntt_small.ntt_small_inv,
                 ntt_small._ntt_small_inv_ref, ntt._ntt_inv_cu)):
            got, want, cu = kern(x, basis), ref(x, basis), tile(x, basis)
            torch.cuda.synchronize()
            err, err_cu = max_abs_err(got, want), max_abs_err(got, cu)
            require(err == 0 and err_cu == 0,
                    f"{name} N={n} k={k} rows={rows} differs from its plain "
                    f"version (max abs err {err}) or from ntt.cu ({err_cu})")
            # each row read and written once, the tower tables once
            nbytes = WORD * 2 * x.numel() + 2 * WORD * k * n
            ops = rows * (n // 2) * log_n * BUTTERFLY_OPS
            if name == "ntt_small_inv":
                ops += x.numel() * SHOUP_OPS
            b_ms, b_by = bound(nbytes, ops)
            c = dict(
                shape=[rows, n], towers=k, moduli=label, max_abs_err=err,
                ms=device_ms(lambda: kern(x, basis)),
                call_ms=cuda_ms(lambda: kern(x, basis)),
                plain_ms=device_ms(lambda: ref(x, basis)),
                ntt_cu_ms=device_ms(lambda: tile(x, basis)),
                ntt_cu_call_ms=cuda_ms(lambda: tile(x, basis)),
                bound_ms=b_ms, bound_by=b_by)
            out[name].append(c)
            print(f"  {name:13s} {str(c['shape']):12s} k={k} {label:45s} "
                  f"kernel {c['ms']:.4f} ms (call {c['call_ms']:.4f})  "
                  f"ntt.cu {c['ntt_cu_ms']:.4f} ms (call "
                  f"{c['ntt_cu_call_ms']:.4f})  plain {c['plain_ms']:.4f} "
                  f"ms  bound {b_ms:.4f} ms ({b_by})  max_abs_err {err}  "
                  f"[{card}]")
    return out


def blind_work(form, params, batch, keys, tables, lo, hi):
    """(bytes, operations) of a blind rotation's steps [lo, hi): each key
    row these inputs read once (AP and LMKCDEY: only the rows gathered),
    the accumulators in and out, the step tables and the block's twiddle
    tables once; per gate-step that transforms, the 2 + d2 transforms, N^-1,
    the decomposition, the key product's 64-bit terms, its reductions and
    GINX's monomial products (LMKCDEY's permute-only steps do none)."""
    n, d2 = params.ring_dim, params.digits_g2
    log_n = n.bit_length() - 1
    row_bytes = WORD * d2 * 2 * n
    if form == "cggi":
        nbytes = WORD * keys[lo:hi].numel() + tables.numel() * WORD
        gate_steps = batch * (hi - lo)
    elif form == "dm":
        nbytes = row_bytes * tables[lo:hi].unique().numel() \
            + tables.numel() * WORD
        gate_steps = batch * (hi - lo)
    else:
        run = tables[1][lo:hi]
        moves = (run[..., 3] > 0) | (run[..., 2] == 0)   # not permute-only
        nbytes = (row_bytes * run[..., 1][moves].unique().numel()
                  + WORD * n * run[..., 0].unique().numel()
                  + run.numel() * WORD)
        gate_steps = int(moves.sum())
    nbytes += WORD * (4 * batch * n + (6 if form == "cggi" else 4) * n)
    step = ((2 + d2) * n // 2 * log_n * BUTTERFLY_OPS + 2 * n * SHOUP_OPS
            + 2 * n * (CENTRE_OPS + params.digits_g * DIGIT_OPS))
    if form == "cggi":
        step += n * (4 * d2 * MATMUL_TERM_OPS + 6 * MULMOD_OPS
                     + 4 * MATMUL_TERM_OPS)
    else:
        step += n * (2 * d2 * MATMUL_TERM_OPS + 2 * MULMOD_OPS)
    return nbytes, gate_steps * step


def blind_rotate_cases(gen) -> dict:
    """The blind-rotation kernel of each form against the per-step loop on
    the card (`rgsw._eval_acc_*_steps`), word for word, at the BinFHE
    phase's parameter sets and batches, on random words as keys and
    accumulators (any words are valid inputs to a blind rotation); one
    launch per blind rotation; a run split at SPLIT_STEP equals the whole.
    The kernel's `ms` is device time (`device_ms`), `call_ms` one call of
    `rgsw.eval_acc_*` (the tables built on the way), `plain_ms` the loop."""
    import math
    from openfhe_tpu_torch.binfhe import blind_rotate as br
    from openfhe_tpu_torch.binfhe import rgsw
    from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD
    from openfhe_tpu_torch.binfhe.context import BinFHEContext
    out = {name: [] for name in BLIND}
    for param_set, method, batches in (
            (GINX_SET, BINFHE_METHOD.GINX, (GATE_BATCH, 1)),
            (LMK_SET, BINFHE_METHOD.LMKCDEY, LMK_BATCHES),
            (AP_SET, BINFHE_METHOD.AP, (AP_BATCH,))):
        cc = BinFHEContext(seed=13).GenerateBinFHEContext(param_set, method)
        p = cc.rgsw
        n, big_n, d2 = cc.n, cc.N, p.digits_g2
        words = lambda *shape: torch.randint(
            0, cc.Q, shape, generator=gen, device="cuda", dtype=torch.int32)
        if method == BINFHE_METHOD.GINX:
            form, keys = "cggi", words(n, 2, d2, 2, big_n)
        elif method == BINFHE_METHOD.AP:
            digits_r = math.ceil(math.log(cc.q) / math.log(cc.base_r))
            form = "dm"
            keys = words(n, digits_r, cc.base_r, d2, 2, big_n)
        else:
            w = cc.num_auto_keys
            form, keys = "lmkcdey", words(1 + n + w + 1, d2, 2, big_n)
            perm = torch.from_numpy(rgsw.lmkcdey_perm_table(p, w)).cuda()
        name = f"blind_rotate_{form}"
        for batch in batches:
            acc0, acc1 = words(batch, big_n), words(batch, big_n)
            a = torch.randint(0, cc.q, (batch, n), generator=gen,
                              device="cuda", dtype=torch.int32)
            if form == "cggi":
                flat, tables = keys, br.cggi_idx(p, a)
                fused = lambda: rgsw.eval_acc_cggi(p, keys, acc0, acc1, a)
                loop = lambda: rgsw._eval_acc_cggi_steps(p, keys, acc0,
                                                         acc1, a)
            elif form == "dm":
                flat = keys.reshape(-1, d2, 2, big_n)
                tables = br.dm_rows(p, digits_r, cc.base_r, a)
                fused = lambda: rgsw.eval_acc_dm(p, keys, digits_r,
                                                 cc.base_r, acc0, acc1, a)
                loop = lambda: rgsw._eval_acc_dm_steps(
                    p, keys, digits_r, cc.base_r, acc0, acc1, a)
            else:
                flat = keys
                tables = (perm, br.lmkcdey_sched(p, a, w))
                fused = lambda: rgsw.eval_acc_lmkcdey_scan(
                    p, keys, *tables, acc0, acc1)
                loop = lambda: rgsw._eval_acc_lmkcdey_scan_steps(
                    p, keys, *tables, acc0, acc1)
            rotate = getattr(br, name)
            kernel = lambda lo=0, hi=None: rotate(p, flat, tables, acc0,
                                                  acc1, lo, hi)
            got, per = count_launches(fused, BLIND + SMALL)
            want = loop()
            direct = kernel()
            torch.cuda.synchronize()
            err = max(max_abs_err(torch.stack(got), torch.stack(want)),
                      max_abs_err(torch.stack(got), torch.stack(direct)))
            require(err == 0, f"{name} {param_set} batch {batch} differs "
                    f"from the per-step loop (max abs err {err})")
            require(per == {k: int(k == name) for k in BLIND + SMALL},
                    f"{name}: one blind rotation launched {per}")
            steps = (tables[1] if form == "lmkcdey" else tables).shape[0]
            split = None
            if batch == GATE_BATCH:
                part = kernel(0, SPLIT_STEP)
                part = rotate(p, flat, tables, *part, SPLIT_STEP, None)
                split = all(torch.equal(x, y) for x, y in zip(part, direct))
                require(split, f"{name}: steps [0, {SPLIT_STEP}) then "
                        f"[{SPLIT_STEP}, {steps}) differ from the whole")
            b_ms, b_by = bound(*blind_work(form, p, batch, flat, tables, 0,
                                           steps))
            out[name].append(dict(
                shape=[batch, steps, d2, big_n], moduli=param_set,
                max_abs_err=err, split_equal=split,
                launches_per_call=per[name],
                ms=device_ms(kernel, BLIND_REPS, 1),
                call_ms=cuda_ms(fused, BLIND_REPS, 1),
                plain_ms=cuda_ms(loop, LOOP_REPS, 0),
                bound_ms=b_ms, bound_by=b_by))
        del cc, keys
        torch.cuda.empty_cache()
    return out


def binfhe_phase(names) -> dict:
    """The BinFHE paths (see the module docstring); raises on any fault."""
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD, BINGATE
    from openfhe_tpu_torch.binfhe.context import BinFHEContext
    res = {}
    i = np.arange(GATE_BATCH)
    bits = {"a": i % 2, "b": (i // 2) % 2, "c": (i // 4) % 2}
    a, b, c = bits["a"], bits["b"], bits["c"]
    truth = {"AND": a & b, "OR": a | b, "NAND": 1 - (a & b),
             "XOR": a ^ b, "XNOR": 1 - (a ^ b)}

    # GINX at STD128, counted from the context on
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    cc = BinFHEContext(seed=11).GenerateBinFHEContext(GINX_SET)
    require(cc.device.type == "cuda", "BinFHEContext() is not on the card")
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)
    ct = {k: cc.Encrypt(sk, v) for k, v in bits.items()}
    torch.cuda.synchronize()
    res["ginx_keygen_encrypt_s"] = time.perf_counter() - t0
    wrong, outs = {}, {}
    for g, want in truth.items():
        outs[g], per = count_launches(
            lambda g=g: cc.EvalBinGate(BINGATE[g], ct["a"], ct["b"]), names)
        if g == "AND":
            per_gate = per
        wrong[g] = int((cc.Decrypt(sk, outs[g]) != want).sum())
    wrong["NOT"] = int((cc.Decrypt(sk, cc.EvalNOT(ct["a"])) != 1 - a).sum())
    wrong["Bootstrap"] = int((cc.Decrypt(sk, cc.Bootstrap(ct["a"]))
                              != a).sum())
    maj = cc.EvalBinGate(BINGATE.MAJORITY, [ct["a"], ct["b"], ct["c"]])
    wrong["MAJORITY"] = int((cc.Decrypt(sk, maj)
                             != (a + b + c >= 2)).sum())
    res["ginx_launches"] = {k: _build.LAUNCHES[k] for k in names}
    res["ginx_launches_per_gate"] = per_gate
    res["ginx_wrong"] = wrong
    print(f"GINX {GINX_SET} (n={cc.n}, N={cc.N}, d2={cc.rgsw.digits_g2}), "
          f"batch {GATE_BATCH}: wrong decryptions {wrong}; launches per "
          f"EvalBinGate {per_gate}; whole phase {res['ginx_launches']}")
    require(all(v == 0 for v in wrong.values()),
            f"GINX decryptions differ from the truth table: {wrong}")
    gate_kernels = SMALL + ("blind_rotate_cggi",)
    want_gate = {k: int(k in gate_kernels) for k in names}
    require(per_gate == want_gate,
            f"EvalBinGate launches {per_gate}, expected {want_gate}")
    require(all(res["ginx_launches"][k] == 0 for k in names
                if k not in gate_kernels),
            f"the BinFHE path launched another kernel: "
            f"{res['ginx_launches']}")

    # 4 gates on the port's plain path on the CPU, with the same keys
    t0 = time.perf_counter()
    cpu = BinFHEContext(seed=11, device="cpu").GenerateBinFHEContext(
        GINX_SET)
    cpu.ks_key = dataclasses.replace(cc.ks_key, a=cc.ks_key.a.cpu(),
                                     b=cc.ks_key.b.cpu())
    cpu.bt_key = cc.bt_key.cpu()
    four = lambda x: x.replace(a=x.a[:4].cpu(), b=x.b[:4].cpu())
    on_cpu = cpu.EvalBinGate(BINGATE.AND, four(ct["a"]), four(ct["b"]))
    same = (torch.equal(on_cpu.a, outs["AND"].a[:4].cpu())
            and torch.equal(on_cpu.b, outs["AND"].b[:4].cpu()))
    print(f"4 AND gates on the card == plain path on the CPU: {same} "
          f"({time.perf_counter() - t0:.1f} s on the CPU)")
    require(same, "GINX words on the card differ from the plain path")
    del cpu

    one = lambda x: x.replace(a=x.a[:1], b=x.b[:1])
    res["ginx_batch_ms"] = cuda_ms(
        lambda: cc.EvalBinGate(BINGATE.AND, ct["a"], ct["b"]), GATE_REPS, 1)
    res["ginx_single_ms"] = cuda_ms(
        lambda: cc.EvalBinGate(BINGATE.AND, one(ct["a"]), one(ct["b"])),
        GATE_REPS, 1)
    res["ginx_gates_per_s"] = GATE_BATCH / res["ginx_batch_ms"] * 1e3
    res["ginx_single_gates_per_s"] = 1e3 / res["ginx_single_ms"]
    print(f"GINX AND: {res['ginx_batch_ms']:.1f} ms per batch of "
          f"{GATE_BATCH} ({res['ginx_gates_per_s']:.1f} gates/s), "
          f"{res['ginx_single_ms']:.1f} ms for a batch of 1 "
          f"({res['ginx_single_gates_per_s']:.2f} gates/s); median of "
          f"{GATE_REPS}, CUDA events")

    # functional bootstraps at batch 4 on the same context
    p = 4
    x4 = np.arange(FUNC_BATCH) % p
    lut = cc.GenerateLUTviaFunction(lambda m, pp: (m * m) % pp, p)
    f_out, per_func = count_launches(
        lambda: cc.EvalFunc(cc.Encrypt(sk, x4, p=p), lut), names)
    got_f = cc.Decrypt(sk, f_out, p=p)
    # 2m at least 1/16 of the modulus from both sign boundaries (0, q/2)
    m_sign = np.array([4096, 60000, 16384, 49152])[:FUNC_BATCH]
    s_out, per_sign = count_launches(lambda: cc.EvalSign(cc.Encrypt(
        sk, m_sign, p=SIGN_MOD // 2, q=SIGN_MOD)), names)
    got_s = cc.Decrypt(sk, s_out, p=2)
    want_s = (2 * m_sign >= SIGN_MOD // 2).astype(np.int64)
    print(f"EvalFunc x^2 mod 4 on {x4.tolist()}: {got_f.tolist()} "
          f"(launches {per_func}); EvalSign at q={SIGN_MOD} on "
          f"{m_sign.tolist()}: {got_s.tolist()} (launches {per_sign})")
    require(np.array_equal(got_f, x4 * x4 % p), "EvalFunc decrypts wrong")
    require(np.array_equal(got_s, want_s), "EvalSign decrypts wrong")
    del cc, ct, outs
    torch.cuda.empty_cache()

    # LMKCDEY at batch 1 and 64, then AP at batch 64: AND
    for param_set, method, batches in (
            (LMK_SET, BINFHE_METHOD.LMKCDEY, LMK_BATCHES),
            (AP_SET, BINFHE_METHOD.AP, (AP_BATCH,))):
        t0 = time.perf_counter()
        cc = BinFHEContext(seed=12).GenerateBinFHEContext(param_set, method)
        sk = cc.KeyGen()
        cc.BTKeyGen(sk)
        torch.cuda.synchronize()
        keygen_s = time.perf_counter() - t0
        for batch in batches:
            ca, cb = (cc.Encrypt(sk, bits[k][:batch]) for k in ("a", "b"))
            out, per = count_launches(
                lambda: cc.EvalBinGate(BINGATE.AND, ca, cb), names)
            bad = int((cc.Decrypt(sk, out) != truth["AND"][:batch]).sum())
            ms = cuda_ms(lambda: cc.EvalBinGate(BINGATE.AND, ca, cb),
                         GATE_REPS, 1)
            key = f"{method.value.lower()}_batch{batch}"
            res[key] = dict(ms=ms, gates_per_s=batch / ms * 1e3,
                            wrong=bad, launches=per, keygen_s=keygen_s)
            print(f"{param_set} AND, batch {batch}: wrong {bad}, {ms:.1f} "
                  f"ms ({batch / ms * 1e3:.1f} gates/s), launches {per}, "
                  f"keygen {keygen_s:.1f} s")
            require(bad == 0, f"{param_set} decryptions differ from the "
                    "truth table")
            form = "dm" if method == BINFHE_METHOD.AP else "lmkcdey"
            want = {k: int(k in SMALL + (f"blind_rotate_{form}",))
                    for k in names}
            require(per == want, f"{param_set} launches {per}, expected "
                    f"{want}")
        del cc
        torch.cuda.empty_cache()
    res["launches"] = {k: _build.LAUNCHES[k] for k in names}
    print(f"BinFHE phase launches: {res['launches']}")
    require(all(res["launches"][k] > 0 for k in SMALL + BLIND),
            f"a BinFHE kernel was not launched: {res['launches']}")
    return res


def matmul_case(mm, w, x, q, label) -> dict:
    """Kernel l (`mod_matmul`, the int8 tensor cores) against its plain
    version and its former form `mod_matmul_simt`, word for word; each
    call must launch the entry once and the former form never. `ms` is
    device time (`device_ms`) and `call_ms` a call, each beside the former
    form's in this run. l's bound takes the largest of its bytes, its
    LIMB_PAIRS byte-limb products a term on the tensor cores and its
    epilogue's MATMUL_EPILOGUE_OPS an output word; the former form's is
    its own, MATMUL_TERM_OPS 32-bit operations a term. Returns the case of
    each entry."""
    name, former = "mod_matmul", FORMER["mod_matmul"]
    kern = lambda: mm.mod_matmul(w, x, q)
    simt = lambda: mm.mod_matmul_simt(w, x, q)
    ref = lambda: mm._mod_matmul_ref(w, x, q)
    got, per = count_launches(kern, (name, former))
    want, by_simt = ref(), simt()
    torch.cuda.synchronize()
    err, err_simt = max_abs_err(got, want), max_abs_err(by_simt, want)
    require(err == 0 and err_simt == 0,
            f"{name} {label} differs from its plain version (max abs err: "
            f"{name} {err}, {former} {err_simt})")
    require(per == {name: 1, former: 0},
            f"{name} {label} launched {per}, expected one launch of {name}")
    k, d_dim, a_dim = w.shape
    b_dim = x.shape[2]
    nbytes = WORD * (w.numel() + x.numel() + k * d_dim * b_dim + k)
    terms = k * d_dim * a_dim * b_dim
    b_ms, b_by = bound(nbytes, k * d_dim * b_dim * MATMUL_EPILOGUE_OPS,
                       2 * LIMB_PAIRS * terms)
    s_ms, s_by = bound(nbytes, terms * MATMUL_TERM_OPS)
    simt_ms, simt_call_ms = device_ms(simt), cuda_ms(simt)
    common = dict(shape=[k, d_dim, a_dim, b_dim], moduli=label,
                  plain_ms=cuda_ms(ref))
    return {name: dict(common, max_abs_err=err, ms=device_ms(kern),
                       call_ms=cuda_ms(kern), staged_ms=simt_ms,
                       staged_call_ms=simt_call_ms, former=former,
                       launches_per_call=per[name], cluster=None,
                       bound_ms=b_ms, bound_by=b_by),
            former: dict(common, max_abs_err=err_simt, ms=simt_ms,
                         call_ms=simt_call_ms, bound_ms=s_ms,
                         bound_by=s_by)}


def own_pairs(v) -> int:
    """The (row, digit) pairs of a shard whose row is the digit's own."""
    rows = v.basis_qlp.k
    return sum(max(0, min((j + 1) * v.alpha, v.kql_real, v.tau0 + rows)
                   - max(j * v.alpha, v.tau0)) for j in range(v.nd))


def shard_work(v) -> dict:
    """(bytes, operations) of kernels n, o, p on one shard's views: the
    conversions count their nonzero weights as `pconv` computes (n: a
    digit's rows with a weight, into its output rows with one; o: the P
    rows with a weight, into the Q rows with one), the key
    product as K3's (`fused_work`): the NTTs of its non-own (row, digit)
    pairs, the own rows it reads from c2, the twiddles of the rows that
    transform at least once."""
    n = v.basis_qlp.ring_dim
    rows, nd, kp = v.basis_qlp.k, v.nd, v.pconv_w.shape[0]
    own = own_pairs(v)
    ntt = (nd * rows - own) * n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS
    nz = v.conv_w != 0                          # [nd, alpha, rows]
    nzp = v.pconv_w != 0                        # [kp, kql_loc]
    tw_rows = rows if nd > 1 else rows - own
    return {
        "conv_digits_rows": (WORD * n * (v.kql + nd * rows),
                             sum(pconv_ops(n * int(nz[j].any(0).sum()),
                                           int(nz[j].any(1).sum()))
                                 for j in range(nd))),
        "conv_p_to_q_rows": (WORD * n * 2 * (kp + v.q.kql),
                             pconv_ops(2 * n * int(nzp.any(0).sum()),
                                       int(nzp.any(1).sum()))),
        "ntt_keymul_acc_rows": (WORD * n * (5 * nd * rows + 2 * rows
                                            + 2 * tw_rows),
                                ntt + 2 * nd * rows * n * ROWMOD_TERM_OPS),
    }


def shard_cases(sf, st, limb, gen, label) -> dict:
    """Kernels n, o, p vs their plain twins and their former forms
    (`cluster_case`: n's on `_pad_digits` of its input, the pad included)
    on every shard of one table set, on random words (the key is the table
    set's), one launch of the entry a call."""
    from openfhe_tpu_torch.pke.keyswitch import ks_fused
    out = {name: [] for name in SHARDED if "mod_matmul" not in name}
    f = st.fused
    n = f.basis_qlp.ring_dim
    pad = lambda y, v: sf.conv_digits_rows_rowmod(
        ks_fused._pad_digits(y, v), v)
    for idx in range(limb):
        v = sf.shard_view(st, limb, idx, f.basis_qlp.device)
        rows = v.basis_qlp.k
        y = rand_residues(gen, [2 ** 31 - 1] * f.kql, n)
        pc = rand_residues(gen, f.basis_p.moduli, n, (2,))
        conv = rand_residues(gen, v.basis_qlp.moduli, n, (f.nd,))
        c2 = rand_residues(gen, f.basis_ql.moduli, n)
        where = (f"{label}, shard {idx} of {limb} (Q_l*P rows {v.tau0}-"
                 f"{v.tau0 + rows - 1}, {own_pairs(v)} own)")
        work = shard_work(v)
        shape = [v.q.kql, rows, f.nd, n]
        for name, kern, former, ref, args in (
                ("conv_digits_rows", sf.conv_digits_rows, pad,
                 sf._conv_digits_rows_ref, (y,)),
                ("conv_p_to_q_rows", sf.conv_p_to_q_rows,
                 sf.conv_p_to_q_rows_rowmod, sf._conv_p_to_q_rows_ref,
                 (pc,)),
                ("ntt_keymul_acc_rows", sf.ntt_keymul_acc_rows,
                 sf.ntt_keymul_acc_rows_staged, sf._ntt_keymul_acc_rows_ref,
                 (conv, c2))):
            for entry, case in cluster_case(name, kern, former, ref, args, v,
                                            work[name], where,
                                            shape).items():
                out[entry].append(case)
    return out


def sharded_phase(cc, ct_a, ct_b, ct_c, sk, dec_ab, top31, gen, names,
                  card) -> dict:
    """The limb-sharded path (see the module docstring, phase 6); raises
    on any fault. dec_ab is dec(ct_a) * dec(ct_b)."""
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch import parallel as par
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.ops import modmatmul, ntt, ntt4step
    from openfhe_tpu_torch.parallel import ntt_sharded as ns
    from openfhe_tpu_torch.parallel import sharded as shd
    from openfhe_tpu_torch.parallel import sharded_fused as sf
    t_phase = time.perf_counter()
    n = cc.ring_dim
    r, c = ntt4step.split(n)
    cases = {name: [] for name in SHARDED}
    # kernel l at the sharded NTT's stage-1 shapes [k, R, R] x [k, R, C/L],
    # then at its edge: A = 2^15, every word q - 1 at q = 2^31 - 1 (prime),
    # whose bytes 254, 255, 255, 127 bring the limb-pair sums to 255^2 A
    m31 = 2 ** 31 - 1
    full = lambda *shape: torch.full(shape, m31 - 1, dtype=torch.int32,
                                     device=cc.device)
    mm_inputs = []
    for moduli, label, limbs in ((cc.moduli_q, "Q (31 towers)", LIMBS),
                                 (top31, "largest 31-bit primes", (2,))):
        t = ntt4step.dev_tables(tuple(moduli), n, str(cc.device))
        for limb in limbs:
            x = rand_residues(gen, moduli, c // limb, (r,)).transpose(0, 1)
            mm_inputs.append((t["wr"], x.contiguous(), t["q"],
                              f"{label}, stage 1 of a shard at limb {limb}"))
    mm_inputs.append((full(1, 16, 1 << 15), full(1, 1 << 15, 8),
                      torch.tensor([[m31]], dtype=torch.int32,
                                   device=cc.device),
                      "edge: A = 2^15, every word 2^31 - 2 (q = 2^31 - 1)"))
    for args in mm_inputs:
        for name, case in matmul_case(modmatmul, *args).items():
            cases[name].append(case)
    del mm_inputs
    # kernels n, o, p on every shard of four table sets; the last a padded
    # level whose second digit covers no rows of y (n writes it as zeros)
    key31 = rand_key(gen, top31, n)
    st = {lvl: sf.make_sharded_fused_tables(cc, cc.size_ql(lvl))
          for lvl in (1, 3)}
    b31q = make_basis(top31[:4], n, device=cc.device)
    b31p = make_basis(top31[4:], n, device=cc.device)
    st31 = sf.make_sharded_fused_tables_basis(b31q, b31p, 4, 2, key31)
    st31_pad = sf.make_sharded_fused_tables_basis(b31q, b31p, 1, 2, key31,
                                                  pad_to=2)
    for tabs, limb, label in (
            (st[1], 2, "level 1 (30 Q + 16 P)"),
            (st[3], 4, "level 3 (28 Q + 16 P)"),
            (st31, 2, "largest 31-bit primes (4 Q + 2 P)"),
            (st31_pad, 2, "largest 31-bit primes, 1 Q padded to 2 + 2 P, "
                          "digit 1 empty")):
        for name, rows in shard_cases(sf, tabs, limb, gen, label).items():
            cases[name] += rows
    del key31, st31, st31_pad
    kernel_s = time.perf_counter() - t_phase

    # the path, counted
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    mesh = {limb: par.make_mesh(limb) for limb in LIMBS}
    mesh["2x2"] = par.make_mesh(2, dp=2)
    for name, m in mesh.items():
        print(f"mesh {name}: {m}")
    same = {}
    # the sharded NTT on the Q basis
    x = rand_residues(gen, cc.moduli_q, n)
    y = ntt._ntt_fwd_cu(x, cc.basis_q)
    per_ntt = {}
    for limb in LIMBS:
        fwd, per_ntt[limb] = count_launches(
            lambda: ns.ntt_fwd_sharded(x, cc.basis_q, mesh[limb]), names)
        inv = ns.ntt_inv_sharded(y, cc.basis_q, mesh[limb])
        same[f"sharded NTT fwd, limb {limb}"] = torch.equal(fwd, y)
        same[f"sharded NTT inv, limb {limb}"] = (
            torch.equal(inv, ntt._ntt_inv_cu(y, cc.basis_q))
            and torch.equal(inv, x))
    # the sharded EvalMult, against the single-card fused one
    lvl = {l: (cc.LevelReduce(ct_a, l), cc.LevelReduce(ct_b, l))
           for l in (1, 3)}
    want = {l: cc.EvalMult(*lvl[l]) for l in (1, 3)}
    ins = {l: [e for ct in lvl[l] for e in par.shard_ciphertext(
        ct, mesh[limb]).elements] for l, limb in ((1, 2), (3, 4))}
    gather = lambda parts, m: [par.unshard(p, m, ROWS) for p in parts]
    equal = lambda got, ref: all(torch.equal(g, w)
                                 for g, w in zip(got, ref))
    out1, per1 = count_launches(
        lambda: sf.mult_relin_sharded(*ins[1], st[1], mesh[2]), names)
    out3, per3 = count_launches(
        lambda: sf.mult_relin_sharded(*ins[3], st[3], mesh[4]), names)
    same["EvalMult level 1, limb 2"] = equal(gather(out1, mesh[2]),
                                             want[1].elements)
    g3 = gather(out3, mesh[4])
    same["EvalMult level 3, limb 4"] = equal(g3, want[3].elements)
    same["portable body, level 1, limb 2"] = equal(gather(
        shd.mult_relin_sharded(*ins[1], st[1], mesh[2]), mesh[2]),
        want[1].elements)
    # the two-level chain: level 3, in-region rescale, level 4 padded
    k3, k4 = cc.size_ql(3), cc.size_ql(4)
    dt3 = shd.make_sharded_drop_tables(cc, k3)
    resc = [shd.drop_last_and_scale_sharded(p, dt3, k3 - 1, mesh[4])
            for p in out3]
    st4 = sf.make_sharded_fused_tables(cc, k4, pad_to=k3)
    out4 = sf.mult_relin_sharded(*resc, *resc, st4, mesh[4])
    want_r = cc.Rescale(want[3])
    want4 = cc.EvalMult(want_r, want_r)
    padded = lambda got, ref: all(torch.equal(g[:k4], w) and not g[k4:].any()
                                  for g, w in zip(got, ref))
    same["in-region rescale, level 3 -> 4"] = padded(gather(resc, mesh[4]),
                                                     want_r.elements)
    same[f"EvalMult level 4 ({k4} rows padded to {k3}), limb 4"] = padded(
        gather(out4, mesh[4]), want4.elements)
    # dp 2 x limb 2: the pairs (a, b) and (c, b) at level 1
    c1 = cc.LevelReduce(ct_c, 1)
    spec = ("dp", "limb", None)
    pairs = [par.shard(torch.stack([u, v]), mesh["2x2"], spec)
             for u, v in zip(lvl[1][0].elements + lvl[1][1].elements,
                             c1.elements + lvl[1][1].elements)]
    outb = sf.mult_relin_sharded(*pairs, st[1], mesh["2x2"])
    want_c = cc.EvalMult(c1, lvl[1][1])
    gb = [par.unshard(p, mesh["2x2"], spec) for p in outb]
    same["dp 2 x limb 2, two pairs"] = all(
        torch.equal(g[0], w0) and torch.equal(g[1], w1)
        for g, w0, w1 in zip(gb, want[1].elements, want_c.elements))
    if torch.cuda.device_count() >= 2:
        two = par.Mesh([[torch.device("cuda", 0), torch.device("cuda", 1)]])
        ab = [e for ct in lvl[1] for e in par.shard_ciphertext(
            ct, two).elements]
        same["two cards, level 1, limb 2"] = equal(
            gather(sf.mult_relin_sharded(*ab, st[1], two), two),
            want[1].elements)
    else:
        print("multi-card check not run: 1 card visible")
    launches = {k: _build.LAUNCHES[k] for k in names}
    path_s = time.perf_counter() - t0
    # decryption of the rescaled level-3 product
    prod3 = dataclasses.replace(want[3], elements=tuple(g3))
    dec3 = np.asarray(cc.Decrypt(sk, cc.Rescale(prod3)).values).real
    mult_err = float(np.abs(dec3 - dec_ab).max())
    print(f"sharded path: {path_s:.2f} s; launches {launches}")
    print(f"per sharded EvalMult limb 2 {per1}; limb 4 {per3}; per sharded "
          f"NTT {per_ntt}")
    print(f"sharded == single card: {same}")
    print(f"Rescale(sharded level-3 product): max |dec - dec(a)*dec(b)| = "
          f"{mult_err:.3e} (limit {MULT_TOL})")
    require(all(same.values()), f"the sharded path differs: {same}")
    require(mult_err <= MULT_TOL, f"sharded EvalMult+Rescale error "
            f"{mult_err} above {MULT_TOL}")
    for limb, got in ((2, per1), (4, per3)):
        want_l = {k: limb * (k in SHARDED_CHAIN) for k in names}
        require(got == want_l, f"sharded EvalMult launches {got}, expected "
                f"{want_l}")
    for limb, got in per_ntt.items():
        want_l = {k: 2 * limb * (k == "mod_matmul") for k in names}
        require(got == want_l, f"sharded NTT launches {got}, expected "
                f"{want_l}")
    require(all(launches[k] > 0 for k in SHARDED
                if k not in SHARDED_STAGED),
            f"a kernel was not launched on the sharded path: {launches}")
    require(not any(launches[k] for k in SHARDED_STAGED),
            f"the sharded path ran a former form: {launches}")

    b = cc.basis_q
    times = {
        "sharded_evalmult_level1_limb2_ms": cuda_ms(
            lambda: sf.mult_relin_sharded(*ins[1], st[1], mesh[2]), reps=10),
        "evalmult_level1_ms": cuda_ms(lambda: cc.EvalMult(*lvl[1]), reps=10),
        "sharded_evalmult_level3_limb4_ms": cuda_ms(
            lambda: sf.mult_relin_sharded(*ins[3], st[3], mesh[4]), reps=10),
        "evalmult_level3_ms": cuda_ms(lambda: cc.EvalMult(*lvl[3]), reps=10),
        "portable_evalmult_level1_limb2_ms": cuda_ms(
            lambda: shd.mult_relin_sharded(*ins[1], st[1], mesh[2]), reps=10),
        "ntt_cu_fwd_ms": cuda_ms(lambda: ntt._ntt_fwd_cu(x, b), reps=10),
        "ntt_cu_inv_ms": cuda_ms(lambda: ntt._ntt_inv_cu(y, b), reps=10),
        "ntt_fwd_4step_ms": cuda_ms(lambda: ntt4step.ntt_fwd_4step(x, b),
                                    reps=10),
        "ntt_inv_4step_ms": cuda_ms(lambda: ntt4step.ntt_inv_4step(y, b),
                                    reps=10),
    }
    for limb in LIMBS:
        times[f"ntt_fwd_sharded_limb{limb}_ms"] = cuda_ms(
            lambda: ns.ntt_fwd_sharded(x, b, mesh[limb]), reps=10)
        times[f"ntt_inv_sharded_limb{limb}_ms"] = cuda_ms(
            lambda: ns.ntt_inv_sharded(y, b, mesh[limb]), reps=10)
    print(f"sharded op times (median of 10, CUDA events, {card}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    for name, rows in cases.items():
        for case in rows:
            extra = "" if "staged_ms" not in case else (
                f"(call {case['call_ms']:.4f})  {case['former']} "
                f"{case['staged_ms']:.4f} ms (call "
                f"{case['staged_call_ms']:.4f})  ")
            print(f"  {name:20s} {str(case['shape']):22s} {case['moduli']} "
                  f"kernel {case['ms']:.4f} ms  {extra}plain "
                  f"{case['plain_ms']:.4f} ms  bound {case['bound_ms']:.4f}"
                  f" ms ({case['bound_by']})  max_abs_err "
                  f"{case['max_abs_err']}")
    phase_s = time.perf_counter() - t_phase
    print(f"sharded phase: {phase_s:.1f} s ({kernel_s:.1f} s kernel cases)")
    return dict(cases=cases, launches=launches, per_mult=per3,
                per_mult_limb2=per1, per_ntt=per_ntt[4], same=same,
                mult_err=mult_err, times=times, seconds=phase_s)


def unfused_view(cc):
    """The same context (keys, caches, generator shared) with every level's
    hybrid tables stripped of their fused ones, as phase 4 builds its
    oracle: EvalMult and every key switch run the unfused chain."""
    view = copy.copy(cc)
    tables = cc.hybrid_tables
    view.hybrid_tables = lambda size_ql: dataclasses.replace(
        tables(size_ql), fused=None)
    return view


def cpu_twin(cc, seed):
    """The port's plain path: a CPU context of cc's parameters with cc's
    eval keys (without companions), and a function moving ciphertexts."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch.pke.keys import EvalKey
    cpu = fhe.GenCryptoContext(dataclasses.replace(cc.params), seed=seed,
                               device="cpu")
    on_cpu_key = lambda ek: EvalKey(bv=ek.bv.cpu(), av=ek.av.cpu(),
                                    key_tag=ek.key_tag)
    for tag, ek in cc.eval_mult_keys.items():
        cpu.eval_mult_keys[tag] = on_cpu_key(ek)
    for tag, keys in cc.eval_automorphism_keys.items():
        cpu.InsertEvalAutomorphismKey(
            {g: on_cpu_key(ek) for g, ek in keys.items()}, tag)
    on_cpu = lambda ct: dataclasses.replace(
        ct, elements=tuple(e.cpu() for e in ct.elements))
    return cpu, on_cpu


def same_ct(x, y) -> bool:
    """Equal words and equal level, noise degree and scale."""
    return same_words(x, y) and (x.level, x.noise_deg, x.scale) == (
        y.level, y.noise_deg, y.scale)


def leveled_ops(cc, cts, pt_w) -> dict:
    """(a)1's ops on one context: cts are MERGE fresh ciphertexts, pt_w a
    plaintext at level 0."""
    x, y = cts[0], cts[1]
    resc = cc.Rescale(cc.EvalMult(x, y))
    return {
        "EvalSub": cc.EvalSub(x, y),
        "EvalNegate": cc.EvalNegate(x),
        "EvalAdd scalar": cc.EvalAdd(x, 0.25),
        "EvalSub scalar": cc.EvalSub(x, 0.125),
        "EvalMult scalar": cc.EvalMult(x, -0.75),
        "EvalAdd plaintext": cc.EvalAdd(x, pt_w),
        "EvalSub plaintext": cc.EvalSub(x, pt_w),
        "EvalMult plaintext": cc.EvalMult(x, pt_w),
        "EvalSquare": cc.EvalSquare(x),
        "EvalMultAndRelinearize": cc.EvalMultAndRelinearize(x, y),
        "EvalLinearWSum 4": cc.EvalLinearWSum(cts[:4], list(WSUM)),
        f"EvalMerge {MERGE}": cc.EvalMerge(cts),
        "EvalAdd (1, 2) + (0, 1)": cc.EvalAdd(cc.EvalSquare(resc), x),
        "Compress": cc.Compress(cc.EvalMult(x, y), 3),
    }


def leveled_want(zs, w) -> dict:
    """What each op of `leveled_ops` computes, on the slot vectors."""
    x, y = zs[0], zs[1]
    merged = np.zeros_like(x)
    merged[:MERGE] = [z[0] for z in zs]
    return {"EvalSub": x - y, "EvalNegate": -x, "EvalAdd scalar": x + 0.25,
            "EvalSub scalar": x - 0.125, "EvalMult scalar": -0.75 * x,
            "EvalAdd plaintext": x + w, "EvalSub plaintext": x - w,
            "EvalMult plaintext": x * w, "EvalSquare": x * x,
            "EvalMultAndRelinearize": x * y,
            "EvalLinearWSum 4": sum(c * z for c, z in zip(WSUM, zs)),
            f"EvalMerge {MERGE}": merged,
            "EvalAdd (1, 2) + (0, 1)": (x * y) ** 2 + x,
            "Compress": x * y}


def mult_chain(cc, x, y) -> list:
    """EvalMult by y and Rescale from x's level down to the chain's last
    level, then a scalar add: every product, the sum last."""
    out = [x]
    while out[-1].level + 1 < len(cc.scf_real):
        out.append(cc.Rescale(cc.EvalMult(out[-1], y)))
    out.append(cc.EvalAdd(out[-1], CHAIN_ADD))
    return out[1:]


def cheb_error(func, a, b, degree) -> float:
    """Largest error of the degree-`degree` Chebyshev interpolant of func
    on [a, b] (the coefficients the evaluators use, in numpy), on a grid
    of 20001 points."""
    from openfhe_tpu_torch.math.chebyshev import eval_chebyshev_coefficients
    c = np.array(eval_chebyshev_coefficients(func, a, b, degree))
    c[0] /= 2.0
    x = np.linspace(a, b, 20001)
    approx = np.polynomial.chebyshev.chebval(2 * (x - a) / (b - a) - 1, c)
    return float(np.abs(approx - np.vectorize(func)(x)).max())


def deepest_start(cc, out0) -> int:
    """The deepest level a call that took out0 from level 0 can start at
    and still leave LEVEL_SPARE_BITS above the result's scale."""
    used = out0.level
    for start in range(len(cc.scf_real) - 1 - used, -1, -1):
        bits = sum(math.log2(q) for q in
                   cc.moduli_q[:cc.size_ql(start + used)])
        if bits >= math.log2(out0.scale) + LEVEL_SPARE_BITS:
            return start
    return 0


def leveled_phase(card, gen, names, cases, staged) -> dict:
    """The leveled CKKS layer (see the module docstring, phase 7); raises
    on any fault. Appends the kernel cases of (c) to `cases` / `staged`."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.pke import advanced
    from openfhe_tpu_torch.pke.keyswitch import ks_fused
    from openfhe_tpu_torch.pke.parameters import main_path_params
    from openfhe_tpu_torch.trace_evalmult import time_encodes
    t_phase = time.perf_counter()
    T = fhe.ScalingTechnique
    rng = np.random.default_rng(LEVELED_SEED)
    res = {"errors": {}, "limits": {}, "same": {}}

    def check(label, got, want, limit):
        err = float(np.abs(np.asarray(got)[:len(want)] - want).max())
        res["errors"][label], res["limits"][label] = err, limit
        require(np.isfinite(err) and err <= limit,
                f"{label}: decryption error {err:.3e} above {limit:.1e}")

    # (a) FLEXIBLEAUTO at the main path's widths. Each of (a), (b) and (c)
    # is counted from its context's creation to its last fused op; the
    # oracles (the unfused chain, the CPU plain path, the kernel cases)
    # run outside those windows.
    launches = collections.Counter()
    _build.LAUNCHES.clear()
    params = dataclasses.replace(main_path_params(),
                                 scaling_technique=T.FLEXIBLEAUTO)
    cc = fhe.GenCryptoContext(params, seed=LEVELED_SEED)
    kp = cc.KeyGen()
    sk = kp.secret_key
    cc.EvalMultKeyGen(sk)
    cc.EvalRotateKeyGen(sk, [-i for i in range(1, MERGE)])
    require((len(cc.moduli_q), len(cc.moduli_p)) == (31, 16)
            and cc.hybrid_tables(cc.size_ql(0)).fused is not None,
            "unexpected FLEXIBLEAUTO chain or no fused tables")
    encodes = time_encodes(cc)
    zs = [rng.uniform(-Z_MAX, Z_MAX, cc.slots) for _ in range(MERGE)]
    w = rng.uniform(-Z_MAX, Z_MAX, cc.slots)
    cts = [cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(z))
           for z in zs]
    pt_w = cc.MakeCKKSPackedPlaintext(w)

    # (a)1: the leveled ops
    fused, per_ops = count_launches(lambda: leveled_ops(cc, cts, pt_w),
                                    names)

    # (a)2 and (a)3: the function evaluations
    u = rng.uniform(-1.0, 1.0, cc.slots)
    v = rng.uniform(LOGISTIC_WIDE[0], LOGISTIC_WIDE[1], cc.slots)
    ct_u = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(u))
    ct_v = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(v))
    sigmoid = lambda t: 1.0 / (1.0 + np.exp(-t))
    res["calls"], calls = {}, []

    def run_call(label, fn, ct, want_vals, limit):
        before = dict(encodes)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, per = count_launches(lambda: fn(cc, ct), names)
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end)
        enc_ms = (encodes["s"] - before["s"]) * 1e3
        n_enc = encodes["n"] - before["n"]
        calls.append((label, fn, ct, out, want_vals, limit))
        res["calls"][label] = dict(
            wall_ms=wall, encode_ms=enc_ms, encodes=n_enc,
            host_encode_share=enc_ms / wall, level_in=ct.level,
            level_out=out.level, noise_deg=out.noise_deg,
            launches={k: v for k, v in per.items() if v})
        print(f"{label}: wall {wall:.1f} ms (CUDA events, {card}); "
              f"{n_enc} encodes {enc_ms:.1f} ms on the host "
              f"({enc_ms / wall:.0%} of the wall); level {ct.level} -> "
              f"{out.level}, noise degree {out.noise_deg}; launches "
              f"{res['calls'][label]['launches']}")
        return out

    for func, fname, f in ((advanced.logistic, "EvalLogistic", sigmoid),
                           (math.sin, "EvalSin", np.sin)):
        approx = cheb_error(func, -1.0, 1.0, FUNC_DEGREE)
        run_call(f"{fname} [-1, 1] degree {FUNC_DEGREE}",
                 lambda c, ct, fname=fname: getattr(c, fname)(
                     ct, -1.0, 1.0, FUNC_DEGREE),
                 ct_u, f(u), approx + FUNC_NOISE[fname])
    a, b, degree = LOGISTIC_WIDE
    approx = cheb_error(advanced.logistic, a, b, degree)
    wide = lambda c, ct: c.EvalLogistic(ct, a, b, degree)
    out0 = run_call(f"EvalLogistic [-8, 8] degree {degree}", wide, ct_v,
                    sigmoid(v), approx + FUNC_NOISE["EvalLogistic wide"])
    res["deepest_level"] = deep = deepest_start(cc, out0)
    ct_deep = cc.Encrypt(kp.public_key,
                         cc.MakeCKKSPackedPlaintext(v, level=deep))
    run_call(f"EvalLogistic [-8, 8] degree {degree} from level {deep}",
             wide, ct_deep, sigmoid(v),
             approx + FUNC_NOISE["EvalLogistic wide"])
    torch.cuda.synchronize()
    launches.update({k: _build.LAUNCHES[k] for k in names})
    print(f"deepest start of the degree-{LOGISTIC_WIDE[2]} logistic: level "
          f"{res['deepest_level']} of {len(cc.scf_real) - 1}")

    # (a)'s oracles: three ways for (a)1, fused == unfused for (a)2, (a)3
    decv = lambda ct: np.asarray(cc.Decrypt(sk, ct).values).real
    unf = unfused_view(cc)
    plain_card = leveled_ops(unf, cts, pt_w)
    t0 = time.perf_counter()
    cpu, on_cpu = cpu_twin(cc, LEVELED_SEED)
    on_cpu_cts = [on_cpu(ct) for ct in cts]
    plain_cpu = leveled_ops(cpu, on_cpu_cts, cpu.MakeCKKSPackedPlaintext(w))
    cpu_s = time.perf_counter() - t0
    want = leveled_want(zs, w)
    for op, ct in fused.items():
        res["same"][f"(a)1 {op}: fused == unfused"] = same_ct(
            ct, plain_card[op])
        res["same"][f"(a)1 {op}: card == CPU"] = same_ct(ct, plain_cpu[op])
        check(f"(a)1 {op}", decv(ct), want[op], LEVELED_LIMITS[op])
    print(f"(a)1 leveled ops: launches {per_ops}; CPU plain path "
          f"{cpu_s:.1f} s")
    del cpu, on_cpu_cts, plain_cpu
    for label, fn, ct, out, want_vals, limit in calls:
        res["same"][f"{label}: fused == unfused"] = same_ct(out,
                                                           fn(unf, ct))
        check(label, decv(out), want_vals, limit)
    del cc, unf, cts, fused, plain_card, calls
    torch.cuda.empty_cache()

    # (b) FIXEDAUTO, depth 6: the x1 plaintext multiply
    def fixed_auto():
        params_b = dataclasses.replace(main_path_params(), mult_depth=6,
                                       scaling_technique=T.FIXEDAUTO)
        cb = fhe.GenCryptoContext(params_b, seed=LEVELED_SEED)
        kb = cb.KeyGen()
        cb.EvalMultKeyGen(kb.secret_key)
        xb, yb = (cb.Encrypt(kb.public_key, cb.MakeCKKSPackedPlaintext(z))
                  for z in zs[:2])
        deg2 = cb.EvalMult(cb.EvalMult(xb, yb), xb)
        return cb, kb, xb, yb, deg2, cb.EvalAdd(deg2, xb)

    (cb, kb, xb, yb, deg2, summed), per_b = count_launches(fixed_auto,
                                                           names)
    launches.update(per_b)
    require((deg2.level, deg2.noise_deg, summed.level, summed.noise_deg)
            == (1, 2, 1, 2), "(b): unexpected levels or degrees")
    cpu, on_cpu = cpu_twin(cb, LEVELED_SEED)
    deg2_cpu = cpu.EvalMult(cpu.EvalMult(on_cpu(xb), on_cpu(yb)),
                            on_cpu(xb))
    res["same"]["(b) [1, 2] operand: card == CPU"] = same_ct(deg2, deg2_cpu)
    res["same"]["(b) x1 multiply add: card == CPU"] = same_ct(
        summed, cpu.EvalAdd(deg2_cpu, on_cpu(xb)))
    check("(b) FIXEDAUTO [1, 2] + [0, 1]",
          np.asarray(cb.Decrypt(kb.secret_key, summed).values).real,
          zs[0] ** 2 * zs[1] + zs[0], LEVELED_LIMITS["FIXEDAUTO x1"])
    del cb, cpu
    torch.cuda.empty_cache()

    # (c) the chains the kernels had not run on
    for tech, depth, kw in CHAINS:
        y_vals = rng.uniform(1.0 - CHAIN_SPREAD, 1.0 + CHAIN_SPREAD,
                             len(zs[0]))

        def chain_run(tech=tech, depth=depth, kw=kw, y_vals=y_vals):
            pc = dataclasses.replace(main_path_params(), mult_depth=depth,
                                     scaling_technique=T[tech], **kw)
            c3 = fhe.GenCryptoContext(pc, seed=LEVELED_SEED)
            k3 = c3.KeyGen()
            c3.EvalMultKeyGen(k3.secret_key)
            x3 = c3.Encrypt(k3.public_key,
                            c3.MakeCKKSPackedPlaintext(zs[0]))
            y3 = c3.Encrypt(k3.public_key,
                            c3.MakeCKKSPackedPlaintext(y_vals))
            return c3, k3, x3, y3, mult_chain(c3, x3, y3)

        (c3, k3, x3, y3, chain), per_c = count_launches(chain_run, names)
        launches.update(per_c)
        chain_u = mult_chain(unfused_view(c3), x3, y3)
        label = (f"(c) {tech} N=2^{c3.ring_dim.bit_length() - 1}, depth "
                 f"{depth}: {len(c3.moduli_q)} Q + {len(c3.moduli_p)} P "
                 "towers")
        res["same"][f"{label}: fused == unfused"] = all(
            same_ct(a, b) for a, b in zip(chain, chain_u))
        want_c = zs[0] * y_vals ** (len(chain) - 1) + CHAIN_ADD
        check(label, np.asarray(c3.Decrypt(k3.secret_key,
                                           chain[-1]).values).real,
              want_c, LEVELED_LIMITS[tech])
        print(f"{label}: moduli bits "
              f"{[q.bit_length() for q in c3.moduli_q]}, P "
              f"{[q.bit_length() for q in c3.moduli_p]}; "
              f"{len(chain) - 1} products to level {chain[-1].level}; "
              f"launches {dict((k, n) for k, n in per_c.items() if n)}")
        tabs = c3.hybrid_tables(c3.size_ql(0)).fused
        key = rand_key(gen, list(c3.moduli_q) + list(c3.moduli_p),
                       c3.ring_dim)
        for name, case in fused_cases(ks_fused, tabs, key, gen,
                                      f"{tech} level 0 ({tabs.kql} Q + "
                                      f"{tabs.kp} P)"):
            (staged if name in STAGED else cases)[name].append(case)
        del c3, chain, chain_u, tabs, key
        torch.cuda.empty_cache()

    # the fused runs' own launches, summed over (a), (b) and (c)
    res["launches"] = launches = {k: launches[k] for k in names}
    path = ("ntt_fwd", "ntt_inv", "tensor_intt", "conv_digits",
            "ntt_keymul_acc", "intt_conv_p", "ntt_submul_final",
            "intt_scale", "ntt_subscale")
    print(f"leveled path launches (rows a-h, j; fused runs only): "
          f"{ {k: launches[k] for k in path} }; others "
          f"{ {k: v for k, v in launches.items() if k not in path and v} }")
    require(all(launches[k] > 0 for k in path),
            f"a kernel of rows a-h, j was not launched: {launches}")
    require(not any(launches[k] for k in STAGED),
            f"the leveled path ran a staged form: {launches}")
    print(f"leveled phase decryption errors (limit): "
          + ", ".join(f"{k} {v:.3e} ({res['limits'][k]:.1e})"
                      for k, v in res["errors"].items()))
    print(f"leveled phase words equal: {res['same']}")
    require(all(res["same"].values()),
            f"leveled phase words differ: "
            f"{[k for k, v in res['same'].items() if not v]}")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"leveled phase: {res['seconds']:.1f} s")
    return res


def rows_rolled(vals, r: int) -> np.ndarray:
    """EvalRotate(r) of packed slots: each of the two rows of N / 2 slots
    turns left by r."""
    h = len(vals) // 2
    return np.concatenate([np.roll(vals[:h], -r), np.roll(vals[h:], -r)])


def ext_ladder(cc, ct) -> dict:
    """EvalFastRotationExt of ct over EXT_ROTS on one set of hoisted
    digits, summed by EvalAddExt, then one KeySwitchDown (and its first
    element alone)."""
    digits = cc.EvalFastRotationPrecompute(ct)
    terms = [cc.EvalFastRotationExt(ct, r, digits) for r in EXT_ROTS]
    acc = terms[0]
    for term in terms[1:]:
        acc = cc.EvalAddExt(acc, term)
    return dict(terms=terms, sum=acc, down=cc.KeySwitchDown(acc),
                first=cc.KeySwitchDownFirstElement(acc))


def integer_phase(card, gen, names, cases, staged, ckks) -> dict:
    """The integer schemes and the extended basis (see the module
    docstring, phase 8); raises on any fault. `ckks` holds phase 4's
    context, secret key and level-0 product. Appends the K6 / K6f cases
    with t to `cases` / `staged`."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.pke import parameters as prm
    from openfhe_tpu_torch.pke.constants import (EncryptionTechnique,
                                                 KeySwitchTechnique,
                                                 MultiplicationTechnique)
    from openfhe_tpu_torch.pke.keyswitch import ks_fused
    from openfhe_tpu_torch.trace_evalmult import OWN
    t_phase = time.perf_counter()
    rng = np.random.default_rng(INT_SEED)
    res = {"exact": {}, "same": {}, "per_mult": {}, "errors": {},
           "seconds": {}}
    launches = collections.Counter()

    def counted_window(fn):
        """fn() from a cleared counter; its launches join the phase's."""
        _build.LAUNCHES.clear()
        out = fn()
        torch.cuda.synchronize()
        launches.update({k: _build.LAUNCHES[k] for k in names})
        return out

    def exact(label, cc, sk, ct, want):
        t = cc.plaintext_modulus
        got = np.asarray(cc.Decrypt(sk, ct).values)[:len(want)]
        res["exact"][label] = ok = bool(np.array_equal(np.mod(got, t),
                                                       np.mod(want, t)))
        require(ok, f"{label}: decryption differs from numpy mod t")

    def own_kernels(label, fn, want):
        kernels = device_kernels(fn, want)
        own = [k for k in kernels
               if any(f"{o}(" in k or f"{o}<" in k for o in OWN)]
        print(f"{label} on the card: {len(kernels)} device kernels, "
              f"{len(own)} of csrc/")
        require(len(kernels) == want == len(own),
                f"{label} ran {len(kernels)} device kernels ({len(own)} of "
                f"csrc/), expected {want}, all of csrc/")

    # (a) BGV at bench_bfvbgv's widths
    t0 = time.perf_counter()
    bgv_params = prm.bgv_bench_params()

    def bgv_run():
        cc = fhe.GenCryptoContext(bgv_params, seed=INT_SEED)
        kp = cc.KeyGen()
        cc.EvalMultKeyGen(kp.secret_key)
        cc.EvalRotateKeyGen(kp.secret_key, [1, -1])
        n, t = cc.ring_dim, cc.plaintext_modulus
        vals = [rng.integers(0, t, n) for _ in range(3)]
        x, y, z = (cc.Encrypt(kp.public_key, cc.MakePackedPlaintext(v))
                   for v in vals)
        pt_w = cc.MakePackedPlaintext(vals[2])
        prod, per = count_launches(lambda: cc.EvalMult(x, y), names)
        chain = [prod, cc.EvalMult(prod, z)]      # each a ModReduce first
        chain.append(cc.EvalMult(chain[1], x))
        ops = {"EvalMult": prod, "EvalMult plaintext": cc.EvalMult(x, pt_w),
               "EvalAdd": cc.EvalAdd(prod, z), "EvalMult x3": chain[2],
               "ModReduce": cc.ModReduce(chain[2]),
               "EvalRotate +1": cc.EvalRotate(x, 1),
               "EvalRotate -1 at level 2": cc.EvalRotate(chain[1], -1)}
        return cc, kp, vals, (x, y, z), ops, chain, per

    cc, kp, vals, (x, y, z), ops, chain, per_bgv = counted_window(bgv_run)
    sk = kp.secret_key
    t = cc.plaintext_modulus
    tabs0 = cc.hybrid_tables(cc.size_ql(0))
    require((len(cc.moduli_q), len(cc.moduli_p), len(tabs0.parts))
            == (21, 7, 3) and tabs0.fused is not None
            and not tabs0.fused.t_is_one,
            "unexpected BGV chain or fused tables without t")
    u, v, w = vals
    want = {"EvalMult": u * v, "EvalMult plaintext": u * w,
            "EvalAdd": u * v + w, "EvalMult x3": u * v % t * w % t * u,
            "ModReduce": u * v % t * w % t * u,
            "EvalRotate +1": rows_rolled(u, 1),
            "EvalRotate -1 at level 2": rows_rolled(u * v % t * w % t, -1)}
    for op, out in ops.items():
        exact(f"(a) BGV {op}", cc, sk, out, want[op])
    unf = unfused_view(cc)
    chain_u = [unf.EvalMult(x, y)]
    chain_u += [unf.EvalMult(chain_u[0], z)]
    chain_u += [unf.EvalMult(chain_u[1], x)]
    for i, (a, b) in enumerate(zip(chain, chain_u)):
        res["same"][f"(a) BGV EvalMult {i + 1}: fused == unfused"] = (
            same_words(a, b) and a.scale_int == b.scale_int)
    res["same"]["(a) BGV EvalRotate +1: fused == unfused"] = same_words(
        ops["EvalRotate +1"], unf.EvalRotate(x, 1))
    want_mult = {k: int(k in MULT_CHAIN) for k in names}
    require(per_bgv == want_mult,
            f"BGV EvalMult launches {per_bgv}, expected {want_mult}")
    res["per_mult"]["bgv"] = per_bgv
    own_kernels("BGV EvalMult", lambda: cc.EvalMult(x, y), MULT_KERNELS)
    # K6 and K6f with t = 65537 at level 0 and a lower level, each beside
    # its twin and its staged form
    key = rand_key(gen, list(cc.moduli_q) + list(cc.moduli_p), cc.ring_dim)
    for lvl in (0, 4):
        tabs = cc.hybrid_tables(cc.size_ql(lvl)).fused
        for name, case in fused_cases(
                ks_fused, tabs, key, gen,
                f"BGV level {lvl} ({tabs.kql} Q + {tabs.kp} P), t = {t}",
                ("ntt_subscale", "ntt_submul_final")):
            (staged if name in STAGED else cases)[name].append(case)
            print(f"  {name:24s} {str(case['shape']):18s} {case['moduli']}:"
                  f" kernel {case['ms']:.4f} ms  plain {case['plain_ms']:.4f}"
                  f" ms  bound {case['bound_ms']:.4f} ms ({case['bound_by']})"
                  f"  max_abs_err {case['max_abs_err']}")
    res["seconds"]["bgv"] = time.perf_counter() - t0
    del cc, unf, ops, chain, chain_u, key, x, y, z
    torch.cuda.empty_cache()

    # (b) BFV at bench_bfvbgv's widths, HPSPOVERQLEVELED and EXTENDED
    t0 = time.perf_counter()
    bfv_params = prm.bfv_bench_params()
    leveled = dataclasses.replace(
        bfv_params, mult_depth=BFV_LEVELED_DEPTH,
        multiplication_technique=MultiplicationTechnique.HPSPOVERQLEVELED)
    extended = dataclasses.replace(
        bfv_params, encryption_technique=EncryptionTechnique.EXTENDED)

    def bfv_run():
        out = {}
        for label, params in (("HPS", bfv_params),
                              ("HPSPOVERQLEVELED", leveled),
                              ("EXTENDED", extended)):
            cb = fhe.GenCryptoContext(params, seed=INT_SEED)
            kb = cb.KeyGen()
            cb.EvalMultKeyGen(kb.secret_key)
            n, t = cb.ring_dim, cb.plaintext_modulus
            vb = [rng.integers(0, t, n) for _ in range(3)]
            cts = [cb.Encrypt(kb.public_key, cb.MakePackedPlaintext(a))
                   for a in vb]
            prod, per = count_launches(lambda: cb.EvalMult(cts[0], cts[1]),
                                       names)
            chain = [prod, cb.EvalMult(prod, cts[2])]
            if label == "HPSPOVERQLEVELED":
                chain.append(cb.EvalMult(chain[-1], cts[1]))
            out[label] = (cb, kb, vb, cts, chain, per)
        return out

    bfv = counted_window(bfv_run)
    for label, (cb, kb, vb, cts, chain, per) in bfv.items():
        t = cb.plaintext_modulus
        wants = [vb[0] * vb[1] % t, vb[0] * vb[1] % t * vb[2] % t,
                 vb[0] * vb[1] % t * vb[2] % t * vb[1]]
        for i, out in enumerate(chain):
            exact(f"(b) BFV {label} EvalMult {i + 1}", cb, kb.secret_key,
                  out, wants[i])
        if label == "HPSPOVERQLEVELED":
            from openfhe_tpu_torch.pke.schemes import bfv as bfv_mod
            drops = [bfv_mod._find_levels_to_drop(cb, d)
                     for d in range(len(chain))]
            print(f"(b) BFV HPSPOVERQLEVELED depth {BFV_LEVELED_DEPTH}: "
                  f"{len(cb.moduli_q)} Q towers, towers dropped before each "
                  f"product {drops}")
            require(max(drops) > 0, "HPSPOVERQLEVELED dropped no tower")
    cb, kb, vb, cts, chain, per_bfv = bfv["HPS"]
    require((len(cb.moduli_q), len(cb.moduli_p)) == (6, 2),
            "unexpected BFV chain")
    unf = unfused_view(cb)
    tensor = cb.EvalMultNoRelin(cts[0], cts[1])
    res["same"]["(b) BFV Relinearize: fused == unfused"] = same_words(
        cb.Relinearize(tensor), unf.Relinearize(tensor))
    res["same"]["(b) BFV EvalMult 2: fused == unfused"] = same_words(
        chain[1], unf.EvalMult(chain[0], cts[2]))
    want_bfv = {k: 0 for k in names}
    want_bfv.update(ntt_fwd=2, ntt_inv=3, mod_matmul_rowmod=3,
                    **{k: 1 for k in KS_CHAIN})
    require(per_bfv == want_bfv,
            f"BFV EvalMult launches {per_bfv}, expected {want_bfv}")
    res["per_mult"]["bfv"] = per_bfv
    res["seconds"]["bfv"] = time.perf_counter() - t0
    del bfv, cb, unf, tensor, chain, cts
    torch.cuda.empty_cache()

    # (c) BV key switching on the BGV chain (digit_size 0: a digit a tower,
    # each extended by one conversion)
    t0 = time.perf_counter()
    bv_params = dataclasses.replace(bgv_params,
                                    ks_technique=KeySwitchTechnique.BV,
                                    digit_size=0)

    def bv_run():
        cv = fhe.GenCryptoContext(bv_params, seed=INT_SEED)
        kv = cv.KeyGen()
        cv.EvalMultKeyGen(kv.secret_key)
        cv.EvalRotateKeyGen(kv.secret_key, [1])
        n, t = cv.ring_dim, cv.plaintext_modulus
        vv = [rng.integers(0, t, n) for _ in range(2)]
        xv, yv = (cv.Encrypt(kv.public_key, cv.MakePackedPlaintext(a))
                  for a in vv)
        prod, per = count_launches(lambda: cv.EvalMult(xv, yv), names)
        return cv, kv, vv, prod, cv.EvalRotate(xv, 1), per

    cv, kv, vv, prod_v, rot_v, per_bv = counted_window(bv_run)
    require(cv.moduli_p == [] and len(cv.moduli_q) == 21,
            "unexpected BV chain")
    t = cv.plaintext_modulus
    exact("(c) BV EvalMult", cv, kv.secret_key, prod_v, vv[0] * vv[1])
    exact("(c) BV EvalRotate +1", cv, kv.secret_key, rot_v,
          rows_rolled(vv[0], 1))
    kq = len(cv.moduli_q)
    want_bv = {k: 0 for k in names}
    want_bv.update(ntt_fwd=kq, ntt_inv=kq, mod_matmul_rowmod=kq)
    require(per_bv == want_bv,
            f"BV EvalMult launches {per_bv}, expected {want_bv}")
    res["per_mult"]["bv"] = per_bv
    res["seconds"]["bv"] = time.perf_counter() - t0
    del cv, prod_v, rot_v
    torch.cuda.empty_cache()

    # (d) the extended basis on phase 4's context (N=2^16, L=30)
    t0 = time.perf_counter()
    cm, skm, prod = ckks["cc"], ckks["sk"], ckks["prod"]
    cm.EvalRotateKeyGen(skm, list(EXT_ROTS))
    ladder = counted_window(lambda: ext_ladder(cm, prod))
    decv = lambda c: np.asarray(cm.Decrypt(skm, c).values)
    got = decv(cm.Rescale(ladder["down"]))
    rot_sum = sum(decv(cm.Rescale(cm.EvalRotate(prod, r)))
                  for r in EXT_ROTS)
    base = decv(cm.Rescale(prod))
    roll_sum = sum(np.roll(base, -r) for r in EXT_ROTS)
    res["errors"]["(d) ladder vs sum of EvalRotate"] = e1 = float(
        np.abs(got - rot_sum).max())
    res["errors"]["(d) ladder vs rotated dec(Rescale(prod))"] = e2 = float(
        np.abs(got - roll_sum).max())
    require(max(e1, e2) <= EXT_SUM_TOL,
            f"extended-basis ladder error {e1:.3e} / {e2:.3e} above "
            f"{EXT_SUM_TOL}")
    res["same"]["(d) KeySwitchDownFirstElement == KeySwitchDown[0]"] = (
        torch.equal(ladder["first"], ladder["down"].elements[0]))
    res["same"]["(d) metadata ext_basis"] = (
        ladder["sum"].GetMetadataByKey("ext_basis") is True
        and ladder["down"].GetMetadataByKey("ext_basis") is False)
    low = cm.LevelReduce(prod, EXT_CPU_LEVEL)
    card_low = ext_ladder(cm, low)
    cpu, on_cpu = cpu_twin(cm, 7)
    cpu_low = ext_ladder(cpu, on_cpu(low))
    for key in ("sum", "down"):
        res["same"][f"(d) level {EXT_CPU_LEVEL} {key}: card == CPU"] = (
            same_words(card_low[key], cpu_low[key]))
    res["same"][f"(d) level {EXT_CPU_LEVEL} terms: card == CPU"] = all(
        same_words(a, b) for a, b in zip(card_low["terms"],
                                         cpu_low["terms"]))
    res["seconds"]["ext"] = time.perf_counter() - t0
    del cpu, cpu_low, card_low, ladder
    torch.cuda.empty_cache()

    res["launches"] = {k: launches[k] for k in names}
    print(f"integer phase per EvalMult: BGV {per_bgv}; BFV {per_bfv}; "
          f"BV { {k: n for k, n in per_bv.items() if n} }")
    print(f"integer phase launches (fused runs only): "
          f"{ {k: n for k, n in res['launches'].items() if n} }")
    require(not any(res["launches"][k] for k in STAGED),
            f"the integer phase ran a staged form: {res['launches']}")
    print(f"integer phase exact decryptions: {res['exact']}")
    print(f"integer phase extended-basis errors (limit {EXT_SUM_TOL}): "
          f"{res['errors']}")
    print(f"integer phase words equal: {res['same']}")
    require(all(res["same"].values()),
            f"integer phase words differ: "
            f"{[k for k, v in res['same'].items() if not v]}")
    res["seconds"]["phase"] = time.perf_counter() - t_phase
    print(f"integer phase: {res['seconds']['phase']:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in res['seconds'].items())})")
    return res


def count_calls(cc, methods) -> collections.Counter:
    """Make each of cc's `methods` count its calls in the returned
    Counter (instance attributes over the class's methods, bound to cc:
    delete them before `unfused_view(cc)`)."""
    calls = collections.Counter()
    for m in methods:
        def counted(*args, _m=m, _f=getattr(cc, m), **kw):
            calls[_m] += 1
            return _f(*args, **kw)
        setattr(cc, m, counted)
    return calls


def bootstrap_phase(card, names) -> dict:
    """CKKS bootstrapping (see the module docstring, phase 9); raises on
    any fault. Counted over (a)'s cold and warm EvalBootstrap alone, each
    from a cleared counter; every oracle runs outside those windows."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.pke import parameters as prm
    from openfhe_tpu_torch.pke.schemelet import SchemeletRLWEMP as SL
    from openfhe_tpu_torch.trace_evalmult import (OWN, profile_device,
                                                  time_encodes)
    from openfhe_tpu_torch.utils.precision import \
        calculate_approximation_error as precision
    t_phase = time.perf_counter()
    res = {"precision_bits": {}, "same": {}, "seconds": {}}

    def floor(label, bits, limit):
        res["precision_bits"][label] = bits
        print(f"{label}: {bits:.2f} bits of precision (floor {limit})")
        require(np.isfinite(bits) and bits >= limit,
                f"{label}: {bits:.2f} bits, below {limit}")

    def boot_context(ring_dim, depth, slots, budget):
        cc = fhe.GenCryptoContext(prm.boot_bench_params(ring_dim, depth),
                                  seed=BOOT_SEED)
        cc.EvalBootstrapSetup(level_budget=budget, slots=slots)
        kp = cc.KeyGen()
        cc.EvalMultKeyGen(kp.secret_key)
        cc.EvalBootstrapKeyGen(kp.secret_key, slots)
        z = np.random.default_rng(0).uniform(-0.5, 0.5, slots)
        ct = cc.LevelReduce(cc.Encrypt(kp.public_key,
                                       cc.MakeCKKSPackedPlaintext(
                                           z, slots=slots)), depth - 2)
        return cc, kp, z, ct

    # (a) bench_boot16 at full width
    torch.cuda.reset_peak_memory_stats()
    n, depth, slots, budget = BOOT16
    t0 = time.perf_counter()
    cc, kp, z, ct = boot_context(n, depth, slots, budget)
    sk = kp.secret_key
    torch.cuda.synchronize()
    res["seconds"]["(a) context and keys"] = time.perf_counter() - t0
    keys = len(cc.eval_automorphism_keys[sk.key_tag])
    print(f"(a) bootstrap context: N=2^{n.bit_length() - 1}, "
          f"{len(cc.moduli_q)} Q + {len(cc.moduli_p)} P towers, "
          f"{len(cc.hybrid_tables(cc.size_ql(0)).parts)} digits, "
          f"{keys} automorphism keys, {slots} slots, budget {budget}, input "
          f"level {ct.level} ({cc.size_ql(ct.level)} towers); "
          f"{res['seconds']['(a) context and keys']:.1f} s")
    encodes = time_encodes(cc)
    counted = ("EvalFastRotation", "EvalRotate", "EvalConjugate")
    rotations = count_calls(cc, counted)
    res["boot16"] = runs = {}
    for run in ("cold", "warm"):
        before, rot_before = dict(encodes), dict(rotations)
        _build.LAUNCHES.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = cc.EvalBootstrap(ct)
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end)
        per = {k: _build.LAUNCHES[k] for k in names if _build.LAUNCHES[k]}
        enc_ms = (encodes["s"] - before["s"]) * 1e3
        runs[run] = dict(
            wall_ms=wall, encodes=encodes["n"] - before["n"],
            encode_ms=enc_ms, host_encode_share=enc_ms / wall,
            rotations={k: rotations[k] - rot_before.get(k, 0)
                       for k in rotations}, launches=per)
        print(f"(a) {run} EvalBootstrap: wall {wall:.1f} ms (CUDA events, "
              f"{card}); {runs[run]['encodes']} encodes {enc_ms:.1f} ms on "
              f"the host ({enc_ms / wall:.0%} of the wall); rotations "
              f"{runs[run]['rotations']} (EvalFastRotation hoisted); "
              f"launches {per}")
    res["launches"] = runs["warm"]["launches"]
    for m in counted + ("MakeCKKSPackedPlaintext",):
        delattr(cc, m)        # the class's methods again (unfused_view)
    prof = profile_device(lambda: cc.EvalBootstrap(ct))
    own_ms = sum(t for k, t in prof["per_name"].items()
                 if any(f"{o}(" in k or f"{o}<" in k for o in OWN))
    by_op = collections.Counter()
    for k, t in prof["per_name"].items():
        by_op[k[:60]] += t
    runs["warm"].update(
        device_busy_ms=prof["busy_ms"], own_kernels_ms=own_ms,
        device_launches=sum(prof["launches"].values()),
        idle_gaps_ms=prof["idle_ms"], idle_gaps=prof["gaps"],
        top_device_ops={k: round(t, 4) for k, t in by_op.most_common(8)})
    print(f"(a) warm EvalBootstrap under torch.profiler: device busy "
          f"{prof['busy_ms']:.1f} ms in {runs['warm']['device_launches']} "
          f"launches, the port's kernels {own_ms:.1f} ms; idle gaps "
          f"{prof['idle_ms']:.1f} ms in {prof['gaps']}; top "
          f"{runs['warm']['top_device_ops']}")
    dec = np.asarray(cc.Decrypt(sk, out).values)[:slots]
    floor("(a) EvalBootstrap N=2^16", precision(dec, z), BOOT16_BITS)
    require(cc.size_ql(out.level) > 2,
            f"(a) output keeps {cc.size_ql(out.level)} towers")
    res["levels_after"] = cc.size_ql(out.level) // cc.comp_deg - 1
    res["same"]["(a) fused == unfused"] = same_ct(
        out, unfused_view(cc).EvalBootstrap(ct))
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"(a) output level {out.level} ({cc.size_ql(out.level)} towers); "
          f"peak memory {res['peak_memory_gb']:.2f} GiB")
    del cc, kp, sk, ct, out
    torch.cuda.empty_cache()

    # (b) bench_boot on the card and on the CPU's plain path
    n, depth, slots, budget = BOOT12
    cc, kp_b, z, ct = boot_context(n, depth, slots, budget)
    sk = kp_b.secret_key
    out = cc.EvalBootstrap(ct)
    floor("(b) EvalBootstrap on the card", precision(
        np.asarray(cc.Decrypt(sk, out).values)[:slots], z), BOOT_BITS)
    t0 = time.perf_counter()
    cpu, on_cpu = cpu_twin(cc, BOOT_SEED)
    cpu.EvalBootstrapSetup(level_budget=budget, slots=slots)
    res["same"]["(b) card == CPU"] = same_ct(out, cpu.EvalBootstrap(
        on_cpu(ct)))
    res["seconds"]["(b) CPU plain path"] = cpu_s = time.perf_counter() - t0
    print(f"(b) N=2^{n.bit_length() - 1}, {len(cc.moduli_q)} Q + "
          f"{len(cc.moduli_p)} P towers: card == CPU "
          f"{res['same']['(b) card == CPU']} (CPU {cpu_s:.1f} s)")
    del cpu

    # (c) the other entry points on (b)'s card context; StCFirst takes a
    # fresh encryption (S2C first needs l_dec + 2 levels: it brings the
    # input down to them itself)
    fresh = cc.Encrypt(kp_b.public_key, cc.MakeCKKSPackedPlaintext(
        z, slots=slots))
    out = cc.EvalBootstrapStCFirst(fresh)
    floor("(c) EvalBootstrapStCFirst", precision(
        np.asarray(cc.Decrypt(sk, out).values)[:slots], z), STC_BITS)
    prec1 = precision(np.asarray(cc.Decrypt(
        sk, cc.EvalBootstrap(ct)).values)[:slots], z)
    prec2 = precision(np.asarray(cc.Decrypt(
        sk, cc.EvalBootstrap(ct, num_iterations=2)).values)[:slots], z)
    res["precision_bits"]["(c) two rounds: one, two"] = (prec1, prec2)
    print(f"(c) two-round EvalBootstrap: {prec1:.2f} -> {prec2:.2f} bits "
          f"(must gain {TWO_ROUND_GAIN})")
    require(prec2 > prec1 + TWO_ROUND_GAIN,
            f"(c) two rounds gave {prec2:.2f} bits against {prec1:.2f}")
    del cc, ct, fresh, out
    torch.cuda.empty_cache()

    n, depth, slots, p_in = FBT_CONFIG
    fc = fhe.GenCryptoContext(fhe.CCParams(
        scheme=fhe.Scheme.CKKSRNS_SCHEME, ring_dim=n, mult_depth=depth,
        scaling_mod_size=28, first_mod_size=30, batch_size=slots,
        security_level=fhe.SecurityLevel.HEStd_NotSet,
        scaling_technique=fhe.ScalingTechnique.FLEXIBLEAUTO), seed=14)
    fc.EvalFBTSetup(num_slots=slots, p_in=p_in)
    kp = fc.KeyGen()
    fc.EvalMultKeyGen(kp.secret_key)
    fc.EvalFBTKeyGen(kp.secret_key, slots)
    q0, last = fc.moduli_q[0], len(fc.moduli_q) - 1
    polys = SL.encrypt_coeff(fc, kp.secret_key, FBT_DIGITS, q0, p_in,
                             level=last)
    fct = dataclasses.replace(
        SL.convert_rlwe_to_ckks(fc, polys, q0, slots=slots, level=last,
                                scale=q0 / p_in),
        key_tag=kp.secret_key.key_tag)
    got = np.round(np.asarray(fc.Decrypt(kp.secret_key, fc.EvalFBT(
        fct, FBT_LUT, p_in, decode=False)).values).real[:slots])
    res["fbt_lut_exact"] = ok = bool(np.array_equal(got,
                                                    FBT_LUT[FBT_DIGITS]))
    print(f"(c) EvalFBT p = {p_in} at N=2^{n.bit_length() - 1}, depth "
          f"{depth}: {got.astype(int).tolist()} against "
          f"{FBT_LUT[FBT_DIGITS].tolist()}")
    require(ok, "(c) EvalFBT's LUT did not come back after rounding")
    del fc

    print(f"bootstrap phase words equal: {res['same']}")
    require(all(res["same"].values()),
            f"bootstrap phase words differ: "
            f"{[k for k, v in res['same'].items() if not v]}")
    path = ("ntt_fwd", "ntt_inv", "mod_matmul_rowmod", "tensor_intt",
            "conv_digits", "ntt_keymul_acc", "intt_conv_p",
            "ntt_submul_final", "intt_scale", "ntt_subscale")
    require(all(res["launches"].get(k, 0) > 0 for k in path),
            f"a kernel of the bootstrap's path was not launched: "
            f"{res['launches']}")
    require(not any(res["launches"].get(k, 0) for k in STAGED),
            f"the bootstrap ran a staged form: {res['launches']}")
    res["seconds"]["phase"] = time.perf_counter() - t_phase
    print(f"bootstrap phase: {res['seconds']['phase']:.1f} s")
    return res


def blind_wide_work(params, batch, key, idx, lo, hi):
    """(bytes, operations) of the composite-Q blind rotation's steps [lo,
    hi): the key words of those steps, the table, the accumulators in and
    out and both towers' twiddle and psi tables once; per gate-step and
    tower the 2 + d2 transforms, N^-1, the key product's terms, reductions
    and monomial products (`blind_work`'s GINX step), and once per
    gate-step the Garner lift, centring and digits of the 2N coefficients
    (the kernel lifts them in both blocks of a gate: counted once)."""
    n, d2 = params.ring_dim, params.digits_g2
    log_n = n.bit_length() - 1
    nbytes = WORD * (key[lo:hi].numel() + idx.numel()
                     + 4 * batch * 2 * n + 2 * 6 * n)
    tower = ((2 + d2) * n // 2 * log_n * BUTTERFLY_OPS + 2 * n * SHOUP_OPS
             + n * (4 * d2 * MATMUL_TERM_OPS + 6 * MULMOD_OPS
                    + 4 * MATMUL_TERM_OPS))
    lift = 2 * n * (GARNER_OPS + CENTRE_OPS + params.digits_g * DIGIT_OPS)
    return nbytes, batch * (hi - lo) * (2 * tower + lift)


def blind_wide_cases(cc, gen) -> dict:
    """`blind_rotate_cggi_wide` at STD192 against the per-step loop on the
    card (`rgsw_wide._eval_acc_cggi_wide_steps`), word for word, with the
    context's key and random accumulators and a (any words are valid
    inputs), at GATE_BATCH and 1: the dispatch (`eval_acc_cggi_wide`, one
    launch) and the direct wrapper call equal the loop, and at GATE_BATCH
    steps [0, SPLIT_STEP) then [SPLIT_STEP, n) equal the whole. `ms` is
    the kernel's device time, `call_ms` the dispatch's, `plain_ms` one
    call of the loop (CUDA events)."""
    from openfhe_tpu_torch.binfhe import blind_rotate as br
    from openfhe_tpu_torch.binfhe import rgsw_wide
    name = BLIND_WIDE[0]
    p = cc.rgsw_w.replace(q_lwe=cc.q)
    key, big_n = cc.bt_key, cc.N
    rows = []
    for batch in (GATE_BATCH, 1):
        acc0, acc1 = (torch.stack([torch.randint(
            0, m, (batch, big_n), generator=gen, device="cuda",
            dtype=torch.int32) for m in p.moduli], dim=1) for _ in range(2))
        a = torch.randint(0, cc.q, (batch, cc.n), generator=gen,
                          device="cuda", dtype=torch.int32)
        idx = br.cggi_idx(p, a)
        kernel = lambda lo=0, hi=None: br.blind_rotate_cggi_wide(
            p, key, idx, acc0, acc1, lo, hi)
        fused = lambda: rgsw_wide.eval_acc_cggi_wide(p, key, acc0, acc1, a)
        got, per = count_launches(fused, BLIND + BLIND_WIDE + SMALL)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = rgsw_wide._eval_acc_cggi_wide_steps(p, key, acc0, acc1, a)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        direct = kernel()
        torch.cuda.synchronize()
        err = max(max_abs_err(torch.stack(got), torch.stack(want)),
                  max_abs_err(torch.stack(got), torch.stack(direct)))
        require(err == 0, f"{name} {WIDE_SET} batch {batch} differs from "
                f"the per-step loop (max abs err {err})")
        require(per == {k: int(k == name)
                        for k in BLIND + BLIND_WIDE + SMALL},
                f"{name}: one blind rotation launched {per}")
        split = None
        if batch == GATE_BATCH:
            part = kernel(0, SPLIT_STEP)
            part = br.blind_rotate_cggi_wide(p, key, idx, *part, SPLIT_STEP)
            split = all(torch.equal(x, y) for x, y in zip(part, direct))
            require(split, f"{name}: steps [0, {SPLIT_STEP}) then "
                    f"[{SPLIT_STEP}, {cc.n}) differ from the whole")
        nbytes, ops = blind_wide_work(p, batch, key, idx, 0, cc.n)
        b_ms, b_by = bound(nbytes, ops)
        rows.append(dict(
            shape=[batch, cc.n, p.digits_g2, big_n], moduli=WIDE_SET,
            max_abs_err=err, split_equal=split,
            launches_per_call=per[name],
            ms=device_ms(kernel, BLIND_REPS, 1),
            call_ms=cuda_ms(fused, BLIND_REPS, 1),
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            operations_ms=ops / INT32_OPS_PER_S * 1e3))
        c = rows[-1]
        print(f"(a) {name} {WIDE_SET} batch {batch}: kernel {c['ms']:.3f} "
              f"ms device (dispatch {c['call_ms']:.3f} ms), bound "
              f"{b_ms:.4f} ms ({b_by}; operations {c['operations_ms']:.4f},"
              f" bytes {c['bytes_ms']:.4f}); per-step loop {plain_ms:.1f} "
              f"ms (one call); equal to the loop and the direct call: "
              f"{err == 0}; split equal: {split}")
    return {name: rows}


def wide_binfhe(card, names, gen) -> dict:
    """Phase 10 (a): GINX on the composite-Q ring at STD192 over a gate
    batch (see the module docstring); raises on any fault."""
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD, BINGATE
    from openfhe_tpu_torch.binfhe.context import BinFHEContext
    from openfhe_tpu_torch.trace_evalmult import profile_device
    res = {}
    i = np.arange(GATE_BATCH)
    bits = {"a": i % 2, "b": (i // 2) % 2, "c": (i // 4) % 2}
    a, b, c = bits["a"], bits["b"], bits["c"]
    truth = {"AND": a & b, "OR": a | b, "NAND": 1 - (a & b),
             "XOR": a ^ b, "XNOR": 1 - (a ^ b)}
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    cc = BinFHEContext(seed=WIDE_SEED).GenerateBinFHEContext(WIDE_SET)
    require(cc.device.type == "cuda" and cc.wide,
            f"{WIDE_SET} is not on the card's composite-Q ring")
    sk = cc.KeyGen()
    cc.BTKeyGen(sk)
    ct = {k: cc.Encrypt(sk, v) for k, v in bits.items()}
    torch.cuda.synchronize()
    res["keygen_encrypt_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    wrong, outs = {}, {}
    for g, want in truth.items():
        outs[g], per = count_launches(
            lambda g=g: cc.EvalBinGate(BINGATE[g], ct["a"], ct["b"]), names)
        if g == "AND":
            per_and = per
        wrong[g] = int((cc.Decrypt(sk, outs[g]) != want).sum())
    wrong["NOT"] = int((cc.Decrypt(sk, cc.EvalNOT(ct["a"])) != 1 - a).sum())
    wrong["Bootstrap"] = int((cc.Decrypt(sk, cc.Bootstrap(ct["a"]))
                              != a).sum())
    maj = cc.EvalBinGate(BINGATE.MAJORITY, [ct["a"], ct["b"], ct["c"]])
    wrong["MAJORITY"] = int((cc.Decrypt(sk, maj)
                             != (a + b + c >= 2)).sum())
    res["launches"] = {k: _build.LAUNCHES[k] for k in names
                       if _build.LAUNCHES[k]}
    res["per_and"] = per_and
    res["wrong"] = wrong
    rw = cc.rgsw_w
    print(f"(a) GINX {WIDE_SET} (n={cc.n}, N={cc.N}, Q = {rw.moduli[0]} x "
          f"{rw.moduli[1]} ({cc.Q.bit_length()} bits), d2={rw.digits_g2}), "
          f"batch {GATE_BATCH}: wrong decryptions {wrong}; launches per AND "
          f"{ {k: v for k, v in per_and.items() if v} }; whole phase "
          f"{res['launches']}")
    require(all(v == 0 for v in wrong.values()),
            f"{WIDE_SET} decryptions differ from the truth table: {wrong}")
    # the test vector's forward NTT, the blind rotation and the
    # extraction's inverse NTT: one launch each, plain torch around them
    want_and = {k: int(k in SMALL + BLIND_WIDE) for k in names}
    require(per_and == want_and,
            f"{WIDE_SET} AND launches {per_and}, expected {want_and}")
    require(all(res["launches"].get(k, 0) > 0 for k in BLIND_WIDE),
            f"the {WIDE_SET} gates never launched {BLIND_WIDE}")
    res["launches"] = {k: res["launches"].get(k, 0) for k in names}

    # 4 gates on the port's plain path on the CPU, with the same keys
    t0 = time.perf_counter()
    cpu = BinFHEContext(seed=WIDE_SEED, device="cpu").GenerateBinFHEContext(
        WIDE_SET)
    cpu.ks_key = dataclasses.replace(cc.ks_key, a=cc.ks_key.a.cpu(),
                                     b=cc.ks_key.b.cpu())
    cpu.bt_key = cc.bt_key.cpu()
    four = lambda x: x.replace(a=x.a[:4].cpu(), b=x.b[:4].cpu())
    on_cpu = cpu.EvalBinGate(BINGATE.AND, four(ct["a"]), four(ct["b"]))
    res["cpu_four_same"] = same = (
        torch.equal(on_cpu.a, outs["AND"].a[:4].cpu())
        and torch.equal(on_cpu.b, outs["AND"].b[:4].cpu()))
    res["cpu_four_s"] = time.perf_counter() - t0
    print(f"(a) 4 AND gates on the card == plain path on the CPU: {same} "
          f"({res['cpu_four_s']:.1f} s on the CPU)")
    require(same, f"{WIDE_SET} words on the card differ from the plain path")
    del cpu

    # the batch's wall, its device busy share and the peak memory
    and_fn = lambda: cc.EvalBinGate(BINGATE.AND, ct["a"], ct["b"])
    res["batch_ms"] = cuda_ms(and_fn, GATE_REPS, 1)
    res["gates_per_s"] = GATE_BATCH / res["batch_ms"] * 1e3
    prof = profile_device(and_fn)
    res["device_busy_ms"] = prof["busy_ms"]
    res["device_busy_share"] = prof["busy_ms"] / res["batch_ms"]
    res["device_launches"] = sum(prof["launches"].values())
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"(a) {WIDE_SET} AND: {res['batch_ms']:.1f} ms per batch of "
          f"{GATE_BATCH} ({res['gates_per_s']:.1f} gates/s; median of "
          f"{GATE_REPS}, CUDA events, {card}); device busy "
          f"{prof['busy_ms']:.1f} ms ({res['device_busy_share']:.0%}) in "
          f"{res['device_launches']} device launches; peak memory "
          f"{res['peak_memory_gb']:.2f} GiB")

    # the kernel against the per-step loop, at the batch and at 1
    res["cases"] = blind_wide_cases(cc, gen)

    # EvalFunc x^2 mod 4 at batch 4 (the JAX sweep's STD192 function)
    p = 4
    x4 = np.arange(FUNC_BATCH) % p
    lut = cc.GenerateLUTviaFunction(lambda m, pp: (m * m) % pp, p)
    got = cc.Decrypt(sk, cc.EvalFunc(cc.Encrypt(sk, x4, p=p), lut), p=p)
    print(f"(a) EvalFunc x^2 mod 4 on {x4.tolist()}: {got.tolist()}")
    require(np.array_equal(got, x4 * x4 % p), "EvalFunc decrypts wrong")
    del cc, ct, outs
    torch.cuda.empty_cache()

    # STD192Q: one AND; STD192_LMKCDEY refuses
    cq = BinFHEContext(seed=WIDE_SEED).GenerateBinFHEContext(WIDE_Q_SET)
    skq = cq.KeyGen()
    cq.BTKeyGen(skq)
    out = cq.EvalBinGate(BINGATE.AND, cq.Encrypt(skq, a), cq.Encrypt(skq, b))
    res["wrong_q"] = bad = int((cq.Decrypt(skq, out) != (a & b)).sum())
    print(f"(a) {WIDE_SET[:-1] + 'Q'} AND (Q of {cq.Q.bit_length()} bits, "
          f"n={cq.n}), batch {GATE_BATCH}: wrong {bad}")
    require(bad == 0, f"{WIDE_Q_SET} AND decrypts wrong")
    del cq
    try:
        BinFHEContext().GenerateBinFHEContext("STD192_LMKCDEY",
                                             BINFHE_METHOD.LMKCDEY)
        refused = False
    except ValueError:
        refused = True
    print(f"(a) STD192_LMKCDEY refused with ValueError: {refused}")
    require(refused, "STD192_LMKCDEY did not raise ValueError")
    return res


def switch_context(ring, depth, level, security):
    """A FLEXIBLEAUTO context with scheme switching set up and keyed:
    (cc, key pair, LWE secret)."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch.pke.schemeswitch import SchSwchParams
    cc = fhe.GenCryptoContext(fhe.CCParams(
        scheme=fhe.Scheme.CKKSRNS_SCHEME, ring_dim=ring, mult_depth=depth,
        scaling_mod_size=28, first_mod_size=30, batch_size=SSW_SLOTS,
        security_level=security,
        scaling_technique=fhe.ScalingTechnique.FLEXIBLEAUTO), seed=SSW_SEED)
    for f in ("PKE", "KEYSWITCH", "LEVELEDSHE", "ADVANCEDSHE",
              "SCHEMESWITCH", "FHE"):
        cc.Enable(fhe.pke.constants.PKESchemeFeature[f])
    lwe_sk = cc.EvalSchemeSwitchingSetup(SchSwchParams(
        security_level_fhew=level, num_slots_ckks=SSW_SLOTS,
        ctxt_mod_size_fhew_large_prec=SSW_LARGE_PREC))
    kp = cc.KeyGen()
    cc.EvalMultKeyGen(kp.secret_key)
    cc.EvalSchemeSwitchingKeyGen(kp, lwe_sk)
    cc.GetBinCCForSchemeSwitch().BTKeyGen(lwe_sk)
    return cc, kp, lwe_sk


def compare_inputs(cc, kp, seed: int = 0):
    """16 pairs in [0, 1), SSW_GAP to 2 SSW_GAP apart, either one the
    larger, encrypted."""
    rng = np.random.default_rng(seed)
    gap = rng.uniform(SSW_GAP, 2 * SSW_GAP, SSW_SLOTS)
    lo = rng.uniform(0, 1 - gap)
    first_low = rng.integers(0, 2, SSW_SLOTS) == 1
    x1 = np.where(first_low, lo, lo + gap)
    x2 = np.where(first_low, lo + gap, lo)
    enc = lambda v: cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(
        v, slots=SSW_SLOTS))
    return x1, x2, enc(x1), enc(x2)


def switch_state_to_cpu(cc, cpu, on_cpu) -> None:
    """cc's scheme-switching keys into the CPU twin's state (made by its
    own setup of the same parameters)."""
    from openfhe_tpu_torch.binfhe import lwe
    from openfhe_tpu_torch.pke import schemeswitch as ssw
    from openfhe_tpu_torch.pke.keys import EvalKey
    src, dst = cc._schswch, cpu._schswch
    dst.lwe_sk = lwe.LWEPrivateKey(s=src.lwe_sk.s.cpu())
    dst.swk = EvalKey(bv=src.swk.bv.cpu(), av=src.swk.av.cpu(),
                      key_tag=src.swk.key_tag)
    dst.swk_tabs = ssw.switch_tables(dst, ssw.aux_modulus(cpu, dst.q_prime))
    dst.s2c_bstep = src.s2c_bstep
    dst.fhew_to_ckks_swk = on_cpu(src.fhew_to_ckks_swk)
    dst.k_bound, dst.cheb_fhew = src.k_bound, list(src.cheb_fhew)
    ks = src.cc_lwe.ks_key
    dst.cc_lwe.ks_key = dataclasses.replace(ks, a=ks.a.cpu(), b=ks.b.cpu())
    dst.cc_lwe.bt_key = src.cc_lwe.bt_key.cpu()


def f2c_stage_errors(cc, sk, lwe_sk, lwe_cts) -> dict:
    """EvalFHEWtoCKKS's first stages on lwe_cts, each decrypted against its
    exact value (max error over the meaningful slots, in the prescaled
    units 1 / (q K) of the Chebyshev range [-1, 1]): the partial
    decryption A s (the linear transform's key switches), B - A s, the
    Chebyshev seed and the double-angle steps (`schemeswitch.py`)."""
    from openfhe_tpu_torch.math.modops import to_u32
    from openfhe_tpu_torch.pke import schemeswitch as ssw
    from openfhe_tpu_torch.pke.fhe.ckks_bootstrap import (
        apply_double_angle, eval_linear_transform)
    st = cc._schswch
    a = to_u32(lwe_cts.a).astype(np.float64)
    b = to_u32(lwe_cts.b).astype(np.float64)
    s = lwe_sk.s.cpu().numpy().astype(np.float64)
    nv, n = a.shape
    n_po2 = 1 << int(math.ceil(math.log2(n)))
    half = cc.ring_dim // 2
    big_k = st.k_bound
    pre = 1.0 / float(lwe_cts.modulus) / big_k
    bstep = max(1, int(math.ceil(math.sqrt(n_po2))))
    amat = np.zeros((nv, n_po2))
    amat[:, :n] = a * pre
    dec = lambda c: np.asarray(cc.Decrypt(sk, c).values).real[:nv]
    errs = {}
    a_s = cc.ModReduce(eval_linear_transform(
        cc, st.fhew_to_ckks_swk, ssw._Diagonals(amat, half, bstep), bstep,
        half, cache=False))
    errs["A s"] = float(np.abs(dec(a_s) - (a @ s) * pre).max())
    bvec = np.zeros(half)
    bvec[:nv] = b * pre
    x = cc.EvalAdd(cc.EvalNegate(a_s), cc.MakeCKKSPackedPlaintext(
        bvec, level=a_s.level, slots=half))
    exact = (b - a @ s) * pre
    errs["B - A s"] = float(np.abs(dec(x) - exact).max())
    y = cc.EvalChebyshevSeries(x, st.cheb_fhew, -1.0, 1.0)
    if y.noise_deg > 1:
        y = cc.ModReduce(y)
    seed = (2 * np.pi) ** (-1 / 8) * np.cos(2 * np.pi * big_k * exact / 8
                                            - np.pi / 16)
    errs["Chebyshev seed"] = float(np.abs(dec(y) - seed).max())
    y = apply_double_angle(cc, y, 3)
    errs["double angle"] = float(np.abs(
        dec(y) - np.sin(2 * np.pi * big_k * exact) / (2 * np.pi)).max())
    return errs


def scheme_switch_phase(card, names) -> dict:
    """Phase 10 (b) and (c): CKKS <-> FHEW scheme switching (see the module
    docstring); raises on any fault."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.trace_evalmult import time_encodes
    res = {"ops": {}, "same": {}}
    path = ("ntt_fwd", "ntt_inv", "mod_matmul_rowmod") + FUSED + SMALL + (
        "blind_rotate_cggi",)

    # (b) at N=2^16, 128-bit security on both sides
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cc, kp, lwe_sk = switch_context(SSW_RING, SSW_DEPTH, "STD128",
                                    fhe.SecurityLevel.HEStd_128_classic)
    inner = cc.GetBinCCForSchemeSwitch()
    st = cc._schswch
    torch.cuda.synchronize()
    res["keys_s"] = time.perf_counter() - t0
    print(f"(b) scheme switching: N=2^{SSW_RING.bit_length() - 1}, "
          f"{len(cc.moduli_q)} Q + {len(cc.moduli_p)} P towers, "
          f"{SSW_SLOTS} slots; FHEW n={inner.n}, N={inner.N}, q={inner.q}, "
          f"q_LWE=2^{SSW_LARGE_PREC}, Q'={st.q_prime}; inner context on "
          f"{inner.device}; "
          f"{len(cc.eval_automorphism_keys[kp.secret_key.key_tag])} "
          f"rotation keys; context and keys {res['keys_s']:.1f} s")
    require(inner.device == cc.device, "the inner BinFHE context is not on "
            "the CKKS context's device")
    encodes = time_encodes(cc)

    def run(label, fn):
        """fn() from a cleared counter: its wall (CUDA events), encodes,
        launches and the plaintext cache's entries before and after."""
        before_enc = dict(encodes)
        cache_before = set(cc._pt_cache)
        mem_before = torch.cuda.memory_allocated()
        _build.LAUNCHES.clear()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end)
        enc_ms = (encodes["s"] - before_enc["s"]) * 1e3
        added = set(cc._pt_cache) - cache_before
        row = res["ops"][label] = dict(
            wall_ms=wall, encodes=encodes["n"] - before_enc["n"],
            encode_ms=enc_ms, host_encode_share=enc_ms / wall,
            launches={k: _build.LAUNCHES[k] for k in names
                      if _build.LAUNCHES[k]},
            cache_entries=(len(cache_before), len(cc._pt_cache)),
            memory_growth_gb=(torch.cuda.memory_allocated() - mem_before)
            / 2 ** 30)
        print(f"(b) {label}: wall {wall:.1f} ms (CUDA events, {card}); "
              f"{row['encodes']} encodes {enc_ms:.1f} ms on the host "
              f"({enc_ms / wall:.0%} of the wall); plaintext cache "
              f"{row['cache_entries'][0]} -> {row['cache_entries'][1]} "
              f"entries; allocated memory {row['memory_growth_gb']:+.3f} "
              f"GiB; launches {row['launches']}")
        return out, added

    x = np.arange(SSW_SLOTS) % SSW_P_LWE
    cc.EvalCKKStoFHEWPrecompute(1.0 / SSW_P_LWE)
    ct = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(
        x.astype(np.float64), slots=SSW_SLOTS))
    lwe_ct, _ = run("EvalCKKStoFHEW", lambda: cc.EvalCKKStoFHEW(ct,
                                                                SSW_SLOTS))
    got = inner.Decrypt(lwe_sk, lwe_ct.replace(pt_modulus=SSW_P_LWE))
    res["to_fhew_exact"] = ok = bool(np.array_equal(got, x))
    print(f"(b) EvalCKKStoFHEW of {x.tolist()}: {got.tolist()}")
    require(ok, "(b) EvalCKKStoFHEW's LWE samples decrypt wrong")

    cc.EvalCompareSwitchPrecompute(p_lwe=SSW_CMP_P, scale_sign=1.0)
    x1, x2, c1, c2 = compare_inputs(cc, kp)
    out, added = run("EvalCompareSchemeSwitching",
                     lambda: cc.EvalCompareSchemeSwitching(
                         c1, c2, SSW_SLOTS, SSW_SLOTS))
    dec = np.asarray(cc.Decrypt(kp.secret_key, out).values).real
    want = (x1 < x2).astype(np.float64)
    res["compare_err"] = err = float(np.abs(dec[:SSW_SLOTS] - want).max())
    row = res["ops"]["EvalCompareSchemeSwitching"]
    # the compare caches its S2C diagonals (first use after the
    # precompute) and nothing else: no entry of FHEW -> CKKS's diagonals
    s2c = {id(d) for d in st.s2c_diags}
    res["cache_added_only_s2c"] = only_s2c = all(k[0] in s2c for k in added)
    # its FHEW half on its own (the same words: no step draws randomness):
    # EvalSign of EvalCKKStoFHEW(ct1 - ct2) gives 1 where x1 < x2, else 3
    signs = inner.EvalSign(cc.EvalCKKStoFHEW(cc.EvalSub(c1, c2), SSW_SLOTS),
                           scheme_switch=True)
    got_s = inner.Decrypt(lwe_sk, signs, p=4)
    res["fhew_signs_right"] = signs_ok = bool(np.array_equal(
        got_s, np.where(x1 < x2, 1, 3)))
    res["f2c_stage_errors"] = stages = f2c_stage_errors(cc, kp.secret_key,
                                                        lwe_sk, signs)
    print(f"(b) EvalCompareSchemeSwitching of {SSW_SLOTS} pairs: EvalSign's "
          f"LWE signs right {signs_ok}; the CKKS result's max error "
          f"{err:.3e} ({SSW_CMP_TOL} at N=2^12 in (c)), rounded right "
          f"{bool(np.array_equal(np.round(dec[:SSW_SLOTS]), want))}; "
          f"EvalFHEWtoCKKS's stages, max error over the slots against "
          f"the exact values: {stages}; cache entries added {len(added)}, "
          f"all S2C diagonals {only_s2c}; memory growth "
          f"{row['memory_growth_gb']:.3f} GiB (limit {SSW_MEM_LIMIT_GB}); "
          f"output level {out.level}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    require(signs_ok, "(b) EvalSign's signs wrong")
    require(dec.shape == (SSW_SLOTS,) and bool(np.isfinite(dec).all()),
            "(b) the compare's decryption is not finite or of the wrong "
            "shape")
    require(only_s2c and len(added) <= len(st.s2c_diags),
            "(b) the compare left other encodings in the plaintext cache")
    require(row["memory_growth_gb"] < SSW_MEM_LIMIT_GB,
            f"(b) the compare kept {row['memory_growth_gb']:.2f} GiB")
    res["per_compare"] = per = row["launches"]
    require(all(per.get(k, 0) > 0 for k in path),
            f"(b) a kernel of the switch's path was not launched: {per}")
    require(not any(per.get(k, 0) for k in STAGED),
            f"(b) the compare ran a staged form: {per}")
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del cc, kp, ct, c1, c2, out, lwe_ct, encodes, signs
    torch.cuda.empty_cache()

    # (c) the card against the CPU's plain path, from the same keys
    ring, depth, level = SSW_TWIN
    cc, kp, lwe_sk = switch_context(ring, depth, level,
                                    fhe.SecurityLevel.HEStd_NotSet)
    t0 = time.perf_counter()
    cpu, on_cpu = cpu_twin(cc, SSW_SEED)
    cpu.EvalSchemeSwitchingSetup(dataclasses.replace(cc._schswch.params))
    switch_state_to_cpu(cc, cpu, on_cpu)
    _build.LAUNCHES.clear()
    x1, x2, c1, c2 = compare_inputs(cc, kp, 1)
    outs = {}
    for side, ctx, mv in (("card", cc, lambda v: v), ("cpu", cpu, on_cpu)):
        ctx.EvalCompareSwitchPrecompute(p_lwe=SSW_CMP_P, scale_sign=1.0)
        outs[side, "compare"] = ctx.EvalCompareSchemeSwitching(
            mv(c1), mv(c2), SSW_SLOTS, SSW_SLOTS)
    signs = cc.GetBinCCForSchemeSwitch().EvalSign(cc.EvalCKKStoFHEW(
        cc.EvalSub(c1, c2), SSW_SLOTS), scheme_switch=True)
    res["twin_f2c_stage_errors"] = f2c_stage_errors(cc, kp.secret_key,
                                                    lwe_sk, signs)
    vals = np.zeros(SSW_SLOTS)
    vals[:len(SSW_VALS)] = SSW_VALS
    cv = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(
        vals, slots=SSW_SLOTS))
    # the tournament's fresh encryption of ones: one, on both sides
    ones = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(
        np.ones(len(SSW_VALS)), slots=SSW_SLOTS))
    cc.Encrypt = lambda *args, **kw: ones
    cpu.Encrypt = lambda *args, **kw: on_cpu(ones)
    for side, ctx, mv in (("card", cc, lambda v: v), ("cpu", cpu, on_cpu)):
        for op in ("Min", "Max"):
            outs[side, op] = getattr(ctx, f"Eval{op}SchemeSwitching")(
                mv(cv), None, len(SSW_VALS), SSW_SLOTS, p_lwe=SSW_CMP_P)
    del cc.Encrypt, cpu.Encrypt
    res["twin_launches"] = twin = {k: _build.LAUNCHES[k] for k in names
                                   if _build.LAUNCHES[k]}
    res["twin_s"] = time.perf_counter() - t0
    for op in ("compare", "Min", "Max"):
        got, want_ = outs["card", op], outs["cpu", op]
        pairs = [(got, want_)] if op == "compare" else list(zip(got, want_))
        res["same"][f"(c) {op}"] = all(same_ct(g, w) for g, w in pairs)
    decv = lambda c: np.asarray(cc.Decrypt(kp.secret_key, c).values).real
    cmp_ok = bool(np.array_equal(np.round(decv(outs["card", "compare"])[
        :SSW_SLOTS]), (x1 < x2).astype(np.float64)))
    mn, ind = (decv(c) for c in outs["card", "Min"])
    mx = decv(outs["card", "Max"][0])
    onehot = (SSW_VALS == SSW_VALS.min()).astype(np.float64)
    res["twin_errors"] = errs = dict(
        min=float(abs(mn[0] - SSW_VALS.min())),
        max=float(abs(mx[0] - SSW_VALS.max())),
        argmin=float(np.abs(ind[:len(SSW_VALS)] - onehot).max()))
    print(f"(c) N=2^{ring.bit_length() - 1}, depth {depth}, {level} FHEW "
          f"side: card == CPU {res['same']}; compare signs right {cmp_ok}; "
          f"min {mn[0]:.4f}, max {mx[0]:.4f}, argmin "
          f"{np.round(ind[:len(SSW_VALS)], 3).tolist()} (errors {errs}); "
          f"the compare's FHEW -> CKKS stages "
          f"{res['twin_f2c_stage_errors']}; "
          f"launches {twin}; {res['twin_s']:.1f} s with the CPU")
    require(all(res["same"].values()),
            f"(c) card words differ from the CPU: {res['same']}")
    require(cmp_ok, "(c) comparison signs wrong")
    require(errs["min"] < SSW_MINMAX_TOL and errs["max"] < SSW_MINMAX_TOL
            and errs["argmin"] < SSW_CMP_TOL,
            f"(c) min / max / argmin wrong: {errs}")
    require(twin.get("blind_rotate_cggi", 0) > 0,
            "(c) EvalSign did not launch blind_rotate_cggi")
    del cc, cpu
    torch.cuda.empty_cache()
    return res


def host_clock():
    """Make the HOST_STEPS add the host seconds of their outermost calls
    to the returned dict's "s"; returns it and a function that undoes the
    patches."""
    import importlib
    clock = {"s": 0.0, "depth": 0}
    saved = []
    for mod_name, fns in HOST_STEPS:
        mod = importlib.import_module(mod_name)
        for name in fns:
            orig = getattr(mod, name)

            def timed(*args, _f=orig, **kw):
                clock["depth"] += 1
                t = time.perf_counter()
                try:
                    return _f(*args, **kw)
                finally:
                    clock["depth"] -= 1
                    if not clock["depth"]:
                        clock["s"] += time.perf_counter() - t
            setattr(mod, name, timed)
            saved.append((mod, name, orig))
    return clock, lambda: [setattr(m, n, f) for m, n, f in saved]


def protocols_phase(card, names) -> dict:
    """Multiparty, interactive bootstrapping, PRE, NOISE_FLOODING_MULTIPARTY,
    serialization and EvalHermiteTrigSeries (see the module docstring,
    phase 11); raises on any fault. Each part is counted from its context's
    creation (or its first op) to its last op; every oracle runs outside
    those windows."""
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.lattice.automorph import \
        rotation_automorphism_index
    from openfhe_tpu_torch.math.hermite import get_hermite_trig_coefficients
    from openfhe_tpu_torch.pke import pre
    from openfhe_tpu_torch.pke import parameters as prm
    from openfhe_tpu_torch.pke.constants import (MultipartyMode,
                                                 PKESchemeFeature,
                                                 ProxyReEncryptionMode)
    from openfhe_tpu_torch.trace_evalmult import OWN
    from openfhe_tpu_torch.utils import serialization as ser
    t_phase = time.perf_counter()
    res = {"parts": {}, "steps": {}, "same": {}, "errors": {}, "limits": {},
           "exact": {}, "per_op": {}}
    launches = collections.Counter()
    clock, unpatch = host_clock()
    want_mult = {k: int(k in MULT_CHAIN) for k in names}
    want_ks = {k: int(k in KS_CHAIN) for k in names}

    def window(label, fn):
        """fn() from a cleared counter: its wall (CUDA events), launches
        by kernel, host share and peak memory; its launches join the
        phase's."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        host0 = clock["s"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end)
        per = {k: _build.LAUNCHES[k] for k in names if _build.LAUNCHES[k]}
        host_ms = (clock["s"] - host0) * 1e3
        part = res["parts"][label] = dict(
            wall_ms=wall, host_ms=host_ms, host_share=host_ms / wall,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=per)
        launches.update(per)
        print(f"{label}: wall {wall:.1f} ms (CUDA events, {card}); host "
              f"steps {host_ms:.1f} ms ({host_ms / wall:.1%}); peak memory "
              f"{part['peak_memory_gb']:.2f} GiB; launches {per}")
        return out

    def step(label, fn):
        """One protocol step inside a window: its wall and host share."""
        host0 = clock["s"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, per = count_launches(fn, names)
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end)
        host_ms = (clock["s"] - host0) * 1e3
        res["steps"][label] = dict(wall_ms=wall, host_ms=host_ms,
                                   host_share=host_ms / wall,
                                   launches={k: v for k, v in per.items()
                                             if v})
        return out

    def limit(label, got, want, tol):
        err = float(np.abs(np.asarray(got)[:len(want)] - want).max())
        res["errors"][label], res["limits"][label] = err, tol
        require(np.isfinite(err) and err <= tol,
                f"{label}: error {err:.3e} above {tol:.1e}")

    def own_kernels(label, fn, want):
        kernels = device_kernels(fn, want)
        own = [k for k in kernels
               if any(f"{o}(" in k or f"{o}<" in k for o in OWN)]
        print(f"{label} on the card: {len(kernels)} device kernels, "
              f"{len(own)} of csrc/")
        require(len(kernels) == want == len(own),
                f"{label} ran {len(kernels)} device kernels ({len(own)} of "
                f"csrc/), expected {want}, all of csrc/")

    def threshold(cc, sks, ct):
        """Lead, Main, ..., Fusion: the decrypted values."""
        parts = ([cc.MultipartyDecryptLead(ct, sks[0])]
                 + [cc.MultipartyDecryptMain(ct, s) for s in sks[1:]])
        return np.asarray(cc.MultipartyDecryptFusion(parts, ct).values)

    def joint_keys(cc, sks, gs):
        """The joint relinearization key (KeySwitchGen, a MultiKeySwitchGen
        and MultiAddEvalKeys per later party, MultiMultEvalKey per party,
        MultiAddEvalMultKeys) and, for `gs`, the joint rotation keys, all
        under the last party's joint tag."""
        tag = sks[-1].key_tag
        ek = cc.KeySwitchGen(sks[0], sks[0])
        for s in sks[1:]:
            ek = cc.MultiAddEvalKeys(ek, cc.MultiKeySwitchGen(s, s, ek), tag)
        joint = None
        for s in sks:
            share = cc.MultiMultEvalKey(ek, s, tag)
            joint = (share if joint is None
                     else cc.MultiAddEvalMultKeys(joint, share, tag))
        cc.InsertEvalMultKey(joint, tag)
        if gs:
            cc.EvalAutomorphismKeyGen(sks[0], gs)
            amap = cc.eval_automorphism_keys[sks[0].key_tag]
            for s in sks[1:]:
                amap = cc.MultiAddAutomorphismKeys(
                    amap, cc.MultiEvalAutomorphismKeyGen(s, amap, gs), tag)
            cc.InsertEvalAutomorphismKey(amap, tag)
        return joint

    def parties(cc, count):
        kps = [cc.MultipartyKeyGen()]
        for _ in range(count - 1):
            kps.append(cc.MultipartyKeyGen(kps[-1].public_key))
        return kps

    # (a) threshold CKKS at the main path's widths, FLEXIBLEAUTO
    params = dataclasses.replace(prm.main_path_params(),
                                 scaling_technique=fhe.ScalingTechnique
                                 .FLEXIBLEAUTO)
    rng = np.random.default_rng(PROTO_SEED)

    def threshold_run():
        cc = fhe.GenCryptoContext(params, seed=PROTO_SEED)
        cc.Enable(PKESchemeFeature.MULTIPARTY | PKESchemeFeature.PRE)
        kps = parties(cc, MP_PARTIES)
        sks = [k.secret_key for k in kps]
        n = cc.ring_dim
        gs = [rotation_automorphism_index(r, n) for r in (1, -1)]
        joint_keys(cc, sks, gs)
        jpk = kps[-1].public_key
        z = rng.uniform(-Z_MAX, Z_MAX, cc.slots)
        w = rng.uniform(-Z_MAX, Z_MAX, cc.slots)
        a = cc.Encrypt(jpk, cc.MakeCKKSPackedPlaintext(z))
        b = cc.Encrypt(jpk, cc.MakeCKKSPackedPlaintext(w))
        prod, per_mult = count_launches(lambda: cc.EvalMult(a, b), names)
        resc, per_resc = count_launches(lambda: cc.Rescale(prod), names)
        rot, per_rot = {}, {}
        for r in (1, -1):
            rot[r], per_rot[r] = count_launches(
                lambda r=r: cc.EvalRotate(a, r), names)
        rot_p = {r: cc.Rescale(cc.EvalRotate(prod, r)) for r in (1, -1)}
        prod1, per_mult1 = count_launches(lambda: cc.EvalMult(resc, resc),
                                          names)
        rot1 = cc.EvalRotate(resc, 1)
        decs = {"a": threshold(cc, sks, a), "b": threshold(cc, sks, b),
                "resc": threshold(cc, sks, resc),
                "resc1": threshold(cc, sks, cc.Rescale(prod1)),
                **{f"rot_p{r:+d}": threshold(cc, sks, rot_p[r])
                   for r in (1, -1)}}
        shares = cc.ShareKeys(sks[0], *SHARE)
        rec = cc.RecoverSharedKey({i: shares[i] for i in (1, 3, 5)},
                                  key_tag=sks[0].key_tag)
        return dict(cc=cc, kps=kps, sks=sks, z=z, w=w, a=a, b=b, prod=prod,
                    resc=resc, rot=rot, prod1=prod1, rot1=rot1, decs=decs,
                    rec=rec, per=dict(mult=per_mult, mult1=per_mult1,
                                      rescale=per_resc, rot=per_rot))

    A = window("(a) threshold CKKS", threshold_run)
    cc, sks, kps = A["cc"], A["sks"], A["kps"]
    jpk, tag = kps[-1].public_key, sks[-1].key_tag
    z, w, decs = A["z"], A["w"], A["decs"]
    require((len(cc.moduli_q), len(cc.moduli_p)) == (31, 16)
            and cc.hybrid_tables(cc.size_ql(0)).fused is not None,
            "unexpected threshold chain or no fused tables")
    joint = cc.eval_mult_keys[tag]
    require(joint.bv_sh is not None and all(
        k.bv_sh is not None for k in cc.eval_automorphism_keys[tag].values()),
        "a joint key has no Shoup companions")
    print(f"(a) {MP_PARTIES} parties, joint tag {tag}; {len(cc.moduli_q)} Q "
          f"+ {len(cc.moduli_p)} P towers, N=2^{cc.ring_dim.bit_length() - 1}")
    per = A["per"]
    res["per_op"]["threshold EvalMult"] = per["mult"]
    require(per["mult"] == want_mult and per["mult1"] == want_mult,
            f"threshold EvalMult launches {per['mult']} / {per['mult1']}, "
            f"expected {want_mult}")
    for r in (1, -1):
        require(per["rot"][r] == want_ks, f"EvalRotate {r:+d} under the "
                f"joint key launches {per['rot'][r]}, expected {want_ks}")
    own_kernels("threshold EvalMult", lambda: cc.EvalMult(A["a"], A["b"]),
                MULT_KERNELS)
    limit("(a) threshold Rescale(EvalMult) - z w", decs["resc"].real,
          z * w, MP_TOL)
    limit("(a) threshold Rescale(EvalMult) - dec(a) dec(b)",
          decs["resc"].real, decs["a"].real * decs["b"].real, MP_MULT_TOL)
    limit("(a) threshold level-1 product - (z w)^2", decs["resc1"].real,
          (z * w) ** 2, MP_TOL)
    for r in (1, -1):
        limit(f"(a) threshold Rescale(EvalRotate(prod, {r:+d}))",
              decs[f"rot_p{r:+d}"].real, np.roll(decs["resc"].real, -r),
              MP_MULT_TOL)
    unf = unfused_view(cc)
    a_ct, b_ct, resc = A["a"], A["b"], A["resc"]
    res["same"].update({
        "(a) EvalMult fused == unfused": same_ct(A["prod"],
                                                 unf.EvalMult(a_ct, b_ct)),
        "(a) EvalMult level 1 fused == unfused": same_ct(
            A["prod1"], unf.EvalMult(resc, resc)),
        **{f"(a) EvalRotate {r:+d} fused == unfused": same_ct(
            A["rot"][r], unf.EvalRotate(a_ct, r)) for r in (1, -1)},
        "(a) EvalRotate level 1 fused == unfused": same_ct(
            A["rot1"], unf.EvalRotate(resc, 1))})
    t0 = time.perf_counter()
    cpu, on_cpu = cpu_twin(cc, PROTO_SEED)
    res["same"]["(a) EvalMult level 1 card == CPU"] = same_ct(
        A["prod1"], cpu.EvalMult(on_cpu(resc), on_cpu(resc)))
    print(f"(a) the CPU's plain path: {time.perf_counter() - t0:.1f} s")
    del cpu
    res["same"]["(a) RecoverSharedKey == party 1's key"] = torch.equal(
        A["rec"].s_qp, sks[0].s_qp)
    res["times"] = {
        "threshold EvalMult": cuda_ms(lambda: cc.EvalMult(a_ct, b_ct),
                                      reps=10),
        "EvalRotate +1 under the joint key": cuda_ms(
            lambda: cc.EvalRotate(a_ct, 1), reps=10)}

    # (b) interactive bootstrapping on (a)'s context
    def int_boot_run():
        lvl = len(cc.moduli_q) - IB_TOWERS
        x2 = cc.LevelReduce(cc.Encrypt(kps[1].public_key,
                                       cc.MakeCKKSPackedPlaintext(z)), lvl)
        x3 = cc.LevelReduce(cc.Encrypt(jpk, cc.MakeCKKSPackedPlaintext(w)),
                            lvl)
        torch.cuda.synchronize()
        adj = step("IntBootAdjustScale", lambda: cc.IntBootAdjustScale(x2))
        s1 = step("IntBootDecrypt (lead)",
                  lambda: cc.IntBootDecrypt(sks[0], adj))
        c1 = dataclasses.replace(adj, elements=(adj.elements[1],))
        s2 = step("IntBootDecrypt (c1 only)",
                  lambda: cc.IntBootDecrypt(sks[1], c1))
        e2 = step("IntBootEncrypt",
                  lambda: cc.IntBootEncrypt(kps[1].public_key, s2))
        out2 = step("IntBootAdd", lambda: cc.IntBootAdd(e2, s1))
        before = dict(_build.LAUNCHES)
        ctc = step("IntMPBootAdjustScale",
                   lambda: cc.IntMPBootAdjustScale(x3))
        crp = step("IntMPBootRandomElementGen",
                   lambda: cc.IntMPBootRandomElementGen(jpk))
        c1 = dataclasses.replace(ctc, elements=(ctc.elements[1],))
        shares = [step(f"IntMPBootDecrypt party {i + 1}",
                       lambda s=s: cc.IntMPBootDecrypt(s, c1, crp))
                  for i, s in enumerate(sks)]
        agg = step("IntMPBootAdd", lambda: cc.IntMPBootAdd(shares))
        out3 = step("IntMPBootEncrypt",
                    lambda: cc.IntMPBootEncrypt(jpk, agg, crp, ctc))
        torch.cuda.synchronize()
        round_launches = {k: _build.LAUNCHES[k] - before.get(k, 0)
                          for k in names}
        sq, per_sq = count_launches(lambda: cc.EvalMult(out3, out3), names)
        return dict(x2=x2, out2=out2, out3=out3, sq=sq, per_sq=per_sq,
                    round=round_launches)

    B = window("(b) interactive bootstrapping", int_boot_run)
    res["per_op"]["IntMPBoot round"] = B["round"]
    res["per_op"]["EvalMult after IntMPBoot"] = B["per_sq"]
    for label, s in res["steps"].items():
        print(f"  {label:28s} wall {s['wall_ms']:8.2f} ms, host steps "
              f"{s['host_ms']:8.2f} ms ({s['host_share']:.0%}); launches "
              f"{s['launches']}")
    require(cc.size_ql(B["x2"].level) == IB_TOWERS
            and cc.size_ql(B["out2"].level) == len(cc.moduli_q)
            and cc.size_ql(B["out3"].level) == len(cc.moduli_q),
            "the refreshed ciphertexts do not have the full chain")
    fresh = {
        2: float(np.abs(threshold(cc, sks[:2], cc.Encrypt(
            kps[1].public_key, cc.MakeCKKSPackedPlaintext(z))).real
            - z).max()),
        3: float(np.abs(threshold(cc, sks, cc.Encrypt(
            jpk, cc.MakeCKKSPackedPlaintext(w))).real - w).max())}
    res["errors"].update({f"(b) fresh threshold decryption, {p} parties": e
                          for p, e in fresh.items()})
    ib_tol = {p: min(IB_NOISE * e, IB_TOL) for p, e in fresh.items()}
    limit("(b) 2-party IntBoot", threshold(cc, sks[:2], B["out2"]).real, z,
          ib_tol[2])
    limit("(b) 3-party IntMPBoot", threshold(cc, sks, B["out3"]).real, w,
          ib_tol[3])
    limit("(b) EvalMult after IntMPBoot, Rescale",
          threshold(cc, sks, cc.Rescale(B["sq"])).real, w * w, ib_tol[3])
    require(B["per_sq"] == want_mult,
            f"EvalMult after IntMPBoot launches {B['per_sq']}")

    # (e) serialization of (a)'s objects on the card
    objs = {"Ciphertext": a_ct, "PublicKey (joint)": jpk,
            "PrivateKey (party 2's share)": sks[1], "EvalKey (joint relin)":
            joint}
    blobs = {}

    def ser_run():
        for st in ser.SerType:
            for label, obj in objs.items():
                t = time.perf_counter()
                data = ser.serialize(obj, st)
                t_w = time.perf_counter() - t
                t = time.perf_counter()
                back = ser.deserialize(data, st, cc=cc)
                torch.cuda.synchronize()
                blobs[(st.name, label)] = dict(
                    bytes=len(data), write_ms=t_w * 1e3,
                    read_ms=(time.perf_counter() - t) * 1e3, obj=back,
                    same_bytes=ser.serialize(back, st) == data)
            t = time.perf_counter()
            amap = cc.SerializeEvalAutomorphismKey(st)
            t_w = time.perf_counter() - t
            t = time.perf_counter()
            again = copy.copy(cc)
            again.eval_automorphism_keys = {}
            again.DeserializeEvalAutomorphismKey(amap)
            torch.cuda.synchronize()
            blobs[(st.name, "rotation maps (every tag)")] = dict(
                bytes=len(amap), write_ms=t_w * 1e3,
                read_ms=(time.perf_counter() - t) * 1e3,
                obj=again.eval_automorphism_keys[tag],
                same_bytes=again.SerializeEvalAutomorphismKey(st) == amap)
        record = ser.serialize_context(cc)
        return (ser.deserialize_context(record),
                ser.deserialize_context(record))

    c1_ctx, c2_ctx = window("(e) serialization", ser_run)
    res["same"]["(e) context record deduplicated"] = (
        c1_ctx is c2_ctx and c1_ctx.device.type == "cuda")
    ser.CryptoContextFactory.release_all_contexts()
    del c1_ctx, c2_ctx
    res["serialization"] = {}

    def same_obj(x, y):
        if isinstance(y, type(a_ct)):
            return same_ct(x, y)
        return all(torch.equal(getattr(x, f.name), getattr(y, f.name))
                   for f in dataclasses.fields(y)
                   if isinstance(getattr(y, f.name), torch.Tensor))

    for (st, label), b in blobs.items():
        obj = b.pop("obj")
        if label == "rotation maps (every tag)":
            want_map = cc.eval_automorphism_keys[tag]
            same = sorted(obj) == sorted(want_map) and all(
                same_obj(obj[g], k) for g, k in want_map.items())
        else:
            same = same_obj(obj, objs[label])
        res["same"][f"(e) {st} {label} round trip"] = (same
                                                       and b["same_bytes"])
        res["serialization"][f"{st} {label}"] = b
        print(f"  {st:6s} {label:30s} {b['bytes']:>11d} bytes, write "
              f"{b['write_ms']:8.1f} ms, read {b['read_ms']:8.1f} ms")
    reloaded = copy.copy(cc)
    reloaded.eval_mult_keys = {tag: ser.deserialize(ser.serialize(joint),
                                                    cc=cc)}
    res["same"]["(e) reloaded relin key's EvalMult"] = same_ct(
        reloaded.EvalMult(a_ct, b_ct), A["prod"])
    own_kernels("EvalMult under the reloaded relin key",
                lambda: reloaded.EvalMult(a_ct, b_ct), MULT_KERNELS)
    del reloaded

    # (f) EvalHermiteTrigSeries on (a)'s context
    f = lambda j: j * j % HERMITE_P
    zz = np.exp(2j * np.pi * (np.arange(cc.slots) % HERMITE_P) / HERMITE_P)
    coeffs = get_hermite_trig_coefficients(f, HERMITE_P)
    series = sum(complex(c) * zz ** j for j, c in enumerate(coeffs))
    ct_h = window("(f) EvalHermiteTrigSeries",
                  lambda: cc.EvalHermiteTrigSeries(cc.Encrypt(
                      jpk, cc.MakeCKKSPackedPlaintext(zz)), f, HERMITE_P))
    gain = max(1.0, sum(j * abs(complex(c)) for j, c in enumerate(coeffs)))
    limit("(f) EvalHermiteTrigSeries x^2 mod 4", threshold(cc, sks, ct_h),
          series, min(HERMITE_NOISE * gain * fresh[3], HERMITE_TOL))
    del cc, unf, A, B, objs, blobs, joint, a_ct, b_ct, resc, ct_h, kps, sks
    torch.cuda.empty_cache()

    # (c) PRE at bench_bfvbgv's BGV, each mode
    bgv = prm.bgv_bench_params()
    res["pre_launches"] = {}
    for mode in PRE_MODES:
        vals = {}

        def pre_run():
            cp = fhe.GenCryptoContext(dataclasses.replace(
                bgv, pre_mode=ProxyReEncryptionMode[mode]), seed=PROTO_SEED)
            cp.Enable(PKESchemeFeature.PRE)
            alice, bob, carol = (cp.KeyGen() for _ in range(3))
            cp.EvalMultKeyGen(alice.secret_key)
            n, t = cp.ring_dim, cp.plaintext_modulus
            u, v = (rng.integers(0, t, n) for _ in range(2))
            x = cp.Encrypt(alice.public_key, cp.MakePackedPlaintext(u))
            y = cp.Encrypt(alice.public_key, cp.MakePackedPlaintext(v))
            ab = cp.ReKeyGen(alice.secret_key, bob.secret_key)
            bc = cp.ReKeyGen(bob.secret_key, carol.public_key)
            hops = []
            for label, c in (("level 0", x),
                             ("after EvalMult", cp.EvalMult(x, y))):
                to_bob, per_b = count_launches(lambda: cp.ReEncrypt(c, ab),
                                               names)
                to_carol, per_c = count_launches(
                    lambda: cp.ReEncrypt(to_bob, bc, carol.public_key),
                    names)
                hops.append((label, c, to_bob, to_carol, per_b, per_c))
            vals.update(cp=cp, carol=carol, bc=bc, u=u, v=v, hops=hops)

        window(f"(c) PRE {mode}", pre_run)
        cp, t = vals["cp"], vals["cp"].plaintext_modulus
        tabs0 = cp.hybrid_tables(cp.size_ql(0))
        require((len(cp.moduli_q), len(cp.moduli_p), len(tabs0.parts))
                == (21, 7, 3) and not tabs0.fused.t_is_one,
                "unexpected BGV chain or fused tables without t")
        unf = unfused_view(cp)
        u, v = vals["u"], vals["v"]
        extra = {"INDCPA": 0, "FIXED_NOISE_HRA": 3,
                 "NOISE_FLOODING_HRA": 1}[mode]
        for label, c, to_bob, to_carol, per_b, per_c in vals["hops"]:
            want = u if label == "level 0" else u * v % t
            got = np.asarray(cp.Decrypt(vals["carol"].secret_key,
                                        to_carol).values)
            res["exact"][f"(c) {mode} {label}"] = ok = bool(
                np.array_equal(np.mod(got, t), np.mod(want, t)))
            require(ok, f"(c) {mode} {label}: decryption differs from numpy "
                    "mod t")
            # by secret key: the general chain alone; by public key also the
            # mode's noise lifts (FIXED_NOISE_HRA u, e0, e1; flooding one)
            want_b = dict(want_ks)
            want_b["ntt_fwd"] = want_b.get("ntt_fwd", 0) + (
                extra if mode == "NOISE_FLOODING_HRA" else 0)
            want_c = dict(want_ks)
            want_c["ntt_fwd"] = want_c.get("ntt_fwd", 0) + extra
            require(per_b == want_b and per_c == want_c,
                    f"(c) {mode} {label}: ReEncrypt launches {per_b} / "
                    f"{per_c}, expected {want_b} / {want_c}")
            res["pre_launches"][f"{mode} {label}"] = (per_b, per_c)
            draws = pre.re_encrypt_draws(cp, vals["carol"].public_key)
            one, two = (pre.re_encrypt_core(ctx, to_bob, vals["bc"],
                                            vals["carol"].public_key, draws)
                        for ctx in (cp, unf))
            res["same"][f"(c) {mode} {label} fused == unfused"] = same_ct(
                one, two)
        res["per_op"][f"ReEncrypt {mode}"] = vals["hops"][0][5]
        to_bob = vals["hops"][0][2]
        res["times"][f"ReEncrypt {mode}, by public key"] = cuda_ms(
            lambda: cp.ReEncrypt(to_bob, vals["bc"], vals["carol"].public_key),
            reps=10)
        del cp, unf, vals
        torch.cuda.empty_cache()

    # (d) NOISE_FLOODING_MULTIPARTY: BFV at bench_bfvbgv's widths, BGV at
    # (c)'s
    flood = MultipartyMode.NOISE_FLOODING_MULTIPARTY
    res["flooding_towers"] = {}
    for label, base in (("BFV", prm.bfv_bench_params()), ("BGV", bgv)):
        vals = {}

        def flood_run():
            cf = fhe.GenCryptoContext(dataclasses.replace(
                base, multiparty_mode=flood), seed=PROTO_SEED)
            cf.Enable(PKESchemeFeature.MULTIPARTY)
            kf = parties(cf, 2)
            sf = [k.secret_key for k in kf]
            joint_keys(cf, sf, [])
            n, t = cf.ring_dim, cf.plaintext_modulus
            u, v = (rng.integers(0, t, n) for _ in range(2))
            x, y = (cf.Encrypt(kf[-1].public_key, cf.MakePackedPlaintext(p))
                    for p in (u, v))
            prod, per_m = count_launches(lambda: cf.EvalMult(x, y), names)
            lead = cf.MultipartyDecryptLead(prod, sf[0])
            main = cf.MultipartyDecryptMain(prod, sf[1])
            got = np.asarray(cf.MultipartyDecryptFusion([lead, main],
                                                        prod).values)
            vals.update(cf=cf, got=got, want=u * v % t, per_m=per_m,
                        mask_device=lead.elements[0].device.type)

        window(f"(d) NOISE_FLOODING_MULTIPARTY {label}", flood_run)
        cf = vals["cf"]
        fixed = fhe.GenCryptoContext(dataclasses.replace(
            base, multiparty_mode=MultipartyMode.FIXED_NOISE_MULTIPARTY),
            seed=PROTO_SEED)
        towers = res["flooding_towers"][label] = dict(
            flooding=len(cf.moduli_q), fixed=len(fixed.moduli_q),
            p=len(cf.moduli_p), flood_cache=len(cf._flood_cache))
        print(f"(d) {label} N=2^{cf.ring_dim.bit_length() - 1}: Q towers "
              f"{towers['flooding']} flooding, {towers['fixed']} fixed; "
              f"{towers['p']} P; the mask's switch tables "
              f"{towers['flood_cache']} on {vals['mask_device']}")
        res["exact"][f"(d) {label} threshold EvalMult"] = ok = bool(
            np.array_equal(np.mod(vals["got"], cf.plaintext_modulus),
                           vals["want"]))
        require(ok, f"(d) {label}: threshold decryption is not exact")
        require(towers["flooding"] > towers["fixed"]
                and towers["flood_cache"] > 0
                and vals["mask_device"] == "cuda",
                f"(d) {label}: no flooding towers or the mask off the card")
        if label == "BGV":
            require(vals["per_m"] == want_mult, f"(d) BGV EvalMult launches "
                    f"{vals['per_m']}, expected {want_mult}")
        del cf, fixed, vals
        torch.cuda.empty_cache()

    unpatch()
    print(f"op times (median of 10, CUDA events, {card}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in res["times"].items()))
    res["launches"] = dict(launches)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"fused == unfused / word checks: {res['same']}")
    require(all(res["same"].values()), f"a word check failed: {res['same']}")
    print(f"protocols phase: {res['seconds']:.1f} s")
    return res


def lattice_phase(card, names, cc, sk, ct) -> dict:
    """The lattice toolbox, the native host library and the examples (see
    the module docstring, phase 12); raises on any fault. Each part is
    counted from a cleared counter; its host wall ends in a
    synchronisation."""
    import importlib
    from openfhe_tpu_torch import _build, native
    from openfhe_tpu_torch.lattice import dgsampling as dgs
    from openfhe_tpu_torch.lattice import trapdoor as td
    from openfhe_tpu_torch.lattice.field2n import Field2n
    from openfhe_tpu_torch.lattice.ringq import RingParams, RingPoly
    from openfhe_tpu_torch.math import crt
    from openfhe_tpu_torch.math import cyclotomic as cy
    from openfhe_tpu_torch.math import modops as mo
    from openfhe_tpu_torch.math import nbtheory as nb
    from openfhe_tpu_torch.math.dgg import sample_integers
    from openfhe_tpu_torch.math.draws import (RecordingDraws, ReplayDraws,
                                              TorchDraws, torch_draws)
    from openfhe_tpu_torch.math.matrix import Matrix
    from openfhe_tpu_torch.pke.schemes import rns_pke
    t_phase = time.perf_counter()
    res = {"parts": {}, "trapdoor": {}, "same": {}, "sampling": {},
           "field2n": {}, "bluestein": {}, "decode": {}, "examples": {}}
    launches = collections.Counter()
    path = ("ntt_fwd", "ntt_inv") + SMALL

    def counted(label, fn):
        """fn() from a cleared counter: its wall (host clock, ending in a
        synchronisation) and launches by kernel."""
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        per = {k: _build.LAUNCHES[k] for k in names if _build.LAUNCHES[k]}
        launches.update(per)
        res["parts"][label] = {"s": s, "launches": per}
        print(f"  {label}: {s:.3f} s ({card}); launches {per}")
        return out

    def only(per, kernels, label):
        want = {k: per.get(k, 0) for k in path}
        require(all(want[k] > 0 for k in kernels)
                and not any(want[k] for k in path if k not in kernels),
                f"{label} launched {want}, expected only {kernels}")

    # (a), (b) TrapdoorGen and GaussSamp, A [e; r; I] == G, A x == u
    recorded = {}
    for n, base in LAT_RINGS:
        ring = RingParams.create(n, LAT_Q_BITS, device="cuda")
        k = td.gadget_k(ring.q, base)
        draws = RecordingDraws(torch_draws("cuda", seed=LAT_SEED + n))
        label = f"n={n}, base {base}, k={k}"
        A, T = counted(f"(a/b) TrapdoorGen {label}", lambda: td.trapdoor_gen(
            ring, dgs.SIGMA, base, draws=draws))
        u = RingPoly.uniform(ring, draws)
        x = counted(f"(a/b) GaussSamp {label}",
                    lambda: td.gauss_samp(n, k, A, T, u, draws, base))
        gen_part = res["parts"][f"(a/b) TrapdoorGen {label}"]
        samp_part = res["parts"][f"(a/b) GaussSamp {label}"]
        # once more at the small ring, its caches warm (the large ring's
        # first call is within about 10 % of a second one)
        warm = torch_draws("cuda", seed=LAT_SEED)
        u2 = RingPoly.uniform(ring, warm)
        x2 = (counted(f"(a/b) GaussSamp {label}, again",
                      lambda: td.gauss_samp(n, k, A, T, u2, warm, base))
              if n == LAT_RINGS[0][0] else x)
        u2 = u2 if n == LAT_RINGS[0][0] else u
        alloc = lambda: RingPoly(ring, None, "EVALUATION")
        eye = Matrix(alloc, k, k).Identity()
        gadget = A.Mult(T.m_e.VStack(T.m_r).VStack(eye)) == Matrix(
            alloc, 1, k).GadgetVector(base)
        exact = td.verify_preimage(A, x, u) and td.verify_preimage(A, x2, u2)
        norm, bound_s = x.Norm(), dgs.spectral_bound(n, k, base)
        kernels = SMALL if n <= 2048 else ("ntt_fwd", "ntt_inv")
        both = collections.Counter(gen_part["launches"])
        both.update(samp_part["launches"])
        only(both, kernels, label)
        res["trapdoor"][n] = dict(
            base=base, k=k, q=ring.q, trapdoor_gen_s=gen_part["s"],
            gauss_samp_s=samp_part["s"],
            gauss_samp_again_s=res["parts"].get(
                f"(a/b) GaussSamp {label}, again", {}).get("s"),
            launches_trapdoor_gen=gen_part["launches"],
            launches_gauss_samp=samp_part["launches"], gadget=gadget,
            preimage_exact=exact, norm=norm, spectral_bound=bound_s,
            variates=len(draws.recorded))
        print(f"(a/b) n={n}, q={ring.q}, base {base}, k={k}: A [e; r; I] "
              f"== G {gadget}; A x == u (twice) {exact}; |x| {norm:.0f} = "
              f"{norm / bound_s:.2f} spectral bounds (limit "
              f"{LAT_NORM_FACTOR}); TrapdoorGen {gen_part['s']:.3f} s, "
              f"GaussSamp {samp_part['s']:.3f} s, again "
              f"{res['trapdoor'][n]['gauss_samp_again_s']} s ({card})")
        require(gadget, f"n={n}: A [e; r; I] != G")
        require(exact, f"n={n}: A x != u")
        require(norm < LAT_NORM_FACTOR * bound_s,
                f"n={n}: |x| = {norm} above {LAT_NORM_FACTOR} x {bound_s}")
        if n == LAT_RINGS[0][0]:
            recorded = dict(n=n, base=base, k=k, A=A, T=T, x=x,
                            draws=draws.recorded)
        del A, T, x, x2

    # (c) the card against the CPU on the card's variates, and Field2n
    n, base, k = recorded["n"], recorded["base"], recorded["k"]
    cpu_ring = RingParams.create(n, LAT_Q_BITS, device="cpu")
    replay = ReplayDraws(recorded["draws"], "cpu")
    t0 = time.perf_counter()
    A_c, T_c = td.trapdoor_gen(cpu_ring, dgs.SIGMA, base, draws=replay)
    u_c = RingPoly.uniform(cpu_ring, replay)
    x_c = td.gauss_samp(n, k, A_c, T_c, u_c, replay, base)
    cpu_s = time.perf_counter() - t0
    same = lambda m1, m2: all(torch.equal(m1(r, c).data.cpu(), m2(r, c).data)
                              for r in range(m1.rows)
                              for c in range(m1.cols))
    res["same"] = {"A": same(recorded["A"], A_c),
                   "T": same(recorded["T"].m_r, T_c.m_r)
                   and same(recorded["T"].m_e, T_c.m_e),
                   "x": same(recorded["x"], x_c),
                   "every variate replayed": replay.exhausted()}
    print(f"(c) n={n}: the CPU's plain path on the card's "
          f"{len(recorded['draws'])} variates ({cpu_s:.2f} s): same words "
          f"{res['same']}")
    require(all(res["same"].values()),
            f"card and CPU differ on the same variates: {res['same']}")
    del recorded, A_c, T_c, x_c
    fn = LAT_RINGS[-1][0]
    rng = np.random.default_rng(LAT_SEED)
    vals = [rng.normal(size=fn) * 1e3 for _ in range(2)]
    outs = {}
    for dev in ("cuda", "cpu"):
        a, b = (Field2n(v, "COEFFICIENT", device=dev) for v in vals)
        ea, eb = a.SetFormat("EVALUATION"), b.SetFormat("EVALUATION")
        outs[dev] = {"round trip": ea.SetFormat("COEFFICIENT").data.cpu(),
                     "Times": (ea * eb).data.cpu(),
                     "Inverse": ea.Inverse().data.cpu()}
    a = Field2n(vals[0], "COEFFICIENT", device="cuda")
    ea = a.SetFormat("EVALUATION")
    f_ms = {"SwitchFormat": cuda_ms(lambda: a.SwitchFormat()),
            "Times": cuda_ms(lambda: ea * ea),
            "Inverse": cuda_ms(lambda: ea.Inverse())}
    rel = {key: float((outs["cuda"][key] - want).abs().max()
                      / want.abs().max())
           for key, want in outs["cpu"].items()}
    res["field2n"] = {"rel_err": rel, "ms": f_ms}
    print(f"(c) Field2n at n={fn}, card against CPU: max relative error "
          f"{rel} (limit {FIELD_TOL}); ms on the card {f_ms}")
    require(all(v <= FIELD_TOL for v in rel.values()),
            f"Field2n card vs CPU {rel} above {FIELD_TOL}")

    # (d) sample_integers on the card
    count = 1 << SAMPLE_LOG_COUNT
    gen = torch.Generator(device="cuda").manual_seed(LAT_SEED)
    centers = (torch.rand(count, generator=gen, device="cuda",
                          dtype=torch.float64) - 0.5) * 200
    for sigma in SAMPLE_SIGMAS:
        draws = TorchDraws(gen)
        ms = cuda_ms(lambda: sample_integers(centers, sigma, draws), reps=5,
                     warmup=1)
        d = sample_integers(centers, sigma, draws).double() - centers
        mean, std = d.mean().item(), d.std().item()
        # the rounding path adds a rounding of variance 1/12
        want_std = math.sqrt(sigma * sigma + (sigma > 64) / 12)
        lim_mean = SAMPLE_SE * sigma / math.sqrt(count)
        lim_std = SAMPLE_SE / math.sqrt(2 * count)
        rec = RecordingDraws(TorchDraws(gen))
        part = centers[:SAMPLE_REPLAY]
        on_card = sample_integers(part, sigma, rec).cpu()
        on_cpu = sample_integers(part.cpu(), sigma,
                                 ReplayDraws(rec.recorded, "cpu"))
        replayed = bool(torch.equal(on_card, on_cpu))
        res["sampling"][sigma] = dict(ms=ms, mean=mean, std=std,
                                      limit_mean=lim_mean,
                                      limit_std_rel=lim_std,
                                      replayed_equal=replayed)
        print(f"(d) sample_integers, 2^{SAMPLE_LOG_COUNT} centers in "
              f"[-100, 100), sigma {sigma:g}: {ms:.3f} ms ({card}); mean of "
              f"x - c {mean:.4g} (limit {lim_mean:.3g}), std {std:.6g} "
              f"against {want_std:.6g} (relative limit {lim_std:.3g}); "
              f"{SAMPLE_REPLAY} replayed on the CPU equal: {replayed}")
        require(abs(mean) < lim_mean and abs(std / want_std - 1) < lim_std
                and replayed, f"sample_integers at sigma {sigma}: "
                f"{res['sampling'][sigma]}")

    # (e) Bluestein at m = BLUESTEIN_M through kernels a/b
    m = BLUESTEIN_M
    q = nb.first_prime(LAT_Q_BITS, 2 * m)
    t = nb.totient(m)
    a, b = ([int(v) for v in rng.integers(0, q, t)] for _ in range(2))
    prod = counted(f"(e) multiply_arb m={m}",
                   lambda: cy.multiply_arb(a, b, q, m, device="cuda"))
    per_arb = res["parts"][f"(e) multiply_arb m={m}"]["launches"]
    fa = cy.forward_transform_arb(a, q, m, device="cuda")
    back = cy.inverse_transform_arb(fa, q, m, device="cuda")
    timed = {}
    for where, dev in (("card", "cuda"), ("CPU", "cpu")):
        t0 = time.perf_counter()
        out = cy.multiply_arb(a, b, q, m, device=dev)
        torch.cuda.synchronize()
        timed[where] = time.perf_counter() - t0
        require(out == prod, f"multiply_arb on the {where} differs")
    fa_c = cy.forward_transform_arb(a, q, m, device="cpu")
    res["bluestein"] = dict(
        m=m, q=q, totient=t, s=res["parts"][f"(e) multiply_arb m={m}"]["s"],
        warm_s=timed["card"], cpu_s=timed["CPU"], launches=per_arb,
        round_trip=back == a, same_as_cpu=fa == fa_c)
    print(f"(e) Bluestein m={m} (phi {t}, q={q}): multiply_arb "
          f"{res['bluestein']['s']:.3f} s on the card (first call), "
          f"{timed['card']:.3f} s warm, {timed['CPU']:.3f} s on the CPU; "
          f"card == CPU (product and forward transform) {fa == fa_c}; round "
          f"trip {back == a}; launches {per_arb}")
    require(back == a and fa == fa_c,
            f"Bluestein at m={m}: {res['bluestein']}")
    require(per_arb == {"ntt_fwd": 3, "ntt_inv": 3},
            f"multiply_arb launched {per_arb}, expected 3 ntt_fwd and 3 "
            "ntt_inv")

    # (f) the native host library on phase 4's ciphertext (N=2^16, L=30)
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    resid = mo.to_u32(rns_pke.decrypt_core(ct.elements, sk,
                                           cc.basis_at(ct.level)))
    moduli = tuple(cc.moduli_q[:resid.shape[0]])
    t0 = time.perf_counter()
    fast = crt.interpolate_centered_float(resid, moduli)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = crt._interpolate_centered_float_py(resid, moduli)
    python_s = time.perf_counter() - t0
    ulps = float(np.max(np.abs(fast - slow) / np.spacing(np.abs(slow))))
    t0 = time.perf_counter()
    cc.Decrypt(sk, ct)
    decrypt_s = time.perf_counter() - t0
    res["decode"] = dict(towers=len(moduli), n=resid.shape[1],
                         native_s=native_s, python_s=python_s,
                         max_ulps=ulps, decrypt_s=decrypt_s,
                         build_or_load_s=build_s)
    print(f"(f) CKKS decode of {len(moduli)} towers x {resid.shape[1]}: "
          f"native {native_s * 1e3:.1f} ms, Python {python_s * 1e3:.1f} ms "
          f"(host, {card}); max difference {ulps:.1f} ulps (limit 2); "
          f"Decrypt {decrypt_s * 1e3:.1f} ms; library load {build_s:.2f} s")
    require(ulps <= 2, f"native decode {ulps} ulps from the exact one")

    # (g) the five examples at their own sizes
    for name in EXAMPLES:
        mod = importlib.import_module(f"examples_torch.{name}")
        out = counted(f"(g) examples_torch/{name}.py",
                      lambda: mod.main(device="cuda"))
        if name == "simple_integers":
            ok = (np.array_equal(out["add"], out["want_add"])
                  and np.array_equal(out["mul"], out["want_mul"]))
        elif name == "simple_real_numbers":
            err = max(float(np.abs(g - w).max()) for g, w in out.values())
            ok = err < EXAMPLE_CKKS_TOL
            res["examples"]["simple_real_numbers_err"] = err
        elif name == "pre":
            ok = np.array_equal(out["got"], out["want"])
        elif name == "sampling":
            # the centers lie in [0, 1): the mean within SAMPLE_SE
            # standard errors of 0, the spread within 10 % of sigma
            ok = True
            for row in out.values():
                xs = row["samples"].astype(float)
                ok &= bool(abs(xs.mean()) < SAMPLE_SE * mod.STD
                           / math.sqrt(xs.size)
                           and abs(xs.std() / mod.STD - 1) < 0.1)
        else:
            ok = (len(out["draws"]) == 5 and out["gaussians"].shape == (8,))
        res["examples"][name] = bool(ok)
        require(ok, f"examples_torch/{name}.py: wrong result")
    print(f"(g) examples right: {res['examples']}")

    for kernel in path:
        require(launches[kernel] > 0,
                f"phase 12 never launched {kernel}: {dict(launches)}")
    res["launches"] = dict(launches)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"lattice phase: {res['seconds']:.1f} s; launches "
          f"{res['launches']}")
    return res


def examples_phase(card) -> dict:
    """Every example of OWN_EXAMPLES at its own parameters on the card,
    then FULL_WIDTH (see the module docstring, phase 13); raises on any
    fault. Each run is counted from a cleared counter; its host wall ends
    in a synchronisation and its own prints are kept out of the log."""
    import contextlib
    import importlib
    import io
    from examples_torch import failed, max_err
    from openfhe_tpu_torch import SecurityLevel, _build
    t_phase = time.perf_counter()
    res = {"own": {}, "full_width": {}}
    launches = collections.Counter()

    def run(name, kw, part):
        mod = importlib.import_module(f"examples_torch.{name}")
        if isinstance(kw.get("security_level"), str):
            kw = dict(kw, security_level=SecurityLevel[
                kw["security_level"]])
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = mod.main(device="cuda", **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        per = {k: v for k, v in sorted(_build.LAUNCHES.items()) if v}
        launches.update(per)
        wrong = failed(out)
        ring = {k: out[k] for k in ("ring_dim", "n", "N") if k in out}
        row = dict(s=s, launches=per, wrong=wrong, max_err=max_err(out),
                   checks=len(out["checks"]), **ring)
        for k in ("precision_bits", "towers", "levels", "ms", "shards"):
            if k in out:
                row[k] = out[k]
        res[part][name] = row
        print(f"  ({'a' if part == 'own' else 'b'}) {name} {kw or ''}: "
              f"{s:.3f} s ({card}); {len(out['checks'])} checks, wrong "
              f"{wrong}, max err {row['max_err']:.3g}; {ring or ''} "
              f"launches {per}")
        require(not wrong, f"examples_torch/{name}.py {kw}: wrong {wrong}")
        return per

    require(OWN_EXAMPLES, "examples_torch/ holds no examples")
    for name in OWN_EXAMPLES:
        run(name, {}, "own")
    for name, kw, want in FULL_WIDTH:
        per = run(name, kw, "full_width")
        for kernel in want:
            require(per.get(kernel, 0) > 0,
                    f"{name} {kw} never launched {kernel}: {per}")
    res["launches"] = dict(launches)
    res["seconds"] = time.perf_counter() - t_phase
    own_s = sum(r["s"] for r in res["own"].values())
    wide_s = sum(r["s"] for r in res["full_width"].values())
    print(f"examples phase: {res['seconds']:.1f} s ({own_s:.1f} s for "
          f"{len(res['own'])} examples at their own parameters, "
          f"{wide_s:.1f} s for {len(res['full_width'])} at full width); "
          f"launches {res['launches']}")
    return res


def same_words(x, y) -> bool:
    return len(x.elements) == len(y.elements) and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(x.elements, y.elements))


def main() -> int:
    global INT32_OPS_PER_S
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import openfhe_tpu_torch as fhe
    from openfhe_tpu_torch import _build
    from openfhe_tpu_torch.lattice.automorph import (
        rotation_automorphism_index)
    from openfhe_tpu_torch.lattice.basis import make_basis
    from openfhe_tpu_torch.math import nbtheory
    from openfhe_tpu_torch.ops import modmatmul, ntt
    from openfhe_tpu_torch.pke.keys import EvalKey
    from openfhe_tpu_torch.pke.keyswitch import ks_fused
    from openfhe_tpu_torch.pke.parameters import main_path_params

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    INT32_OPS_PER_S, mhz, sms = int32_rate()
    print(f"{card}: max SM clock {mhz:g} MHz x {sms} SMs x "
          f"{INT32_OPS_PER_CLOCK_PER_SM} a clock = {INT32_OPS_PER_S:.4g} "
          "32-bit integer op/s (the operations bound's rate)")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # 2. build
    built = _build.build()
    print(f"build: {built.seconds:.1f} s for {len(built.libs)} libraries")
    for name, log in built.log.items():
        entry = ""
        for line in log.splitlines():
            found = re.search(r"entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
            elif ("registers" in line or "spill" in line
                  or "error" in line.lower()):
                print(f"  nvcc[{name}] {entry}: {line.strip()}")

    params = main_path_params()
    t0 = time.perf_counter()
    cc = fhe.GenCryptoContext(params, seed=7)
    top = cc.hybrid_tables(cc.size_ql(0))
    print(f"context: {len(cc.moduli_q)} Q + {len(cc.moduli_p)} P towers, "
          f"N={cc.ring_dim}, {len(top.parts)} digits, device {cc.device}, "
          f"{time.perf_counter() - t0:.1f} s")
    require((len(cc.moduli_q), len(cc.moduli_p), len(top.parts))
            == (31, 16, 2), "unexpected main-path parameters")
    require(top.fused is not None, "the CUDA context has no fused tables")

    # 3. kernel phase: kernel vs plain version at the main path's shapes
    gen = torch.Generator(device="cuda").manual_seed(1)
    n = cc.ring_dim
    top31 = []
    q = 1 << 31
    while len(top31) < 6:
        q = nbtheory.previous_prime(q, 2 * n)
        top31.append(q)
    cases = {name: [] for name in SLICE1 + FUSED}
    staged = {name: [] for name in STAGED}
    # Rescale's two shapes (the 30 kept towers of both elements, the
    # dropped tower), a batch at N=2^13 (clusters of one block) and, where
    # cluster_geometry takes it, N=2^17 (clusters of 8)
    big = 1 << 17
    top31_big = [nbtheory.previous_prime(1 << 31, 2 * big)]
    while len(top31_big) < 6:
        top31_big.append(nbtheory.previous_prime(top31_big[-1], 2 * big))
    ntt_shapes = [
        (cc.basis_q, "Q (31 towers)", ()),
        (cc.basis_qp, "QP (47 towers)", ()),
        (make_basis(top31[:4], n, device="cuda"), "largest 31-bit primes",
         ()),
        (cc.basis_q.slice(0, 30), "Rescale: 30 kept towers x 2", (2,)),
        (cc.basis_q.slice(30, 31), "Rescale: the dropped tower", ()),
        (make_basis(cc.moduli_q[:3], 1 << 13, device="cuda"),
         "N=2^13, batch of 2", (2,))]
    # every other ring the kernel is compiled for at N >= 2^12: one block a
    # tower (2^12), clusters of 2 (2^14) and 4 (2^15)
    for log_n in (12, 14, 15):
        ntt_shapes.append((make_basis(top31[:4], 1 << log_n, device="cuda"),
                           f"N=2^{log_n}, 31-bit primes", ()))
    if ntt.cluster_geometry(big):
        ntt_shapes.append((make_basis(top31_big[:4], big, device="cuda"),
                           "N=2^17, 31-bit primes", ()))
    for basis, label, lead in ntt_shapes:
        for name, case in ntt_cases(ntt, basis, gen, label, lead).items():
            (staged if name in STAGED else cases)[name].append(case)
    # kernel k at the hoisted rotation's shapes (digit -> complement, 16 ->
    # 31 and 15 -> 32, and the mod-down's P -> Q, 16 -> 31), and a batch
    rowmod_shapes = [(part.switch, part.compl_basis,
                      f"digit {part.start}:{part.end} -> complement", ())
                     for part in top.parts]
    rowmod_shapes += [
        (top.moddown.switch, top.basis_ql, "P -> Q mod-down", ()),
        (top.moddown.switch, top.basis_ql, "P -> Q mod-down, batch 2", (2,))]
    for tab, d_basis, label, lead in rowmod_shapes:
        for name, case in rowmod_case(modmatmul, tab, d_basis, gen, label,
                                      lead).items():
            (staged if name in STAGED else cases)[name].append(case)
    # the fused kernels: level 0, level 1 (digit 1 has 14 towers) and a
    # 31-bit chain in two digits and in one, each with a random key over
    # its own QP moduli
    key_main = rand_key(gen, list(cc.moduli_q) + list(cc.moduli_p), n)
    basis31 = make_basis(top31, n, device="cuda")
    key31 = rand_key(gen, top31, n)
    for tabs, key, label in (
            (top.fused, key_main, "level 0 (31 Q + 16 P)"),
            (cc.hybrid_tables(cc.size_ql(1)).fused, key_main,
             "level 1 (30 Q + 16 P)"),
            (ks_fused.make_fused_ks_tables(basis31, 4, 4, 2), key31,
             "largest 31-bit primes (4 Q + 2 P)"),
            (ks_fused.make_fused_ks_tables(basis31, 4, 4, 1), key31,
             "largest 31-bit primes (4 Q + 2 P), one digit")):
        for name, case in fused_cases(ks_fused, tabs, key, gen, label):
            (staged if name in STAGED else cases)[name].append(case)
    # K1/K4, K3, K45, K6f and K2 (and K1t, K6) by level, 44 down to 17
    # Q_l*P towers in two digits and in one: their time against the
    # clusters a wave places
    for lvl in (3, 11, 15, 23, 30):
        tabs = cc.hybrid_tables(cc.size_ql(lvl)).fused
        for name, case in fused_cases(
                ks_fused, tabs, key_main, gen,
                f"level {lvl} ({tabs.kql} Q + {tabs.kp} P)",
                tuple(FORMER)):
            (staged if name in STAGED else cases)[name].append(case)
    rings = [(1 << log_n, top31) for log_n in (12, 14, 15)]
    if ntt.cluster_geometry(big):
        rings.append((big, top31_big))
    wide31 = list(top31)
    while len(wide31) < 4 + max(WIDE_P):
        wide31.append(nbtheory.previous_prime(wide31[-1], 2 * n))
    for name, case in cluster_shape_cases(ks_fused, gen, rings, wide31, n):
        (staged if name in STAGED else cases)[name].append(case)
    del key_main, key31
    # ntt_subscale with BGV's t = 65537 (K6's t multiply) and with one and
    # two addends (the final add of an automorphism or KeySwitch, and of
    # Relinearize), each beside its staged form, at level 0
    ext = rand_residues(gen, top.basis_qlp.moduli, n, (2,))
    tabs_t = ks_fused.make_fused_ks_tables(top.basis_qlp, cc.size_ql(0),
                                           len(cc.moduli_q), 2,
                                           ns_int=65537)
    convq = rand_residues(gen, top.basis_ql.moduli, n, (2,))
    adds = [rand_residues(gen, top.basis_ql.moduli, n) for _ in range(2)]
    with_adds = lambda fn: (lambda cq, x, a0, a1, t: fn(cq, x, t, a0, a1))
    for tabs, given, label in (
            (tabs_t, (None, None), "level 0, t = 65537"),
            (top.fused, (adds[0], None), "level 0, addend to element 0"),
            (top.fused, tuple(adds), "level 0, both addends")):
        for name, case in cluster_case(
                "ntt_subscale", with_adds(ks_fused.ntt_subscale),
                with_adds(ks_fused.ntt_subscale_staged),
                with_adds(ks_fused._ntt_subscale_ref),
                (convq, ext, *given), tabs,
                fused_work(tabs, sum(a is not None for a in given))[
                    "ntt_subscale"], label).items():
            (staged if name in STAGED else cases)[name].append(case)
    del convq, adds
    del ext
    small = ntt_small_cases(gen, card)
    blind = blind_rotate_cases(gen)
    for name, rows in blind.items():
        for c in rows:
            print(f"  {name:20s} {str(c['shape']):24s} {c['moduli']:15s} "
                  f"kernel {c['ms']:.3f} ms (call {c['call_ms']:.3f})  "
                  f"per-step loop {c['plain_ms']:.1f} ms  bound "
                  f"{c['bound_ms']:.4f} ms ({c['bound_by']})  max_abs_err "
                  f"{c['max_abs_err']}"
                  + ("" if c["split_equal"] is None else
                     f"  split at step {SPLIT_STEP} == whole: "
                     f"{c['split_equal']}"))
    for name, rows in {**cases, **staged}.items():
        for c in rows:
            extra = "" if "staged_ms" not in c else (
                f"(call {c['call_ms']:.4f})  {c.get('former', 'staged')} "
                f"{c['staged_ms']:.4f} ms (call {c['staged_call_ms']:.4f})  ")
            print(f"  {name:18s} {str(c['shape']):18s} {c['moduli']:32s} "
                  f"kernel {c['ms']:.4f} ms  {extra}plain "
                  f"{c['plain_ms']:.4f} ms  bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})  max_abs_err {c['max_abs_err']}")

    # 4. main path, counted
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    kp = cc.KeyGen()
    sk = kp.secret_key
    cc.EvalMultKeyGen(sk)
    cc.EvalRotateKeyGen(sk, [1, -1])
    cc.EvalSumKeyGen(sk, SUM_BATCH)
    cc.EvalConjugateKeyGen(sk)
    rng = np.random.default_rng(0)
    z = rng.uniform(-Z_MAX, Z_MAX, size=cc.slots)
    # complex slots for the conjugation, |w| <= Z_MAX
    w = (rng.uniform(-Z_MAX, Z_MAX, cc.slots)
         + 1j * rng.uniform(-Z_MAX, Z_MAX, cc.slots)) / np.sqrt(2)
    pt = cc.MakeCKKSPackedPlaintext(z)
    ct_a = cc.Encrypt(kp.public_key, pt)
    ct_b = cc.Encrypt(kp.public_key, pt)
    ct_c = cc.Encrypt(kp.public_key, cc.MakeCKKSPackedPlaintext(w))
    ek_mult = cc.eval_mult_keys[sk.key_tag]
    auto_keys = cc.eval_automorphism_keys[sk.key_tag]

    def counted(fn):
        """fn() and the launches it made, per kernel."""
        before = dict(_build.LAUNCHES)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: _build.LAUNCHES[k] - before.get(k, 0) for k in cases}

    # the unfused chain, as the JAX package builds its oracle: the same
    # level tables without the fused ones
    unf = unfused_view(cc)
    relin_unfused = unf.Relinearize
    rotate_unfused = unf.EvalRotate
    unfused = lambda x, y: relin_unfused(cc.EvalMultNoRelin(x, y))
    relin = lambda x, y: cc.Relinearize(cc.EvalMultNoRelin(x, y))
    prod, per_mult = counted(lambda: cc.EvalMult(ct_a, ct_b))
    prod_u, per_unfused = counted(lambda: unfused(ct_a, ct_b))
    prod_r, per_relin = counted(lambda: relin(ct_a, ct_b))
    rot, per_rot = {}, {}
    for r in (1, -1):
        rot[r], per_rot[r] = counted(lambda r=r: cc.EvalRotate(ct_a, r))
    conj, per_conj = counted(lambda: cc.EvalConjugate(ct_c))
    digits, per_pre = counted(lambda: cc.EvalFastRotationPrecompute(ct_a))
    fast, per_fast = {}, {}
    for r in (1, -1):
        fast[r], per_fast[r] = counted(
            lambda r=r: cc.EvalFastRotation(ct_a, r, 0, digits))
    resc = cc.Rescale(prod)
    prod1, per_mult1 = counted(lambda: cc.EvalMult(resc, resc))
    prod1_u = unfused(resc, resc)
    prod1_r, per_relin1 = counted(lambda: relin(resc, resc))
    rot1, per_rot1 = counted(lambda: cc.EvalRotate(resc, 1))
    resc1 = cc.Rescale(prod1)
    # rotations at the product's scale 2^52, then Rescale
    rot_p = {r: cc.Rescale(cc.EvalRotate(prod, r)) for r in (1, -1)}
    digits_p = cc.EvalFastRotationPrecompute(prod)
    fast_p = {r: cc.Rescale(cc.EvalFastRotation(prod, r, 0, digits_p))
              for r in (1, -1)}
    prod_c = cc.EvalMult(ct_c, ct_b)
    conj_p = cc.Rescale(cc.EvalConjugate(prod_c))
    isum = cc.Rescale(cc.EvalInnerProduct(ct_a, ct_b, SUM_BATCH))
    decv = lambda ct: np.asarray(cc.Decrypt(sk, ct).values)
    dec = cc.Decrypt(sk, resc)
    dec1 = decv(resc1).real
    dec_a, dec_b, dec_c = decv(ct_a), decv(ct_b), decv(ct_c)
    dec_resc_c = decv(cc.Rescale(prod_c))
    dec_rot = {r: decv(rot[r]) for r in rot}
    dec_fast = {r: decv(fast[r]) for r in fast}
    dec_conj = decv(conj)
    dec_rot_p = {r: decv(rot_p[r]) for r in rot_p}
    dec_fast_p = {r: decv(fast_p[r]) for r in fast_p}
    dec_conj_p, dec_isum = decv(conj_p), decv(isum)
    launches = {k: _build.LAUNCHES[k] for k in cases}
    staged_launches = {k: _build.LAUNCHES[k] for k in STAGED}
    path_s = time.perf_counter() - t0
    vals = np.asarray(dec.values)
    require(vals.shape == (cc.slots,) and bool(np.isfinite(vals).all())
            and bool(np.isfinite(dec1).all())
            and bool(np.isfinite(dec_isum).all()),
            "decrypted values are not finite or of the wrong shape")
    err = float(np.abs(vals.real - z * z).max())
    fresh_err = float(np.abs(dec_a.real - z).max())
    mult_err = float(np.abs(vals.real - dec_a.real * dec_b.real).max())
    err1 = float(np.abs(dec1 - z ** 4).max())
    mult_err1 = float(np.abs(dec1 - vals.real ** 2).max())
    print(f"main path: {path_s:.2f} s; launches {launches}; staged forms "
          f"{staged_launches}")
    print(f"per EvalMult (fused) {per_mult}; level 1 {per_mult1}; per "
          f"EvalMultNoRelin + unfused relinearization {per_unfused}")
    print(f"per Relinearize(EvalMultNoRelin) {per_relin}; level 1 "
          f"{per_relin1}; per EvalRotate +1 {per_rot[1]}, -1 {per_rot[-1]}, "
          f"level 1 {per_rot1}; per EvalConjugate {per_conj}")
    print(f"EvalFastRotationPrecompute {per_pre}; EvalFastRotation +1 "
          f"{per_fast[1]}, -1 {per_fast[-1]}")
    print(f"z ~ U(-{Z_MAX}, {Z_MAX}): max |dec(ct) - z| = {fresh_err:.3e}, "
          f"max |dec - dec(a)*dec(b)| = {mult_err:.3e} (limit {MULT_TOL}), "
          f"max |dec - z*z| = {err:.3e} (limit {TOL}); level 1: "
          f"max |dec1 - dec^2| = {mult_err1:.3e} (limit {MULT_TOL}), "
          f"max |dec1 - z^4| = {err1:.3e} (limit {TOL})")

    # words: fused == unfused on the card, at both levels
    same = {"EvalMult": same_words(prod, prod_u),
            "EvalMult, level 1": same_words(prod1, prod1_u),
            "Relinearize": same_words(prod_r, prod_u),
            "Relinearize, level 1": same_words(prod1_r, prod1_u),
            "EvalRotate +1": same_words(rot[1], rotate_unfused(ct_a, 1)),
            "EvalRotate -1": same_words(rot[-1], rotate_unfused(ct_a, -1)),
            "EvalRotate +1, level 1": same_words(rot1,
                                                 rotate_unfused(resc, 1))}
    print(f"fused == unfused chain on the card: {same}")
    require(all(same.values()),
            f"the fused chain differs from the unfused one: {same}")
    require(mult_err <= MULT_TOL and mult_err1 <= MULT_TOL,
            f"EvalMult+Rescale error {mult_err} / {mult_err1} above "
            f"{MULT_TOL}")
    require(err <= TOL and err1 <= TOL,
            f"decryption error {err} / {err1} above {TOL}")

    # decryptions of the automorphisms (see the noise note at the top)
    resc_vals = np.asarray(dec.values)
    hi = {f"EvalRotate {r:+d}": np.abs(dec_rot_p[r]
                                       - np.roll(resc_vals, -r)).max()
          for r in (1, -1)}
    hi.update({f"EvalFastRotation {r:+d}": np.abs(
        dec_fast_p[r] - np.roll(resc_vals, -r)).max() for r in (1, -1)})
    hi["EvalConjugate"] = np.abs(dec_conj_p - np.conj(dec_resc_c)).max()
    mean_slots = modown_mean_slots(cc, sk, ct_a.scale)
    lo = {f"EvalRotate {r:+d}": dec_rot[r] - np.roll(dec_a, -r)
          for r in (1, -1)}
    lo.update({f"EvalFastRotation {r:+d}": dec_fast[r] - np.roll(dec_a, -r)
               for r in (1, -1)})
    lo["EvalConjugate"] = dec_conj - np.conj(dec_c)
    raw = {k: float(np.abs(v).max()) for k, v in lo.items()}
    resid = {k: float(np.abs(v - mean_slots).max()) for k, v in lo.items()}
    ladder = resc_vals.copy()
    j = 1
    while j < SUM_BATCH:
        ladder = ladder + np.roll(ladder, -j)
        j <<= 1
    sum_err = float(np.abs(dec_isum - ladder).max())
    print(f"automorphisms at scale 2^52, then Rescale, against the "
          f"automorphism of dec(Rescale(prod)): "
          f"{ {k: float(v) for k, v in hi.items()} } (limit {MULT_TOL})")
    print(f"automorphisms at level 0 (scale 2^26) against the automorphism "
          f"of dec(ct): max error {raw}; predicted mod-down rounding mean "
          f"max {float(np.abs(mean_slots).max()):.3e}; residual after it "
          f"{resid} (limit {ROT_RESID_TOL})")
    print(f"Rescale(EvalInnerProduct(a, b, {SUM_BATCH})) against the ladder "
          f"on dec(Rescale(prod)): max error {sum_err:.3e} "
          f"(limit {SUM_TOL})")
    require(all(v <= MULT_TOL for v in hi.values()),
            f"automorphism error at scale 2^52 above {MULT_TOL}: {hi}")
    require(all(v <= ROT_RESID_TOL for v in resid.values()),
            f"automorphism error at level 0 beyond the mod-down model: "
            f"{resid}")
    require(sum_err <= SUM_TOL, f"EvalSum error {sum_err} above {SUM_TOL}")

    # launches: each op through its own chain, nothing else
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    require(not any(staged_launches.values()),
            f"the main path ran a staged form: {staged_launches}")
    launches.update(staged_launches)
    want_mult = {k: int(k in MULT_CHAIN) for k in cases}
    want_ks = {k: int(k in KS_CHAIN) for k in cases}
    require(per_mult == want_mult and per_mult1 == want_mult,
            f"EvalMult launches {per_mult} / {per_mult1}, expected "
            f"{want_mult}")
    from openfhe_tpu_torch.trace_evalmult import OWN
    prod3 = cc.EvalMultNoRelin(ct_a, ct_b)
    mult_kernels = device_kernels(lambda: cc.EvalMult(ct_a, ct_b),
                                  MULT_KERNELS)
    own = [k for k in mult_kernels
           if any(f"{o}(" in k or f"{o}<" in k for o in OWN)]
    short = lambda k: (re.search(r"::(\w+(?:<[^<>]*>)?)\(", k)
                       or re.search(r"^(.*)$", k)).group(1)
    print(f"EvalMult on the card: {len(mult_kernels)} device kernels, "
          f"{len(own)} of csrc/: " + ", ".join(map(short, mult_kernels)))
    require(len(mult_kernels) == MULT_KERNELS == len(own),
            f"EvalMult ran {len(mult_kernels)} device kernels ({len(own)} "
            f"of csrc/), expected {MULT_KERNELS}, all of csrc/")
    relin_kernels = device_kernels(lambda: cc.Relinearize(prod3),
                                   RELIN_KERNELS)
    own = [k for k in relin_kernels
           if any(f"{o}(" in k or f"{o}<" in k for o in OWN)]
    print(f"Relinearize on the card: {len(relin_kernels)} device kernels, "
          f"{len(own)} of csrc/: " + ", ".join(map(short, relin_kernels)))
    require(len(relin_kernels) == RELIN_KERNELS == len(own),
            f"Relinearize ran {len(relin_kernels)} device kernels "
            f"({len(own)} of csrc/), expected {RELIN_KERNELS}, all of csrc/")
    for label, got in (("Relinearize", per_relin),
                       ("Relinearize, level 1", per_relin1),
                       ("EvalRotate +1", per_rot[1]),
                       ("EvalRotate -1", per_rot[-1]),
                       ("EvalRotate, level 1", per_rot1),
                       ("EvalConjugate", per_conj)):
        require(got == want_ks, f"{label} launches {got}, expected "
                f"{want_ks}")
    require(per_unfused == {k: 4 * (k in SLICE1) for k in cases},
            f"unfused launches {per_unfused}, expected 4 of each slice-1 "
            "kernel")
    want_hoist = {k: 2 * (k in SLICE1) for k in cases}
    require(per_pre == want_hoist and per_fast[1] == want_hoist
            and per_fast[-1] == want_hoist,
            f"hoisted rotation launches {per_pre} / {per_fast}, expected "
            f"{want_hoist} each")

    times = {
        "evalmult_ms": cuda_ms(lambda: cc.EvalMult(ct_a, ct_b), reps=10),
        "evalmult_unfused_ms": cuda_ms(lambda: unfused(ct_a, ct_b),
                                       reps=10),
        "relinearize_ms": cuda_ms(lambda: cc.Relinearize(prod3), reps=10),
        "relinearize_unfused_ms": cuda_ms(lambda: relin_unfused(prod3),
                                          reps=10),
        "evalrotate_ms": cuda_ms(lambda: cc.EvalRotate(ct_a, 1), reps=10),
        "evalfastrotation_ms": cuda_ms(
            lambda: cc.EvalFastRotation(ct_a, 1, 0, digits), reps=10),
        "evalfastrotation_precompute_ms": cuda_ms(
            lambda: cc.EvalFastRotationPrecompute(ct_a), reps=10),
        f"evalsum{SUM_BATCH}_ms": cuda_ms(
            lambda: cc.EvalSum(ct_a, SUM_BATCH), reps=10),
        "rescale_ms": cuda_ms(lambda: cc.Rescale(prod), reps=10),
        "encrypt_ms": cuda_ms(lambda: cc.Encrypt(kp.public_key, pt),
                              reps=10),
    }
    print(f"op times (median of 10, CUDA events, {card}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))

    # the same EvalMult and one EvalRotate on the port's plain path on the
    # CPU
    t0 = time.perf_counter()
    cpu = fhe.GenCryptoContext(dataclasses.replace(params), seed=7,
                               device="cpu")
    on_cpu_key = lambda ek: EvalKey(bv=ek.bv.cpu(), av=ek.av.cpu(),
                                    key_tag=ek.key_tag)
    cpu.eval_mult_keys[ek_mult.key_tag] = on_cpu_key(ek_mult)
    g1 = rotation_automorphism_index(1, n)
    cpu.InsertEvalAutomorphismKey({g1: on_cpu_key(auto_keys[g1])},
                                  sk.key_tag)
    on_cpu = lambda ct: dataclasses.replace(
        ct, elements=tuple(e.cpu() for e in ct.elements))
    same_mult = same_words(prod, cpu.EvalMult(on_cpu(ct_a), on_cpu(ct_b)))
    same_rot = same_words(rot[1], cpu.EvalRotate(on_cpu(ct_a), 1))
    cpu_s = time.perf_counter() - t0
    print(f"on the card == plain path on the CPU: EvalMult {same_mult}, "
          f"EvalRotate +1 {same_rot} ({cpu_s:.1f} s on the CPU)")
    require(same_mult and same_rot,
            "words on the card differ from the plain path")

    # 5. BinFHE, counted from its context on
    names = tuple(cases) + STAGED + SMALL + BLIND + BLIND_WIDE + SHARDED
    binfhe = binfhe_phase(names)
    per_gate = binfhe["ginx_launches_per_gate"]
    launches.update({k: binfhe["launches"][k] for k in SMALL + BLIND})

    # 6. the limb-sharded path, counted from its first sharded op on
    sharded = sharded_phase(cc, ct_a, ct_b, ct_c, sk,
                            dec_a.real * dec_b.real, top31, gen, names,
                            card)
    launches.update({k: sharded["launches"][k] for k in SHARDED})

    # 7. the leveled CKKS layer, counted from its first context on
    leveled = leveled_phase(card, gen, names, cases, staged)
    per_call = {label: c["launches"] for label, c in leveled["calls"].items()}
    logistic32 = per_call[f"EvalLogistic [-1, 1] degree {FUNC_DEGREE}"]
    logistic119 = per_call[
        f"EvalLogistic [-8, 8] degree {LOGISTIC_WIDE[2]}"]

    # 8. the integer schemes and the extended basis, counted over their
    # runs
    integer = integer_phase(card, gen, names, cases, staged,
                            dict(cc=cc, sk=sk, prod=prod))
    per_int = integer["per_mult"]

    # 9. CKKS bootstrapping, counted over (a)'s two EvalBootstraps
    boot = bootstrap_phase(card, names)

    # 10. BinFHE's composite-Q ring, then scheme switching
    t0 = time.perf_counter()
    wide = wide_binfhe(card, names, gen)
    launches.update({k: wide["launches"][k] for k in BLIND_WIDE})
    switch = scheme_switch_phase(card, names)
    switch_s = time.perf_counter() - t0
    print(f"composite-Q and scheme-switching phase: {switch_s:.1f} s")

    # 11. the protocols, each part counted over its own window
    protocols = protocols_phase(card, names)
    per_proto = protocols["per_op"]

    # 12. the lattice toolbox, the native host library and the examples,
    # each part counted over its own window
    lattice = lattice_phase(card, names, cc, sk, ct_a)
    per_trap = {n: collections.Counter(t["launches_trapdoor_gen"])
                + collections.Counter(t["launches_gauss_samp"])
                for n, t in lattice["trapdoor"].items()}

    # 13. every example at its own parameters, then the full-width set,
    # each counted over its own run
    examples = examples_phase(card)

    # 14. the kernels line, then the device line
    kernels = []
    for name, rows in {**cases, **staged, **small, **blind, **wide["cases"],
                       **sharded["cases"]}.items():
        head = rows[0]        # level 0 / Q (31 towers) / digit 0
        kernels.append(dict(
            name=name, route="cuda",
            source="openfhe_tpu_torch/" + WHERE[name][0],
            replaces=WHERE[name][1], launches=launches[name],
            launches_per_evalmult=per_mult.get(name, 0),
            launches_per_unfused_mult=per_unfused.get(name, 0),
            launches_per_relinearize=per_relin.get(name, 0),
            launches_per_rotate=per_rot[1].get(name, 0),
            launches_per_ginx_gate=per_gate[name],
            launches_per_sharded_mult=sharded["per_mult"][name],
            launches_per_sharded_ntt=sharded["per_ntt"][name],
            launches_leveled_phase=leveled["launches"][name],
            launches_per_logistic32=logistic32.get(name, 0),
            launches_per_logistic119=logistic119.get(name, 0),
            launches_integer_phase=integer["launches"][name],
            launches_per_bgv_mult=per_int["bgv"].get(name, 0),
            launches_per_bfv_mult=per_int["bfv"].get(name, 0),
            launches_per_bv_mult=per_int["bv"].get(name, 0),
            launches_per_bootstrap=boot["launches"].get(name, 0),
            launches_per_cold_bootstrap=boot["boot16"]["cold"][
                "launches"].get(name, 0),
            launches_per_std192_and=wide["per_and"].get(name, 0),
            launches_per_compare_switch=switch["per_compare"].get(name, 0),
            launches_protocols_phase=protocols["launches"].get(name, 0),
            launches_per_threshold_mult=per_proto[
                "threshold EvalMult"].get(name, 0),
            launches_per_reencrypt=per_proto["ReEncrypt INDCPA"].get(name, 0),
            launches_per_intmpboot_round=per_proto[
                "IntMPBoot round"].get(name, 0),
            launches_lattice_phase=lattice["launches"].get(name, 0),
            launches_examples_phase=examples["launches"].get(name, 0),
            **{f"launches_per_trapdoor_gen_and_gauss_samp_{n}": per.get(
                name, 0) for n, per in per_trap.items()},
            launches_per_multiply_arb_4095=lattice["bluestein"][
                "launches"].get(name, 0),
            max_abs_err=max(c["max_abs_err"] for c in rows),
            bit_exact=all(c["max_abs_err"] == 0 for c in rows),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, shape=head["shape"],
            **({k: head[k] for k in ("call_ms", "ntt_cu_ms",
                                      "ntt_cu_call_ms")}
               if name in SMALL else {}),
            **({k: head[k] for k in ("call_ms", "staged_ms",
                                      "staged_call_ms", "launches_per_call",
                                      "cluster")}
               if name in ("ntt_fwd", "ntt_inv") + tuple(FORMER) else {}),
            **({"former": FORMER[name]} if name in FORMER else {}),
            **({"call_ms": head["call_ms"]}
               if name in STAGED + SHARDED_STAGED else {}),
            **({"call_ms": head["call_ms"]}
               if name in BLIND + BLIND_WIDE else {}),
            cases=rows))
    print(json.dumps({"kernels": kernels, "card": card, **times,
                      "decrypt_max_abs_err": err,
                      "mult_vs_decrypted_inputs_err": mult_err,
                      "level1_decrypt_max_abs_err": err1,
                      "level1_mult_err": mult_err1,
                      "automorphism_2e52_err": {k: float(v)
                                                for k, v in hi.items()},
                      "automorphism_level0_err": raw,
                      "automorphism_level0_resid": resid,
                      f"evalsum{SUM_BATCH}_err": sum_err,
                      "binfhe": binfhe,
                      "sharded": {k: sharded[k] for k in (
                          "times", "same", "mult_err", "per_mult_limb2",
                          "seconds")},
                      "leveled": {k: leveled[k] for k in (
                          "calls", "errors", "limits", "deepest_level",
                          "seconds")},
                      "integer": {k: integer[k] for k in (
                          "exact", "errors", "seconds")},
                      "bootstrap": {k: boot[k] for k in (
                          "boot16", "precision_bits", "same",
                          "levels_after", "peak_memory_gb",
                          "fbt_lut_exact", "seconds")},
                      "wide_binfhe": {k: wide[k] for k in (
                          "batch_ms", "gates_per_s", "device_busy_ms",
                          "device_busy_share", "device_launches",
                          "peak_memory_gb", "wrong", "cpu_four_same",
                          "keygen_encrypt_s", "per_and")},
                      "scheme_switch": {k: switch[k] for k in (
                          "ops", "same", "keys_s", "compare_err",
                          "fhew_signs_right", "f2c_stage_errors",
                          "twin_errors", "twin_f2c_stage_errors", "twin_s",
                          "peak_memory_gb")},
                      "switch_phase_s": switch_s,
                      "protocols": {k: protocols[k] for k in (
                          "parts", "steps", "errors", "limits", "exact",
                          "same", "per_op", "flooding_towers",
                          "serialization", "times", "seconds")},
                      "lattice": {k: lattice[k] for k in (
                          "parts", "trapdoor", "same", "field2n",
                          "sampling", "bluestein", "decode", "examples",
                          "seconds")},
                      "examples": examples}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
