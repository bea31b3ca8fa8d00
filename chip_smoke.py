#!/usr/bin/env python3
"""Smoke run of gemmul8_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (each failure raises, so the run exits nonzero and prints no
result):
  1. environment: CUDA present; torch version; card name and power limit;
  2. build: the Hopper kernels from gemmul8_tpu_torch/csrc/, timed;
  3. each kernel against its plain PyTorch version on the card, at
     2048 x 2048 x 2048, a ragged 1000 x 777 x 1500 and a 300 x 5 x 200
     with zeros, -0.0 and subnormals, for 2 to 20 moduli: bit-equal,
     except that a fast-mode shift may differ by 1 where its floored value
     lies within 1e-4 of an integer; reconstruct on residues built to hit its
     rounding branches (ties, subnormals, a round-up into the smallest
     normal, overflow to inf), held to the exact values too; the
     accurate-mode kernels (emax, mag7, magmax_matmul), and encode and
     reconstruct on accurate shifts (an all-zero row and column, a
     subnormal-only row); and accurate_sft on the card against the CPU
     (torch's log2 on each), under the same floor-boundary rule;
  4. the main path in both modes: gemmul8_tpu_torch.gemm at 8192^3, 14
     moduli, f64, on A = phi_matrix(8192, 8192, 0.5, seed=0) and B = A.T,
     fast, then accurate (fastmode=False); for each, the launch counts,
     read right after the call, must show every kernel of its path; three
     256 x 256 tiles must be within 1e-8 of the double-double oracle; and
     at 2048^3 the kernel path must give the bits of the all-plain path;
  5. times (CUDA events, after a warm-up) of each kernel and its plain
     version at the main path's shapes, and of the whole 8192^3 call in
     each mode; the warm-up outputs of each kernel and its plain version
     are held to the same bit rule as in phase 3.

The complex path (complex128, all three compute types) adds to phases 3-5:
  3e. the complex residue GEMM (matmul_complex_mod) in its 4-dot and
      Karatsuba forms, centered and not, against its plain version,
      bit-equal, at 2048^3 (14 moduli), 1000 x 777 x 1500 (2 to 20
      moduli), 300 x 5 x 200 (8, 20), 600 x 600 x 328 (m == k != n) and
      1000 x 4100 x 1500 (2, 14; k over three 2048-wide norm chunks);
      fast_stats (fast_sft's statistics mode) against its plain version:
      emax and the any flag bit-equal, the norm under the floor-boundary
      rule on the shift it gives, per part and jointly over Re and Im;
      mag7 at the complex magnitude shift 4, and the |Re| + |Im|
      magnitudes, against their plain versions;
  4c. gemmul8_tpu_torch.gemm at 8192^3, 14 moduli, on A = ReA + i ImA with
      ReA = phi_matrix(8192, 8192, 0.5, seed=0), ImA the same with seed=1,
      and B = A.T (not conjugated): the three compute types in fast mode,
      Karatsuba and big-matrix in accurate mode; each call's launch counts,
      read right after it, must show its path; the three fast calls give
      identical bits; three 256 x 256 tiles within 1e-8 (|c - ref| / |ref|)
      of a complex double-double oracle built from real dd products over
      the k-concatenation; and at 2048^3 the kernel path gives the bits of
      the all-plain path, in both forms and both modes;
  5c. at 8192^2, 14 moduli: fast_stats on Re and Im of A's rows and B's
      columns, the joint shifts and the shift-4 |Re| + |Im| magnitudes held
      to their plain versions as in 3e; how many shifts accurate mode moves
      from fast mode's; times of these, of matmul_complex_mod (both forms,
      held bit for bit) beside its plain version and of the Karatsuba sum
      slices (plain tensor ops on the card); and each complex 8192^3 call,
      the median of five rounds in rotated order, with two rates: the
      reference's element-op convention 2mnk/t and real flops 8mnk/t.

The opt-in variants (the JAX package's switches, read at call time) add:
  3v. each variant kernel against its plain version on the card, at
      phase 3's shapes and 1000 x 4100 x 1500 (2, 14 moduli; k over three
      2048-wide norm chunks): fast_encode_fused's slices bit-equal and its
      shifts bit-equal to the fast_sft kernel's (and under the floor rule
      to the plain version's); mag7_fused, magmax_matmul_scratch and
      matmul_mod_u8_pipelined bit-equal, the last also to matmul_mod_u8's
      uncentered output, on the ragged and tiny shapes too;
  4v. at 8192^3, 14 moduli, on phase 4's operands, one call per variant:
      fast under GEMMUL8_FUSED_ENCODE=1, fast under GEMMUL8_MM_PIPELINE=1
      with GEMMUL8_MXU_CRT=0, accurate under GEMMUL8_FUSED_MAG7=1 with
      GEMMUL8_MAGMAX_SCRATCH=1; each returns exactly the default call's
      bits, its launch counts show the variant kernel and not the one it
      replaces, and its gate is < 1e-8; then a 2048^3 complex accurate call
      under GEMMUL8_MAGMAX_SCRATCH=1, bit-equal to the default. The
      switches are set inside the process and restored after each call;
  5v. at 8192^2 operands, 14 moduli: each variant kernel beside the default
      kernels it replaces (medians of three rounds in rotated order; the
      fused stats kernels also per operand, A's rows and B's columns) and
      its plain version, the warm-up outputs held bit for bit; then each
      variant call at 8192^3 against the default call of its mode, the
      median of three rounds in rotated order.

The low-memory schedule, the limb input and the two CRT-fused GEMMs add:
  3s. on the card against the plain versions, bit-equal, at phase 3's shapes
      and 2, 8, 14, 20 moduli: encode_slices and matmul_mod_u8 (and its
      pipelined variant) on subsets of the moduli (the chunks of
      ModuliSchedule(L, 5), the 256 lane alone, a tuple out of order);
      reconstruct from 16-bit limbs (canonical, and with a carry pushed
      back into a lower limb) and from raw int32 slice products, on phase
      3's rounding-branch values too; matmul_crt (limbs equal, each in
      [0, 65535]); matmul_reconstruct, equal to matmul_mod_u8 + reconstruct
      as well; the in-place chunk fold on the card;
  4s. at 8192^3, 14 moduli, on phase 4's operands: gemm(moduli_chunk=5)
      fast and accurate and one gemm(max_workspace_bytes=...) whose budget
      the planner turns into 4 chunks: each returns the one-shot call's
      bits, its launch counts show one encode_slices pair and one
      matmul_mod_u8 per chunk and one reconstruct, and its peak of device
      memory above what was allocated before the call is below the one-shot
      call's and within planner.workspace_bytes; then
      GEMMUL8_FUSED_RECONSTRUCT=1 fast and accurate (matmul_reconstruct 1,
      matmul_mod_u8 0, reconstruct 0) and fast_sft -> encode_slices ->
      matmul_crt -> reconstruct from limbs: the default call's bits, gate
      < 1e-8; and each of these at 2048^3 against the all-plain path;
  5s. times at 8192^2 operands, 14 moduli (medians of three rounds in
      rotated order): matmul_crt, matmul_reconstruct and limb-input
      reconstruct beside matmul_mod_u8 and reconstruct and beside their
      plain versions (warm-up outputs held bit for bit), and
      matmul_reconstruct against matmul_mod_u8 + reconstruct over ten
      alternating rounds; encode_slices on
      13 moduli in its three forms; the chunk fold; then the chunked calls
      (chunk 5 and chunk 1) and the FUSED_RECONSTRUCT call beside the
      default call of their mode.

The panel/rider pipeline (GEMMUL8_PIPELINE 1-3) and the column-panel
schedule (n_panel) add:
  3p. on the card against the plain versions, bit-equal: the rider step
      with no rider, the reconstruct rider, the encode rider and both (its
      first launch also copying B K-major), at 2048^3 (2 panels), 768 x 384
      x 1024 (3 panels of 256; 2, 8, 14, 20 moduli) and 1536 x 1024 x 1024
      (3 panels of 512); the B-split pair with and without the A-panel-1
      rider; encode_slices(col_tiles=), also at phase 3's ragged 1000 x
      1500; reconstruct(out=) and reconstruct_into into rows of a larger
      output; the rider kernel's edges in every word form of both entry
      points: a pair whose column half (640) is not a multiple of the
      256-wide tile (launch 0a's last tile straddles the columns its riders
      write), run three times with every run bit-equal, and ragged panels
      of 200 rows with k = 272 and n = 1000 at 2, 14 and 20 moduli;
  3g. every entry of tests/data/torch_golden.npz (the JAX package's shifts
      and output digests for ragged real, complex and pipelined calls)
      recomputed with the kernels: the same shifts and bits;
  4p. at 8192^3, 14 moduli, on phase 4's operands: GEMMUL8_PIPELINE=1, 2
      and 3 fast, 1 and 3 accurate (choose_panels gives 8 panels of 1024
      rows; mode 3's B split applies), and a 8192 x 8192 x 16384 call (B =
      phi_matrix(8192, 16384, 0.5, seed=2)) with n_panel=4096, pipeline
      off and at 1: each returns the one-shot call's bits, its launch
      counts show its path, its gate is < 1e-8, and its peak of device
      memory above the operands is logged beside the one-shot call's; then
      each at 2048^3 against the all-plain path;
  5p. at 8192^2 operands, 14 moduli, panels of 1024 rows (medians of five
      rounds in rotated order): the rider step in its four forms beside
      what it replaces on one panel (matmul_mod_u8, reconstruct and
      encode_slices of one panel), the pair beside panel 0's matmul_mod_u8
      and the encode of B's right half and A's panel 1, reconstruct_into
      beside reconstruct of one panel, the step and the pair beside
      torch._int_mm over the panel's products (ratios printed), and each
      beside its plain version (warm-up outputs held bit for bit); then
      each pipelined call against the default call of its mode, and the
      n_panel calls against the one-shot 16384-column call, each with its
      ratio to that call.
Phase 4s also holds each measured peak of the one-shot and chunked calls
to the planner's figure: at or under it, and within 5%.

The real front end (f32 and mixed operands, f32 output, op N/T/C,
alpha/beta) and the f32 forms of fast_sft, encode_slices, emax, mag7 and
reconstruct add:
  3f. each f32 form against its plain version on f32 operands, bit-equal
      (fast_sft under the floor rule), at 2048^3 (8 moduli), 1000 x 777 x
      1500 (2 to 20 moduli), 300 x 5 x 200 and 1000 x 4100 x 1500 (k over
      three norm chunks), with f32 special lines (zero, subnormal-only rows
      and columns, subnormals inside normal lines, mixed exponents, values
      near FLT_MAX): the encode on every modulus, on subsets and on column
      ranges; reconstruct with f32 output on the residues of their slices,
      on fast and accurate shifts;
  3b (f32). reconstruct with f32 output from uint8, int8, int32 products
      and limbs on values built to hit its rounding branches (f32 ties and
      one away on each side, integers where rounding through f64 would round
      twice, subnormal results, overflow to inf), held to its plain version
      and to the exactly rounded values (`exact_f32`);
  3g. the golden file's f32, mixed, alpha/beta and op T entries too;
  4f. at 2048^3, every front-end combination (f32/f64 operands in each
      order, f16 and bf16 widened, f32/f64 output, fast and accurate, op
      T/C, alpha/beta and the pow2 fold, moduli_chunk=3, n_panel=1024)
      bit-equal to the all-plain path, its epilogue to numpy's separate
      roundings; at 8192^3 on A = phi_matrix(8192, 8192, 0.5, seed=0) cast
      to f32 and B = A.T: f32 -> f32 at 8 moduli fast and accurate (launch
      counts of the f32 forms asserted; median relerr of the three gate
      tiles < 2e-7 against the dd oracle of the f32 operands), f64 x f32 ->
      f64 at 14 moduli (gate < 1e-8), alpha=1.7 beta=-0.3 with C in f64 and
      f32 output (numpy's epilogue on the raw call's bits), op_a="T" (the op
      N call's bits), peak memory beside the planner's figure;
  5f. at 8192^2 operands, 8 moduli: each f32 form beside its f64 form
      (medians of five rotated rounds) and its plain version (warm-up
      outputs held bit for bit); then the f32 and f64 fast-8 and
      accurate-8 calls and torch.matmul in f32 with TF32 off, medians of
      five rotated rounds, as 2mnk/t.
The f32 forms' `launches` sum the 8192^3 calls of phase 4f.

The complex front end (complex64 and mixed complex operands, complex64
output, op T/C, complex alpha/beta) and the f32 forms of fast_sft's
statistics mode, fast_encode_fused, mag7_fused and matmul_reconstruct add:
  3x. at phase 3f's shapes, moduli counts and special lines: the f32
      statistics of each of four f32 parts (emax and flag bit-equal, the
      norm under the floor rule) and the joint f32 shift; the f32 |Re| +
      |Im| magnitudes; fast_encode_fused[f32] (shifts equal to the fast_sft
      kernel's, slices bit-equal), mag7_fused[f32] (also the emax + mag7
      kernels' bits) and matmul_reconstruct[f32] (also matmul_mod_u8 +
      reconstruct's bits) against their plain versions;
  3g. the golden file's complex64, complex128 x complex64 and f32-under-
      switch entries too;
  4x. at 8192^3 on A64 = complex64(A) (phase 4c's A rounded) and B64 =
      A64.T: complex64 -> complex64 at 8 moduli, three strategies fast and
      Karatsuba and big-matrix accurate, with launch counts (fast:
      fast_stats[f32] 4, encode_slices[f32] 4, matmul_complex_mod 1,
      reconstruct[f32] 2), median relerr of three 256 x 256 tiles < 2e-7
      against the dd oracle of the complex64 operands, the fast strategies'
      bits identical; complex128 x complex64 -> complex128 at 14 moduli
      (each operand's forms launched, max relerr < 1e-8); op_a="C" on
      numpy's conj(A64).T (the op N call's bits); alpha=1.5-0.5j,
      beta=0.25+2j with a complex64 c (numpy's separate f32 roundings on
      the host, on the raw call's bits); f32 x f32 -> f32 at 8 moduli under
      GEMMUL8_FUSED_ENCODE, GEMMUL8_FUSED_MAG7 and GEMMUL8_FUSED_RECONSTRUCT
      (the variant's f32 form launched, the default call's bits); then at
      2048^3 complex64 (both modes, classic and Karatsuba) and complex128 x
      complex64 through the kernels == the all-plain path (bits);
  5x. at 8192^2 operands, 8 moduli: fast_stats[f32] on the four parts
      beside the f64 statistics on four f64 parts; fast_encode_fused[f32]
      and mag7_fused[f32] on A's rows and B's columns beside their f64
      forms and the f32 pairs they replace; matmul_reconstruct[f32] beside
      its f64 output and matmul_mod_u8 + reconstruct[f32] (medians of five
      rotated rounds), each beside its plain version (warm-up outputs held:
      bit for bit, shifts under the floor rule); the bounds of the f64
      statistics mode and of the Karatsuba complex GEMM; then the complex64
      8192^3 calls and torch.matmul in complex64 with TF32 off, medians of
      five rotated rounds, as 2mnk/t and 8mnk/t.
The new f32 forms' `launches` sum the 8192^3 calls of phase 4x (and the
statistics mode's f32 form is an entry of its own).

The riders' f32 forms (f32 and mixed operands and f32 output under
GEMMUL8_PIPELINE and n_panel) and the batched and timed entry points add:
  3r. at phase 3p's shapes and moduli, with phase 3's f64 and phase 3f's
      f32 special lines copied into every A panel and B's right half: the
      rider step in each new (A word, output word) form (launch keys
      matmul_rider_step[f32,f64], [f64,f32], [f32,f32]) with each rider
      combination, on its operands' residues and on random ones, with and
      without out=; the pair in each new (A word, B word) form; and
      reconstruct_into[f32]: bit-equal to their plain versions;
  4r. at 8192^3, no cut: f32 x f32 -> f32 at 8 moduli under PIPELINE 1, 2
      and 3 fast and 1 accurate, f64 x f32 -> f64 (14 moduli, PIPELINE 3),
      f32 x f64 -> f32 (8, PIPELINE 2), f32 x f64 -> f64 (14, PIPELINE 3),
      f64 x f64 -> f32 (8, PIPELINE 2) and an f32 8192 x 8192 x 16384 call
      with n_panel=4096 under PIPELINE=1: each bit-equal to its one-shot
      call, its launch counts asserted (each form of the step and the pair
      and reconstruct_into[f32] launched), its peak memory beside the
      one-shot call's;
  4b. gemm_batched on 2 x 8192^3: f64 fast at 14 moduli and complex64 at
      8, each element gemm's bits, launch counts asserted; gemm_timed and
      gemm(return_times=True) at 8192^3, f64 at 14 moduli and f32 at 8:
      gemm's bits, four phase times >= 0, the mod phase under 1% of their
      sum;
  5r. at 8192^2 operands, panels of 1024 rows: each new form beside its
      f64 form on the same residues (medians of five rotated rounds) and
      its plain version (warm-up outputs held bit for bit), at the moduli
      its main-path call takes, the step's and the pair's forms also
      beside torch._int_mm over their own products; then each phase 4r
      call beside its one-shot call, five rotated rounds;
  5b. each batched call per element beside the single calls of its
      elements; each timed call's four phases (iters=5) and their sum
      beside the fused call's median.
The new forms' `launches` sum the calls of phase 4r. Phase 5 also times
torch._int_mm on the same int8 slices, once per modulus (the product
without the mod epilogue), as matmul_mod_u8's `library_ms`.

The probes (scripts/probe_*.py, ROADMAP B16) add:
  3q. each probe kernel against its plain version, bit for bit: clz on
      edge words and 2^26 random words (the exponent form on as many
      16-bit limbs); the nine op chains at STEPS 64; mxu_crt's four
      variants at L = 2, 8, 14, 20, bm 8 and 16, m = 1024, n = 1024 and a
      ragged 1000; deaddep's eight variants at n = 2048, 14 moduli (its
      residues also equal to matmul_mod_u8's; hbmio's words; the rec
      riders' f64 words, which the plain version takes from the port's
      plain reconstruct with shifts 0);
  4q. the probes' main path: `python -m gemmul8_tpu_torch.probes` clz,
      vpu_ops, mxu_crt and deaddep (8192, 14 moduli, nops 0 16 32 -1 -2)
      with each script's defaults, each with the launch counts reset just
      before it and read just after: every variant it runs launched;
  5q. times at the probes' own sizes, medians of three rotated rounds:
      clz and the f32-exponent trick on 2^26 limb words; the nine chains
      at STEPS 2048 with T op/s (JAX count), their SASS instruction
      counts (cuobjdump -sass) and bounds at the SM clock sampled
      meanwhile; mxu_crt's variants at 8192^2, 14 moduli, bm 16 beside
      their bound, reconstruct on the same residues and torch._int_mm of
      W' by the residues laid out (L bm, m/bm n); deaddep at 8192, 14
      moduli, every chain variant (kloop too) at nops 0, 16 and 32, base
      and the two rec riders: medians of five rotated rounds, and each
      config's differences to base (a chain's also to its own nops 0,
      recmxu's to recbody) over 8 adjacent pairs of calls as median
      [least, most], and its launch span in SM clock cycles (median of
      five calls; each block stamps its SM and clock), beside the
      injected multiply-adds' serial time; every
      kernel's output at these sizes held to its plain version, every
      deaddep config's too (residues, aux, hbmio's words, the rec riders'
      f64 words).
The probes' `launches` sum their variants' keys over phase 4q's calls;
their line's ms is clz's __clz form, the nine chains' sum, mxu_crt's full
variant and deaddep at nops 16. The run's wall time is printed before the
kernels line.

The wgmma tile of matmul_mod_u8 (csrc/matmul_mod.cu on csrc/wgmma_s8.cuh,
its launch from gemmul8_tpu_torch/hopper/launch.py) adds:
  2.  the ptxas report of csrc/matmul_mod.cu (registers, shared memory and
      spills of each kernel, `-Xptxas -v`);
  3w. matmul_mod_u8 against its plain version, centered and not, bit for
      bit, at the tile's edge shapes (m, k, n) = (1, 16, 1), (65, 144,
      257), (200, 4100, 129) and (1000, 4100, 1500) at L = 1, 14 and 20;
      with moduli_idx = (3, 7, 11); at k = 2^17, m = n = 128, L = 20 with
      the modulus-256 slice all -128 (its products exactly 2^31, which the
      int32 accumulator wraps) and the odd slices at +-127 (their largest
      products, 127^2 * 2^17), and with random slices at the same k; and
      the epilogue's multiply-and-shift division against mod_canon on the
      card for every int32 (a superset of the reachable
      [-127^2 * 2^17, 127^2 * 2^17]), every modulus;
  4c. (also) the peak device memory above the operands of every complex
      strategy, fast and accurate, complex128 and complex64 (A and B
      rounded), at 8192^3 and at the ragged (m, k, n) = (1000, 4100,
      1500), 14 moduli: each complex128 peak at or under
      planner.workspace_bytes and within 5% of it, each complex64 peak at
      or under it (the planner counts 8-byte words);
  5.  (also) matmul_mod_u8 beside torch._int_mm x L in one rotation: the
      ratio of the two and the share of the bound each reaches.

The ping-pong matmul_mod_u8_pipelined (csrc/matmul_mod_pipelined.cu) and
the chained matmul_complex_mod (csrc/matmul_complex.cu), both on the wgmma
tile, add:
  2.  (also) both sources' ptxas reports, each asserted free of spill
      stores and loads (`build.spill_bytes`);
  3e. (also) matmul_complex_mod at its k limit, 2^16, on extreme slices
      at 65 x 130, L = 20: all -128 (IR + RI exactly 2^31), all 127, mixed
      signs (Karatsuba's G - E - F past 2^31), -128 in the odd lanes only;
      both forms, centered and not, bit-equal to the plain version;
  3v. (also) matmul_mod_u8_pipelined at (m, k, n) = (300, 2^17, 520), L =
      20 (the 256 lane all -128, its products wrapping, the odd lanes at
      +-127; then random slices) and at a ragged (777, 1000, 1333), L =
      14: three runs each, bit-equal to each other, to the plain version
      and to matmul_mod_u8(centered=False);
  5c, 5v. (as before) each beside torch._int_mm over its own products in
      one rotation, the pipelined kernel also beside
      matmul_mod_u8(centered=False).

The encode and reconstruct kernels on the int8 tensor cores
(csrc/encode_mma.cuh, csrc/crt_mma.cuh, csrc/crt_tail.cuh) and the real
planner at a ragged k add:
  2.  (also) the ptxas reports of csrc/encode.cu and csrc/reconstruct.cu;
  3m. encode_slices and reconstruct against their plain versions, bit for
      bit, at every moduli count 2..20, on 301 x 203 (ragged: byte loads
      and stores) and 64 x 1100: encode in f64 and f32, both axes, all
      moduli, a range, a tuple out of order and a column range;
      reconstruct from int8, uint8, int32 products and limbs, to f64 and
      f32, and into the rows of a larger output;
  4s. (also) the fast call at the ragged (m, k, n) = (1000, 4100, 1500),
      14 moduli, one-shot and moduli_chunk=5: each peak at or under
      planner.workspace_bytes and within 5% of it;
  5.  (also) each kernel's time beside its time before the redesign
      (EARLIER_MS, from PERF.md), the two kernels' SASS loops by
      instruction class (cuobjdump -sass), and the fast, accurate and f32
      fast-8 calls at 8192^3 in one rotation; beside matmul_mod_u8_pipelined,
      magmax_matmul(_scratch), matmul_complex_mod (4-dot, Karatsuba),
      matmul_crt, matmul_reconstruct and one panel of the rider step and
      the pair, torch._int_mm over the same int8 products (x L, x 1, x 4L
      or x 3L) in the kernel's rotation, as their `library_ms`; and the
      kernels slower than their library call, slowest first.

matmul_reconstruct and the deaddep probe on the wgmma tile
(csrc/matmul_reconstruct.cu: the products on matmul_mod's tile, each
tile's CRT on the tensor-core bodies after its products;
csrc/probe_deaddep.cu: matmul_mod's kernel with the injected work) add:
  2.  (also) both sources' ptxas reports, each asserted free of spill
      stores and loads;
  3w. (also) matmul_reconstruct in both output words against its plain
      version and against matmul_mod_u8 + reconstruct, bit for bit, at the
      tile's edge shapes (m, k, n) = (1, 16, 1), (65, 144, 257), (200,
      4100, 129), (1000, 4100, 1500) at 2, 14 and 20 moduli, at every
      moduli count 2..20 on (65, 144, 257), at k = 2^17, m = n = 128, 20
      moduli with the 256 slice's products exactly 2^31 (wrapped) and the
      odd slices at +-127, and with random slices; (1000, 4100, 1500) at
      14 moduli run three times, every run bit-equal;
  3q. (also) every deaddep variant at n = 1024 too (kloop's chain two
      batches a k-tile);
  4s. (also) the FUSED_RECONSTRUCT calls' peaks beside the one-shot
      call's;
  5q. (also) deaddep's base beside matmul_mod_u8 in the configs'
      rotation with torch._int_mm x 14, and each chain config's span over
      its nops 0 span as a share of its injected multiply-adds' serial
      time;
  5s. (also) torch._int_mm x 14 in the ten-round rotation of
      matmul_reconstruct and matmul_mod_u8 + reconstruct.

matmul_crt and the magnitude GEMM on the wgmma tile (csrc/matmul_crt.cu:
matmul_reconstruct's walk and chunks, each chunk's CRT sums carried into
canonical limbs and stored; csrc/magmax.cu: the cooperative tile at one
slice with a row and column max epilogue; no source runs the mma.sync
GEMM tile any more) add:
  2.  (also) both sources' ptxas reports, each asserted free of spill
      stores and loads;
  3w. (also) matmul_crt against its plain version, bit for bit, every limb
      in [0, 2^16), at the tile's edge shapes at 2, 14 and 20 moduli, at
      every moduli count 2..20 on (65, 144, 257), at k = 2^17 (the 256
      slice wrapped, the odd slices at +-127; random slices) and three
      runs of (1000, 4100, 1500) at 14 moduli; magmax_matmul and
      magmax_matmul_scratch against their plain version at the edge
      shapes, from contiguous operands and from K-major buffers 48 bytes
      wider than k whose bytes past k hold 64, and at k = 2^17 with every
      magnitude 64 (products 2^29);
  5, 5v, 5s. (also) the median SM clock and power draw (nvidia-smi every
      20 ms) beside the variant kernels' rotations, the schedule kernels'
      rotation and the main calls' rotation; magmax in both forms beside
      torch._int_mm x 1 and matmul_crt beside torch._int_mm x 14 and
      matmul_reconstruct, each as a ratio in its rotation; the accurate
      call beside its time before (EARLIER_ACCURATE_MS, from PERF.md).

fast_encode_fused on the tensor-core encode body and mag7_fused reading
its operand once (csrc/fast_encode_fused.cu, csrc/mag7.cu) add:
  2.  (also) both sources' ptxas reports, each asserted free of spill
      stores and loads;
  3v. (also) both kernels in both words at FUSED_EDGE_CASES: 17 and 20
      moduli (two slot tiles), f64 rows of 2^17 elements (past the row's
      staged part) and a single column, strips of 100 columns over two
      norm chunks and a partial one, one column; each operand as made and
      with late-max lines (the max last and 40 binades up, zeros then a
      subnormal, -0.0): the shifts the fast_sft kernel's bits, the slices
      and magnitudes (shifts 5 and 4) the plain versions', the magnitudes
      and exponents the emax + mag7 kernels';
  5v. (also) each kernel's halves as shares of their read-once bounds
      (B's encode also of its read-twice bound, (2 x 8 + 14) bytes an
      element) beside the pair's time for the half and the SM clock.

fast_sft's column statistics reading each word once (a running exponent
frame, a chunk a block, the chunks merged in a cluster; csrc/fast_sft.cu,
csrc/fast_stats.cuh) add:
  2.  (also) fast_sft.cu's ptxas report, asserted free of spills;
  3v. (also) a fourth late-max line: the max last and 70 binades up, in a
      later chunk than the line's first nonzero; fast_sft's statistics
      mode held to its plain version on every FUSED_EDGE_CASES operand
      beside fast_sft (through fast_encode_fused's shifts) and
      fast_encode_fused, in both words;
  5, 5c, 5f, 5x. (also) each half of fast_sft (5: f64, 5f: f32) and of
      its statistics mode (5c: the f64 parts, 5x: the f32 parts), A's rows
      and B's columns timed apart beside emax on the same operands in one
      rotation (head started, so the host's launches never hold the card
      back), each as a share of its read-once bound, with the rotation's
      SM clock and power draw.
`python3 chip_smoke.py halves` builds the kernels and prints only those
halves lines and phase 5v's fast_encode_fused halves (no result line), for
before-and-after runs of two trees in one call.

The comparison harness and its baselines (gemmul8_tpu_torch.bench.harness,
baselines/ozimmu.py, ops/mpgemm.py; no kernel of their own: OS-I's
products are torch._int_mm, mpgemm's bf16 torch.mm with an f32 result)
add:
  3h. on the card against the same functions on the host's CPU:
      ozimmu_gemm bit for bit at 2048^3 (8 and 9 slices) and at a ragged
      1000 x 777 x 1500 with zeros, -0.0 and subnormals (3, 8, 13; the
      card pads torch._int_mm's operands), ozimmu_zgemm at 300 x 130 x
      200 (9), mantissa_loss_stats, auto_num_split and exp_stats equal;
      mp_gemm in its six modes and mp_cgemm: float32 (complex64) out,
      within 1e-6 of the CPU's per |A||B| and inside
      tests/test_mpgemm.py's ladder bands of the dd oracle;
  4h. harness.accuracy_check d at the reference's scale (m = n = 1024, k =
      8192, phi 0.5, fast and accurate at test_scale_bands.py's L), every
      row inside that file's band rule; a 256 x 1024 x 256 check at L = 8,
      14, 20 whose OS2 rows equal the CPU run's exactly; a saved case
      replayed on the card and on the CPU to the same C;
  5h. harness.time_check d (8192, 14 moduli, fast and accurate: DGEMM,
      INT8-GEMM, OS2 rows with their phases, OS2-fast-14-axpby,
      OS1-EF-8/9), time_check f (8 moduli: SGEMM, BF16X3-SCALING),
      time_check_complex (complex64 8192^3, 8 moduli, three strategies)
      and watt_check of the OS2-fast-14 row (at least 10 s, the instant
      power draw every 100 ms): each row with the SM clock and power draw sampled
      while its own timed calls ran; the OS2-fast-14 row within 10% of phase 5's fast call;
      OS1-EF-8/9 split into slicing, int8 products and the rest.

Interception and the sharded engine (gemmul8_tpu_torch.interception and
gemmul8_tpu_torch.parallel; no kernel of their own) add:
  4i. under override_matmuls(profile=True) at 8192^3 on phase 4's
      operands: A @ B, torch.matmul, torch.einsum("ij,jk->ik") and
      torch.mm, each with phase 4's fast bits and FAST_LAUNCHES; four
      profile records with seconds > 0, and a 32 x 32 call native with no
      launch; one accurate call with phase 4's accurate bits and
      ACCURATE_LAUNCHES; A @ B after the context launches nothing; the
      intercepted call beside gemm in one rotation, with the SM clock;
  4d. a child process (`chip_smoke.py sharded-child`): a world of one rank
      on NCCL from GEMMUL8_COORD (a free local port), GEMMUL8_NPROC 1 and
      GEMMUL8_PROC_ID 0, a 1x1 mesh; gemm_sharded at 8192^3 fast and
      accurate with phase 4's bits (blake2b digests) and the sharded
      launch counts (fast_stats, encode_slices, matmul_mod_u8,
      reconstruct; emax, mag7, no magmax_matmul); gemm_sharded_complex at
      2048^3 in the three strategies with the complex gemm's bits; the
      sharded calls beside gemm in one rotation, with the SM clock, and a
      torch.profiler breakdown of one call of each. Then four processes
      (`chip_smoke.py gloo-child`) share this card over gloo, which moves
      the engine's collectives on CUDA tensors through host memory (NCCL
      needs a card a rank; `python3 -m gemmul8_tpu_torch.parallel.smoke
      --gloo-cuda 2` found gloo taking all three on the H100 host): a 2x2
      mesh at 8192^3 global in both modes, launch counts on every rank,
      the tiles gathered and assembled on rank 0 with phase 4's bits (a
      fast word may differ only where its row's or column's shift lies
      at a floor boundary, within 1e-8 of phase 4's word).
`python3 chip_smoke.py sharded` builds the kernels and runs phases 4, 4i
and 4d alone (no result line).

The drivers (gemmul8_tpu_torch.scripts and .examples; no kernel of their
own) add, each through its `main(argv)`, writing into a temporary
directory:
  6a. accuracy_sweep's d protocol at m = 1024, k in {1024, 8192}, phi in
      {0.5, 4}, L 2..20, both modes, its DGEMM rows at k 8192, phi 0.5
      inside tests/test_scale_bands.py's rule (one line a check); the
      card's outputs bit-equal to the CPU's plain path (fast shifts under
      the floor-boundary rule, accurate ones where the card's log2 and the
      CPU's part at a floor boundary) at k 8192, phi 4, L 14 in both
      modes, and at k 1024, phi 0.5, L 2 and 20 fast;
  6b. time_sweep 1024,4096 d: its rows with the SM clock and power draw;
  6c. scale_bench 16384 4096 14 3: the n_panel call bit-equal to the
      one-shot call, the tile gate < 1e-8, both calls' ms, TFLOP/s and peak
      device memory;
  6d. profile_phases 8192 14: each kernel's time with the SM clock, and
      the output's bits equal to phase 4's fast call (digests);
  6e. profile_one_call --iters 3: the Chrome trace written and not empty,
      the key_averages() table printed (a line says so where it shows no
      CUDA device time), and the per-call ms by CUDA events.
Each part's wall time is printed. `python3 chip_smoke.py drivers` builds
the kernels and runs phase 6 alone on phase 4's fast call (no result
line).

The line before the last is a JSON object of per-kernel results
(`launches` sums the main-path calls of phase 4, real and complex, for the
variant kernels those of phase 4v at 8192^3, for matmul_crt and
matmul_reconstruct those of phase 4s at 8192^3, and for the pipeline's
kernels those of phase 4p at 8192^3; the statistics mode of fast_sft
counts as fast_sft); `bound_ms` is the least time the card could take for
the phase-5 work, from the bytes the function must move at 3.35 TB/s or
its int8 operations at 1,979 TOPS, whichever is larger (the chains: their
instructions at the table's rates, see VPU_RATE); `library_ms` is
torch._int_mm's time over the kernel's int8 products for the GEMMs
(matmul_mod_u8 and its pipelined variant, magmax_matmul and its scratch
variant, matmul_complex_mod, matmul_crt, matmul_reconstruct, the rider
step and the pair) and for mxu_crt, and null elsewhere (no single PyTorch
call computes those functions). The last line is
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import functools
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from fractions import Fraction

import numpy as np
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch import interception as icept
from gemmul8_tpu_torch import pipelined as pl
from gemmul8_tpu_torch import planner, tables
from gemmul8_tpu_torch.baselines import ozimmu
from gemmul8_tpu_torch.bench import golden, harness, replay
from gemmul8_tpu_torch.bench.matrices import phi_matrix
from gemmul8_tpu_torch.bench.native import dd_gemm, relerr_vs_dd
from gemmul8_tpu_torch.bench.power import ClockSampler
from gemmul8_tpu_torch.core import complexgemm as cg
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.core import reconstruct as rec
from gemmul8_tpu_torch.core import riders
from gemmul8_tpu_torch.core import slicegemm as sg
from gemmul8_tpu_torch.examples import profile_one_call
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import launch as hl
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.hopper import pipelined as hp
from gemmul8_tpu_torch.hopper import probes as hq
from gemmul8_tpu_torch.ops import mpgemm as mp
from gemmul8_tpu_torch.probes import clz as pclz
from gemmul8_tpu_torch.probes import deaddep as pdd
from gemmul8_tpu_torch.probes import mxu_crt as pmxu
from gemmul8_tpu_torch.probes import vpu_ops as pvpu
from gemmul8_tpu_torch.probes.__main__ import main as probes_main
from gemmul8_tpu_torch.scripts import (accuracy_sweep, profile_phases,
                                       scale_bench, time_sweep)

DEVICE = "cuda"
N = 8192                 # the main path's m = n = k
N_PLAIN = 2048           # where the kernel path is held to the plain path
L_MAIN = 14
# (m, k, n), moduli counts, special values: phase 3's kernel checks
CASES = [((2048, 2048, 2048), (L_MAIN,), False),
         ((1000, 777, 1500), (2, 8, 14, 20), True),
         ((300, 5, 200), (8, 20), True)]
SHIFT_RULE_FRAC = 1e-4
# phase 3m: the kernels redesigned on the tensor cores (encode_slices,
# reconstruct) at every moduli count, on a ragged shape (m n odd: byte
# loads, byte stores at the rows' ends) and a wide one (a column range)
MMA_SHAPES = ((301, 203), (64, 1100))
MMA_LS = tuple(range(2, tables.MAX_MODULI + 1))
KERNELS = {
    "fast_sft": ("gemmul8_tpu_torch/csrc/fast_sft.cu",
                 "gemmul8_tpu/pallas/kernels.py:54"),
    "encode_slices": ("gemmul8_tpu_torch/csrc/encode.cu",
                      "gemmul8_tpu/pallas/kernels.py:691"),
    "matmul_mod_u8": ("gemmul8_tpu_torch/csrc/matmul_mod.cu",
                      "gemmul8_tpu/pallas/matmul.py:95"),
    "reconstruct": ("gemmul8_tpu_torch/csrc/reconstruct.cu",
                    "gemmul8_tpu/pallas/kernels.py:956"),
    "emax": ("gemmul8_tpu_torch/csrc/mag7.cu",
             "gemmul8_tpu/pallas/kernels.py:333"),
    "mag7": ("gemmul8_tpu_torch/csrc/mag7.cu",
             "gemmul8_tpu/pallas/kernels.py:408"),
    "magmax_matmul": ("gemmul8_tpu_torch/csrc/magmax.cu",
                      "gemmul8_tpu/pallas/matmul.py:393"),
    "matmul_complex_mod": ("gemmul8_tpu_torch/csrc/matmul_complex.cu",
                           "gemmul8_tpu/pallas/matmul.py:492"),
    "fast_encode_fused": ("gemmul8_tpu_torch/csrc/fast_encode_fused.cu",
                          "gemmul8_tpu/pallas/kernels.py:209"),
    "mag7_fused": ("gemmul8_tpu_torch/csrc/mag7.cu",
                   "gemmul8_tpu/pallas/kernels.py:465"),
    "magmax_matmul_scratch": ("gemmul8_tpu_torch/csrc/magmax.cu",
                              "gemmul8_tpu/pallas/matmul.py:312"),
    "matmul_mod_u8_pipelined": (
        "gemmul8_tpu_torch/csrc/matmul_mod_pipelined.cu",
        "gemmul8_tpu/pallas/matmul.py:188"),
    "matmul_crt": ("gemmul8_tpu_torch/csrc/matmul_crt.cu",
                   "gemmul8_tpu/pallas/matmul.py:637"),
    "matmul_reconstruct": ("gemmul8_tpu_torch/csrc/matmul_reconstruct.cu",
                           "gemmul8_tpu/pallas/megakernel.py:80"),
    "matmul_rider_step": ("gemmul8_tpu_torch/csrc/matmul_rider.cu",
                          "gemmul8_tpu/pallas/pipelined.py:195"),
    "matmul_bsplit_pair": ("gemmul8_tpu_torch/csrc/matmul_rider.cu",
                           "gemmul8_tpu/pallas/pipelined.py:475"),
    "reconstruct_into": ("gemmul8_tpu_torch/csrc/reconstruct.cu",
                         "gemmul8_tpu/pallas/pipelined.py:672"),
}
# wrapper counts that launch another entry's kernel (its second mode)
KERNEL_OF = {"fast_stats": "fast_sft"}
FAST_LAUNCHES = {"fast_sft": 2, "encode_slices": 2, "matmul_mod_u8": 1,
                 "reconstruct": 1}
ACCURATE_LAUNCHES = {"emax": 2, "mag7": 2, "magmax_matmul": 1,
                     "encode_slices": 2, "matmul_mod_u8": 1,
                     "reconstruct": 1}
CT = gt.ComputeType
COMPLEX_FAST_LAUNCHES = {"fast_stats": 4, "encode_slices": 4,
                         "matmul_complex_mod": 1, "reconstruct": 2}
COMPLEX_ACCURATE_LAUNCHES = {"emax": 4, "mag7": 4, "magmax_matmul": 1,
                             "encode_slices": 4, "matmul_complex_mod": 1,
                             "reconstruct": 2}
# (compute type, fastmode): phase 4c's complex main-path calls
COMPLEX_CALLS = [(CT.COMPLEX_BIG_MATRIX_ENCODE, True),
                 (CT.COMPLEX_CLASSIC_MULT, True),
                 (CT.COMPLEX_KARATSUBA_MULT, True),
                 (CT.COMPLEX_KARATSUBA_MULT, False),
                 (CT.COMPLEX_BIG_MATRIX_ENCODE, False)]
# (m, k, n), moduli counts, special values: phase 3e's complex checks; k =
# 4100 spans three of fast_sft's 2048-wide norm chunks, the last ragged
COMPLEX_CASES = CASES + [((600, 600, 328), (14,), False),
                         ((1000, 4100, 1500), (2, 14), True)]
# phase 3e: the complex GEMM at its k limit, 2^16, on extreme slices at a
# ragged m x n (every lane): all -128 (IR + RI exactly 2^31, past int32
# but for the Im chain's bias), all 127, mixed signs (Karatsuba's G - E - F
# past 2^31: its residues carried), -128 in the odd lanes only
COMPLEX_EDGE_K = tables.MAX_K // 2
COMPLEX_EDGE_MN = (65, 130)
COMPLEX_EDGE_PATTERNS = ("neg", "pos", "mixed", "odd")
# rounds of phase 5c's complex call times, each in a rotated call order
COMPLEX_ROUNDS = 5
# phase 3v: phase 3's shapes and k over three 2048-wide norm chunks
VARIANT_CASES = CASES + [((1000, 4100, 1500), (2, 14), True)]
# phase 3v: the fused statistics kernels in both words, each operand also
# with late-max lines (late_max_lines), at: 17 and 20 moduli (the encode's
# two slot tiles); f64 rows of 2^17 elements (past the staged part of the
# row) and a single column; strips of 100 columns (not a multiple of 32 or
# 64) over two norm chunks and a partial one; one column at 300 rows
FUSED_EDGE_CASES = [((1000, 4100, 1500), (17, 20), True),
                    ((3, tables.MAX_K, 1), (L_MAIN,), False),
                    ((65, 2 * 2048 + 5, 100), (8, L_MAIN), True),
                    ((64, 300, 1), (2, 20), False)]
# phase 3v: the ping-pong matmul_mod_u8_pipelined at k = 2^17 (the 256
# lane's products wrapping) and at a ragged shape, (m, k, n, L), several
# tiles a block; each run PIPE_REPEATS times, bit-equal
PIPE_EDGES = [(300, tables.MAX_K, 520, tables.MAX_MODULI),
              (777, 1000, 1333, L_MAIN)]
PIPE_REPEATS = 3
# phase 4v: (name, fastmode, switches, launch counts of the 8192^3 call)
VARIANT_CALLS = [
    ("fast FUSED_ENCODE", True, {"GEMMUL8_FUSED_ENCODE": "1"},
     {"fast_encode_fused": 2, "matmul_mod_u8": 1, "reconstruct": 1}),
    ("fast MM_PIPELINE", True,
     {"GEMMUL8_MM_PIPELINE": "1", "GEMMUL8_MXU_CRT": "0"},
     {"fast_sft": 2, "encode_slices": 2, "matmul_mod_u8_pipelined": 1,
      "reconstruct": 1}),
    ("accurate FUSED_MAG7 + MAGMAX_SCRATCH", False,
     {"GEMMUL8_FUSED_MAG7": "1", "GEMMUL8_MAGMAX_SCRATCH": "1"},
     {"mag7_fused": 2, "magmax_matmul_scratch": 1, "encode_slices": 2,
      "matmul_mod_u8": 1, "reconstruct": 1}),
]
VARIANT_ROUNDS = 3
VARIANT_KERNELS = ("fast_encode_fused", "mag7_fused", "magmax_matmul_scratch",
                   "matmul_mod_u8_pipelined")
# phases 5, 5c, 5f, 5x: each half of fast_sft (or of its statistics mode)
# timed apart beside emax on the same operands, HALF_ROUNDS rounds in
# rotated order of HALF_REPS calls, each timing after a head start of
# HEAD_START_CYCLES SM cycles (torch.cuda._sleep) so that the host's
# launches never hold the card back; and the bytes each line writes: a
# shift (fast_sft), the statistics (fast_stats: int64 exponent, f32 norm,
# bool flag) or an exponent (emax)
HALF_ROUNDS = 5
HALF_REPS = 20
HEAD_START_CYCLES = 10_000_000
LINE_OUT_BYTES = {"fast_sft": 4, "fast_stats": 13, "emax": 4}
# phase 3s: phase 3's shapes, every one at 2 to 20 moduli but the largest
SCHEDULE_CASES = [((2048, 2048, 2048), (L_MAIN,), False),
                  ((1000, 777, 1500), (2, 8, 14, 20), True),
                  ((300, 5, 200), (2, 8, 14, 20), True)]
CHUNK = 5                # phase 4s: moduli_chunk of the chunked calls
BUDGET_CHUNK = 4         # and the chunk its max_workspace_bytes call plans
SCHEDULE_KERNELS = ("matmul_crt", "matmul_reconstruct")
SCHEDULE_ROUNDS = 3
# phase 4c's ragged complex shape (m, k, n)
PEAK_RAGGED = (1000, 4100, 1500)
PLANNER_SLACK = 0.05     # phase 4s: a measured peak within 5% under the model
# phase 5: the CUDA-core bodies' times before encode_slices and reconstruct
# took the tensor cores (PERF.md, same card and power limit), beside theirs
EARLIER_MS = {"encode_slices": 2.521, "reconstruct": 1.975}
MAIN_ROUNDS = 5          # phase 5: the fast, accurate and f32-8 calls
# phase 2: sources whose ptxas report must show no spill store or load
NO_SPILL_SOURCES = ("matmul_mod_pipelined.cu", "matmul_complex.cu",
                    "matmul_reconstruct.cu", "probe_deaddep.cu",
                    "matmul_crt.cu", "magmax.cu", "fast_sft.cu",
                    "fast_encode_fused.cu", "mag7.cu")
# phase 3w: the wgmma tile's edge shapes (m, k, n) at these slice counts,
# a moduli subset, and the int32 wrap at the largest k
WGMMA_CASES = [(1, 16, 1), (65, 144, 257), (200, 4100, 129),
               (1000, 4100, 1500)]
WGMMA_LS = (1, 14, 20)
WGMMA_SUBSET = (3, 7, 11)
WRAP_K = tables.MAX_K    # 2^17
WRAP_MN = 128
# phase 3w: matmul_reconstruct at the edge shapes' moduli counts, every
# count on one ragged shape, and the shape run RECON_REPEATS times
RECON_EDGE_LS = (2, 14, 20)
RECON_ALL_LS = (65, 144, 257)
RECON_REPEAT_CASE = ((1000, 4100, 1500), L_MAIN)
RECON_REPEATS = 3
# phase 3w: magmax on the wgmma tile at the edge shapes, also from
# K-major buffers MAGMAX_PAD bytes wider than k whose bytes past k hold
# the largest magnitude (the tensor maps' extent must keep them out), and
# all-MAG_MAX magnitudes at k = 2^17 (products 2^29)
MAGMAX_PAD = 48
MAG_MAX = 64
# phase 5: the accurate 8192^3 call's median in the main calls' rotation
# before magmax moved to the wgmma tile (PERF.md section 5, same card and
# power limit)
EARLIER_ACCURATE_MS = 16.704
# phase 3p: (m, k, n), moduli counts, panel_m; 2 or 3 panels, where the
# pipeline's gates apply
PIPELINE_CASES = [((2048, 2048, 2048), (L_MAIN,), 1024),
                  ((768, 384, 1024), (2, 8, 14, 20), 256),
                  ((1536, 1024, 1024), (L_MAIN,), 512)]
PIPELINE_KERNELS = ("matmul_rider_step", "matmul_bsplit_pair",
                    "reconstruct_into")
# phases 3p/3r, the wgmma rider kernel's edges: (m, k, n), moduli counts,
# panel_m. A pair whose column half (640) is not a multiple of the 256-wide
# tile, so launch 0a's last GEMM tile straddles c1 while its rider writes
# the columns past it; ragged panels (200 rows, not a multiple of 128) with
# a part k-tile (k = 272) and n = 1000 (byte stores, a column half of 500)
RIDER_EDGE_CASES = [((512, 384, 1280), (14, 20), 256),
                    ((600, 272, 1000), (2, 14, 20), 200)]
RIDER_REPEATS = 3
PANEL_M = 1024           # choose_panels at 8192^3: (1024, 512), 8 panels
N_WIDE = 16384           # phase 4p's column-panel call: B is N x N_WIDE
N_PANEL = 4096
PIPELINE_ROUNDS = 5
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "data", "torch_golden.npz")
L_F32 = 8                # the f32 main path's moduli count (SGEMM grade)
# phase 3f: phase 3's shapes and k over three norm chunks, 2 to 20 moduli
F32_CASES = [((2048, 2048, 2048), (L_F32,), False),
             ((1000, 777, 1500), (2, 8, 14, 20), True),
             ((300, 5, 200), (8, 20), True),
             ((1000, 4100, 1500), (2, 8), True)]
# the kernels with an f32 form (f32 operands; f32 output for reconstruct)
F32_KERNELS = ("fast_sft", "encode_slices", "emax", "mag7", "reconstruct")
F32_GATE_MEDIAN = 2e-7   # tests/test_gemm.py:75's band at 8 moduli
F32_ROUNDS = 5
ALPHA, BETA = 1.7, -0.3  # phase 4f's general epilogue (not f32 values)
KERNELS.update({build.form(name, True): KERNELS[name]
                for name in F32_KERNELS})
# phases 3x/4x/5x: the f32 forms of the statistics mode (an entry of its
# own) and of the one-shot variants
KERNELS["fast_stats[f32]"] = KERNELS["fast_sft"]
KERNELS.update({build.form(name, True): KERNELS[name]
                for name in ("fast_encode_fused", "mag7_fused",
                             "matmul_reconstruct")})
C_ALPHA, C_BETA = 1.5 - 0.5j, 0.25 + 2j   # phase 4x's complex epilogue
# phase 4x: f32 x f32 -> f32 calls at 8 moduli under the one-shot
# variants' switches: (name, fastmode, switches, launch counts)
F32_SWITCH_CALLS = [
    ("f32 fast FUSED_ENCODE", True, {"GEMMUL8_FUSED_ENCODE": "1"},
     {"fast_encode_fused[f32]": 2, "matmul_mod_u8": 1,
      "reconstruct[f32]": 1}),
    ("f32 accurate FUSED_MAG7", False, {"GEMMUL8_FUSED_MAG7": "1"},
     {"mag7_fused[f32]": 2, "magmax_matmul": 1, "encode_slices[f32]": 2,
      "matmul_mod_u8": 1, "reconstruct[f32]": 1}),
    ("f32 fast FUSED_RECONSTRUCT", True, {"GEMMUL8_FUSED_RECONSTRUCT": "1"},
     {"fast_sft[f32]": 2, "encode_slices[f32]": 2,
      "matmul_reconstruct[f32]": 1}),
]
# phases 3r/4r/5r: the riders' f32 forms, each combination of words a key
# of its own (build.form: the step's A source and output words, the pair's
# A and B source words)
RIDER_F32_FORMS = tuple(
    [build.form("matmul_rider_step", *w)
     for w in ((True, False), (False, True), (True, True))]
    + [build.form("matmul_bsplit_pair", *w)
       for w in ((True, False), (False, True), (True, True))]
    + ["reconstruct_into[f32]"])
KERNELS.update({form: KERNELS[form.split("[")[0]]
                for form in RIDER_F32_FORMS})
# the probes (B16), phases 3q, 4q, 5q: their kernels' entries
PROBE_KERNELS = {
    "probe_clz": ("gemmul8_tpu_torch/csrc/probe_clz.cu",
                  "scripts/probe_clz.py:20"),
    "probe_vpu_ops": ("gemmul8_tpu_torch/csrc/probe_vpu_ops.cu",
                      "scripts/probe_vpu_ops.py:26"),
    "probe_mxu_crt": ("gemmul8_tpu_torch/csrc/probe_mxu_crt.cu",
                      "scripts/probe_mxu_crt.py:38"),
    "probe_deaddep": ("gemmul8_tpu_torch/csrc/probe_deaddep.cu",
                      "scripts/probe_deaddep.py:30"),
}
KERNELS.update(PROBE_KERNELS)
PROBE_CLZ_WORDS = 1 << 26   # phase 3q's random words
PROBE_STEPS_CHECK = 64      # phase 3q's chain length (the probe's: 2048)
PROBE_N_CHECK = 2048        # phase 3q's deaddep size (the probe's: 8192)
PROBE_N_SMALL = 1024        # and its least: kloop's two batches a k-tile
PROBE_ROUNDS = 3
PROBE_DEADDEP_ROUNDS = 5    # its effects are near the power cap's swing,
PROBE_DEADDEP_PAIRS = 8     # so its differences come from adjacent pairs
PROBE_DEADDEP_STAMPED = 5   # and from SM clock cycles
SMS = 132
# the chains' kernels (csrc/probe_vpu_ops.cu gm8_vpu_<name>), their
# instructions a rep by class (i32 add: ptxas pairs two adds into one
# IADD3), and the classes' rates a clock an SM: the CUDA C++ Programming
# Guide's arithmetic-instruction table, compute capability 9.0 (integer
# add, multiply-add, shift, logic 64; f32 add, multiply 128; "all other
# type conversions" 16, taken for F2I and for FRND, floor); sm_90's
# I2FP.F32.S32 is not in the table and runs faster than 16 on the card, so
# it is counted at the integer rate, 64
VPU_KERNEL = dict(zip(pvpu.CASES, (
    "i32_mul", "i32_constmul", "i32_constmac", "i32_add", "i32_shrxor",
    "f32_mul", "f32_constmac", "f32_floor", "f32_cvt")))
VPU_MIX = {"i32 mul": {"imad": 1}, "i32 constmul": {"imad": 1},
           "i32 constmac": {"imad": 1}, "i32 add": {"iadd": 0.5},
           "i32 shr^": {"shift": 1, "logic": 1}, "f32 mul": {"fp32": 1},
           "f32 constmac": {"fp32": 2}, "f32 floor": {"fp32": 3, "cvt": 1},
           "f32->i32 cvt": {"i2fp": 1, "fp32": 1, "cvt": 1, "logic": 1}}
VPU_RATE = {"imad": 64, "iadd": 64, "shift": 64, "logic": 64, "fp32": 128,
            "cvt": 16, "i2fp": 64}
VPU_OPCODES = {"IMAD", "IADD3", "SHF", "LOP3", "FMUL", "FADD", "FFMA",
               "FRND", "F2I", "I2FP", "I2F"}
# the card's published peaks (H100 SXM5 data sheet, dense): device-memory
# bytes per second and int8 tensor-core operations per second
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def bits64(t):
    return t.contiguous().view(torch.int64)


def check_sft(kern, plain, x, axis, L):
    """Shift rule: equal, or off by 1 where the floored value lies within
    SHIFT_RULE_FRAC of an integer. Returns the max |difference|."""
    diff = kern != plain
    if not bool(diff.any()):
        return 0
    _, nrm2, _ = enc.fast_stats(x, axis)
    frac = enc.sft_floor_frac(nrm2, x.shape[axis], L)
    worst = int((kern.long() - plain.long()).abs().max())
    assert worst <= 1, f"shift differs by {worst}"
    assert float(frac[diff].max()) < SHIFT_RULE_FRAC, \
        "shift differs away from a floor boundary"
    log(f"    shift rule used at {int(diff.sum())} rows/cols")
    return worst


def max_abs(x, y):
    if x.is_floating_point():
        d = (x.double() - y.double()).abs()
        d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
        return float(d.max())
    return float((x.long() - y.long()).abs().max())


def words(t):
    """The IEEE words of a float64 or float32 tensor (anything else as
    it is)."""
    if t.dtype == torch.float64:
        return bits64(t)
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    return t


def assert_bits_equal(x, y, what):
    ok = x.dtype == y.dtype and torch.equal(words(x), words(y))
    assert ok, f"{what}: kernel and plain version disagree"


def hold(errs, name, got, ref, what):
    """got (kernel) and ref (plain) bit-equal; record the max |diff|."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for x, y in zip(got, ref):
        assert_bits_equal(x, y, what)
        errs[name] = max(errs[name], max_abs(x, y))


def operands(m, k, n, seed, special):
    a = phi_matrix(m, k, 0.5, seed=seed)
    b = phi_matrix(k, n, 0.5, seed=seed + 1)
    if special:
        rng = np.random.default_rng(seed + 2)
        a[0, :] = rng.random(k) * 5e-324 * rng.integers(1, 1 << 40, k)
        a[1, :] = 0.0
        a[2, ::7] = -0.0
        a[3, ::5] = a[3, ::5] * 2.0 ** 40
        b[:, 3] = 0.0
        b[::11, 4] = 1e-310
    return (torch.from_numpy(a).to(DEVICE), torch.from_numpy(b).to(DEVICE))


def phase_kernels(errs):
    """Phase 3: each kernel vs its plain version on the card."""
    for (m, k, n), Ls, special in CASES:
        a, b = operands(m, k, n, 7, special)
        for L in Ls:
            tag = f"m={m} k={k} n={n} L={L}"
            sa = hk.fast_sft(a, L, axis=1)
            sb = hk.fast_sft(b, L, axis=0)
            pa = hk.fast_sft_plain(a, L, axis=1)
            pb = hk.fast_sft_plain(b, L, axis=0)
            torch.cuda.synchronize()
            e = max(check_sft(sa, pa, a, 1, L),
                    check_sft(sb, pb, b, 0, L))
            errs["fast_sft"] = max(errs["fast_sft"], e)
            # downstream kernels get the plain shifts on both sides
            a8 = hk.encode_slices(a, pa, L, axis=1)
            b8 = hk.encode_slices(b, pb, L, axis=0)
            hold(errs, "encode_slices", (a8, b8),
                 (hk.encode_slices_plain(a, pa, L, 1),
                  hk.encode_slices_plain(b, pb, L, 0)),
                 f"encode_slices {tag}")
            for centered in (True, False):
                r = hm.matmul_mod_u8(a8, b8, L, centered=centered)
                hold(errs, "matmul_mod_u8", r,
                     hm.matmul_mod_u8_plain(a8, b8, L, centered=centered),
                     f"matmul_mod_u8 {tag} centered={centered}")
                hold(errs, "reconstruct", hk.reconstruct(r, pa, pb, L),
                     hk.reconstruct_plain(r, pa, pb, L),
                     f"reconstruct {tag} centered={centered}")
            log(f"  kernels == plain at {tag}")


def phase_mma_kernels(errs):
    """Phase 3m: the two kernels redesigned on the tensor cores, each
    against its plain version at every moduli count of MMA_LS: encode in
    f64 and f32, both axes, every moduli set (all in order, a range, a
    tuple out of order) and a column range; reconstruct from int8, uint8,
    int32 products and 16-bit limbs, to f64 and f32, and into the rows of
    a larger output (out=)."""
    rng = np.random.default_rng(12)
    for m, n in MMA_SHAPES:
        x64, _ = operands(m, n, 8, 12, True)
        sa = torch.from_numpy(rng.integers(-60, 60, (m, 1), np.int32)).to(
            DEVICE)
        sb = torch.from_numpy(rng.integers(-60, 60, (1, n), np.int32)).to(
            DEVICE)
        for L in MMA_LS:
            forms = [None, tuple(range(1, L)),
                     tuple(range(L - 1, -1, -3))]
            for x in (x64, x64.float()):
                key = build.form("encode_slices", x.dtype == torch.float32)
                for axis in (0, 1):
                    s = hk.fast_sft(x, L, axis)
                    for idx in forms:
                        hold(errs, key, hk.encode_slices(x, s, L, axis, idx),
                             hk.encode_slices_plain(x, s, L, axis, idx),
                             f"{key} {m}x{n} L={L} axis={axis} idx={idx}")
                    if n > 2 * enc.ENC_BLOCK[1]:
                        c0, c1 = enc.col_range((1, 3), n)
                        got = hk.encode_slices(x, s, L, axis,
                                               col_tiles=(1, 3))
                        ref = hk.encode_slices_plain(x, s, L, axis,
                                                     col_tiles=(1, 3))
                        hold(errs, key, got[:, :, c0:c1], ref[:, :, c0:c1],
                             f"{key} {m}x{n} L={L} axis={axis} columns "
                             f"{c0}..{c1}")
            mods = torch.tensor(tables.MODULI[:L], device=DEVICE).view(-1, 1,
                                                                       1)
            r = torch.from_numpy(rng.integers(0, 1 << 20, (L, m, n))).to(
                DEVICE) % mods
            r[:, 0, 0] = 0
            r[:, 0, 1] = mods.view(-1) - 1
            k = torch.from_numpy(rng.integers(-8000, 8000, (L, m, n))).to(
                DEVICE)
            inputs = {"uint8": (r.to(torch.uint8), "residues"),
                      "int8": ((r - 128).to(torch.int8), "residues"),
                      "int32 products": ((r + mods * k).to(torch.int32),
                                         "residues"),
                      "limbs": (torch.stack(rec.accumulate_weighted(r, L)).to(
                          torch.int32), "limbs")}
            for out in ("f64", "f32"):
                key = build.form("reconstruct", out == "f32")
                for what, (x, kind) in inputs.items():
                    hold(errs, key, hk.reconstruct(x, sa, sb, L, out,
                                                   input_kind=kind),
                         hk.reconstruct_plain(x, sa, sb, L, out, 0, kind),
                         f"{key} {m}x{n} L={L} from {what}")
                big = torch.zeros((2 * m, n), device=DEVICE, dtype=(
                    torch.float32 if out == "f32" else torch.float64))
                hk.reconstruct(inputs["int8"][0], sa, sb, L, out, out=big[m:])
                hold(errs, key, big[m:],
                     hk.reconstruct_plain(inputs["int8"][0], sa, sb, L, out),
                     f"{key} {m}x{n} L={L} out= rows {m}..{2 * m}")
        log(f"  encode_slices (f64, f32; axes; all, range, tuple"
            f"{', column range' if n > 2 * enc.ENC_BLOCK[1] else ''}) and "
            f"reconstruct (int8, uint8, int32, limbs; f64, f32; out=) == "
            f"plain at {m} x {n}, L = {MMA_LS[0]}..{MMA_LS[-1]}")


def slices8(L, m, k, n, seed):
    """Random int8 slices (L, m, k) and (L, k, n) on the card."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(-128, 128, (L, m, k), np.int8)
                             ).to(DEVICE),
            torch.from_numpy(rng.integers(-128, 128, (L, k, n), np.int8)
                             ).to(DEVICE))


def hold_mod(errs, a8, b8, L, tag, moduli_idx=None):
    """matmul_mod_u8 == its plain version, centered and not."""
    for centered in (True, False):
        hold(errs, "matmul_mod_u8",
             hm.matmul_mod_u8(a8, b8, L, centered=centered,
                              moduli_idx=moduli_idx),
             hm.matmul_mod_u8_plain(a8, b8, L, centered=centered,
                                    moduli_idx=moduli_idx),
             f"matmul_mod_u8 {tag} centered={centered}")


def phase_wgmma_kernels(errs):
    """Phase 3w: the wgmma tile of matmul_mod_u8 at its edge shapes, a
    moduli subset and the int32 wrap at k = 2^17, bit-equal to the plain
    version; the epilogue's division against mod_canon for every int32."""
    cfg = hl.get("matmul_mod")
    log(f"  matmul_mod_u8 launch (hopper/launch.py, capability "
        f"{torch.cuda.get_device_capability()}): {cfg}, built with "
        f"{' '.join(build.SOURCE_FLAGS['matmul_mod.cu'])}")
    for i, (m, k, n) in enumerate(WGMMA_CASES):
        for L in WGMMA_LS:
            a8, b8 = slices8(L, m, k, n, 100 + i)
            hold_mod(errs, a8, b8, L, f"m={m} k={k} n={n} L={L}")
        log(f"  matmul_mod_u8 == plain at m={m} k={k} n={n}, L = "
            f"{', '.join(map(str, WGMMA_LS))}")
    a8, b8 = slices8(len(WGMMA_SUBSET), 300, 777, 200, 110)
    hold_mod(errs, a8, b8, tables.MAX_MODULI, f"moduli_idx={WGMMA_SUBSET}",
             WGMMA_SUBSET)
    log(f"  matmul_mod_u8 == plain with moduli_idx={WGMMA_SUBSET}")
    L = tables.MAX_MODULI
    a8 = torch.full((L, WRAP_MN, WRAP_K), -127, dtype=torch.int8,
                    device=DEVICE)
    b8 = torch.full((L, WRAP_K, WRAP_MN), 127, dtype=torch.int8,
                    device=DEVICE)
    a8[0] = -128
    b8[0] = -128
    b8[1:, :, ::2] = -127
    hold_mod(errs, a8, b8, L, f"wrap k={WRAP_K}")
    wrapped = hm.matmul_mod_u8(a8[:1], b8[:1], L, moduli_idx=(0,))
    assert bool((wrapped == 0).all()), "the 256 lane's 2^31 is not 0 mod 256"
    del a8, b8, wrapped
    a8, b8 = slices8(L, WRAP_MN, WRAP_K, WRAP_MN, 111)
    hold_mod(errs, a8, b8, L, f"random k={WRAP_K}")
    del a8, b8
    log(f"  matmul_mod_u8 == plain at k = {WRAP_K}, m = n = {WRAP_MN}, L = "
        f"{L}: the 256 slice's products exactly 2^31 (wrapped, residue 0), "
        "the odd slices' 127^2 * 2^17; and random slices")
    t0 = time.perf_counter()
    bad = hm.mod_div_mismatches(-(1 << 31), (1 << 31) - 1, L,
                                device=DEVICE)
    torch.cuda.synchronize()
    assert int(bad.sum()) == 0, f"mod_div differs from mod_canon: {bad}"
    log(f"  mod_div == mod_canon for every int32, all {L} moduli "
        f"({time.perf_counter() - t0:.2f} s)")


def hold_reconstruct(errs, a8, b8, L, tag, seed, repeats=1):
    """matmul_reconstruct in both output words == its plain version ==
    matmul_mod_u8 + reconstruct, bit for bit, on random shifts; repeats
    runs of each, bit-equal."""
    m, n = a8.shape[1], b8.shape[2]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sa = torch.randint(-30, 30, (m, 1), generator=gen, dtype=torch.int32,
                       device=DEVICE)
    sb = torch.randint(-30, 30, (1, n), generator=gen, dtype=torch.int32,
                       device=DEVICE)
    r8 = hm.matmul_mod_u8(a8, b8, L, centered=True)
    for out in ("f64", "f32"):
        name = build.form("matmul_reconstruct", out == "f32")
        runs = [hm.matmul_reconstruct(a8, b8, sa, sb, L, out)
                for _ in range(repeats)]
        for r in runs[1:]:
            assert_bits_equal(r, runs[0], f"{name} {tag}: runs differ")
        hold(errs, name, runs[0],
             hm.matmul_reconstruct_plain(a8, b8, sa, sb, L, out),
             f"{name} {tag}")
        assert_bits_equal(runs[0], hk.reconstruct(r8, sa, sb, L, out),
                          f"{name} {tag} vs matmul_mod_u8 + reconstruct")


def phase_reconstruct_wgmma(errs):
    """Phase 3w (also): matmul_reconstruct on the wgmma tile, f64 and f32
    output, at the tile's edge shapes, every moduli count, the int32 wrap
    at k = 2^17 and three runs of one shape."""
    cfg = hl.get("matmul_reconstruct")
    log(f"  matmul_reconstruct launch: {cfg}, built with "
        f"{' '.join(build.SOURCE_FLAGS['matmul_reconstruct.cu'])}")
    for i, (m, k, n) in enumerate(WGMMA_CASES):
        Ls = sorted(set(RECON_EDGE_LS) | (
            set(range(2, tables.MAX_MODULI + 1))
            if (m, k, n) == RECON_ALL_LS else set()))
        for L in Ls:
            a8, b8 = slices8(L, m, k, n, 120 + i)
            hold_reconstruct(errs, a8, b8, L, f"m={m} k={k} n={n} L={L}",
                             130 + L)
        log(f"  matmul_reconstruct (f64, f32) == plain == matmul_mod_u8 + "
            f"reconstruct at m={m} k={k} n={n}, L = "
            f"{', '.join(map(str, Ls))}")
    L = tables.MAX_MODULI
    a8 = torch.full((L, WRAP_MN, WRAP_K), -127, dtype=torch.int8,
                    device=DEVICE)
    b8 = torch.full((L, WRAP_K, WRAP_MN), 127, dtype=torch.int8,
                    device=DEVICE)
    a8[0] = -128
    b8[0] = -128
    b8[1:, :, ::2] = -127
    hold_reconstruct(errs, a8, b8, L, f"wrap k={WRAP_K}", 140)
    del a8, b8
    a8, b8 = slices8(L, WRAP_MN, WRAP_K, WRAP_MN, 141)
    hold_reconstruct(errs, a8, b8, L, f"random k={WRAP_K}", 142)
    del a8, b8
    log(f"  matmul_reconstruct == plain at k = {WRAP_K}, m = n = {WRAP_MN}, "
        f"L = {L}: the 256 slice's products exactly 2^31, the odd slices' "
        "127^2 * 2^17; and random slices")
    (m, k, n), L = RECON_REPEAT_CASE
    a8, b8 = slices8(L, m, k, n, 143)
    hold_reconstruct(errs, a8, b8, L, f"m={m} k={k} n={n} L={L}", 144,
                     RECON_REPEATS)
    log(f"  matmul_reconstruct at m={m} k={k} n={n} L={L}: "
        f"{RECON_REPEATS} runs bit-equal in each word")



def hold_crt(errs, a8, b8, L, tag, repeats=1):
    """matmul_crt == its plain version, bit for bit, every limb in [0,
    2^16); repeats runs of it, bit-equal."""
    runs = [hm.matmul_crt(a8, b8, L) for _ in range(repeats)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0]), f"matmul_crt {tag}: runs differ"
    hold(errs, "matmul_crt", runs[0], hm.matmul_crt_plain(a8, b8, L),
         f"matmul_crt {tag}")
    assert 0 <= int(runs[0].min()) and int(runs[0].max()) <= 0xFFFF, \
        f"matmul_crt {tag}: limbs not canonical"


def phase_crt_wgmma(errs):
    """Phase 3w (also): matmul_crt on the wgmma tile at the tile's edge
    shapes, every moduli count, the int32 wrap at k = 2^17 and three runs
    of one shape."""
    log(f"  matmul_crt launch: {hl.get('matmul_crt')}, built with "
        f"{' '.join(build.SOURCE_FLAGS['matmul_crt.cu'])}")
    for i, (m, k, n) in enumerate(WGMMA_CASES):
        Ls = sorted(set(RECON_EDGE_LS) | (
            set(range(2, tables.MAX_MODULI + 1))
            if (m, k, n) == RECON_ALL_LS else set()))
        for L in Ls:
            a8, b8 = slices8(L, m, k, n, 150 + i)
            hold_crt(errs, a8, b8, L, f"m={m} k={k} n={n} L={L}")
        log(f"  matmul_crt == plain, limbs canonical, at m={m} k={k} n={n}, "
            f"L = {', '.join(map(str, Ls))}")
    L = tables.MAX_MODULI
    a8 = torch.full((L, WRAP_MN, WRAP_K), -127, dtype=torch.int8,
                    device=DEVICE)
    b8 = torch.full((L, WRAP_K, WRAP_MN), 127, dtype=torch.int8,
                    device=DEVICE)
    a8[0] = -128
    b8[0] = -128
    b8[1:, :, ::2] = -127
    hold_crt(errs, a8, b8, L, f"wrap k={WRAP_K}")
    del a8, b8
    a8, b8 = slices8(L, WRAP_MN, WRAP_K, WRAP_MN, 160)
    hold_crt(errs, a8, b8, L, f"random k={WRAP_K}")
    del a8, b8
    log(f"  matmul_crt == plain at k = {WRAP_K}, m = n = {WRAP_MN}, L = {L}: "
        "the 256 slice's products exactly 2^31, the odd slices' 127^2 * "
        "2^17; and random slices")
    (m, k, n), L = RECON_REPEAT_CASE
    a8, b8 = slices8(L, m, k, n, 161)
    hold_crt(errs, a8, b8, L, f"m={m} k={k} n={n} L={L}", RECON_REPEATS)
    log(f"  matmul_crt at m={m} k={k} n={n} L={L}: {RECON_REPEATS} runs "
        "bit-equal")


def padded_k_major(x, pad, fill):
    """x (rows, k) int8 as the view [:, :k] of a K-major buffer (rows, ld),
    ld = k rounded up to 16 plus pad, whose bytes past k hold fill."""
    rows, k = x.shape
    buf = torch.full((rows, -(-k // 16) * 16 + pad), fill, dtype=torch.int8,
                     device=x.device)
    buf[:, :k] = x
    return buf[:, :k]


def phase_magmax_wgmma(errs):
    """Phase 3w (also): magmax_matmul and magmax_matmul_scratch on the
    wgmma tile at its edge shapes, from contiguous operands (which the
    wrapper copies K-major) and from K-major buffers wider than k whose
    bytes past k hold the largest magnitude; all-64 magnitudes at k =
    2^17."""
    log(f"  magmax launch: {hl.get('magmax')}, built with "
        f"{' '.join(build.SOURCE_FLAGS['magmax.cu'])}")
    for i, (m, k, n) in enumerate(WGMMA_CASES):
        rng = np.random.default_rng(170 + i)
        a = torch.from_numpy(rng.integers(0, MAG_MAX + 1, (m, k), np.int8)
                             ).to(DEVICE)
        b = torch.from_numpy(rng.integers(0, MAG_MAX + 1, (k, n), np.int8)
                             ).to(DEVICE)
        ref = hm.magmax_plain(a, b)
        a_pad = padded_k_major(a, MAGMAX_PAD, MAG_MAX)
        b_pad = padded_k_major(b.t().contiguous(), MAGMAX_PAD, MAG_MAX).t()
        # the wrapper reads the padded buffers in place, past-k bytes and all
        assert hm._k_major(a_pad)[0].data_ptr() == a_pad.data_ptr()
        assert hm._k_major(b_pad.t())[0].data_ptr() == b_pad.data_ptr()
        for x, y, form in ((a, b, "contiguous"),
                           (a_pad, b_pad, f"K-major, {MAG_MAX} past k")):
            tag = f"m={m} k={k} n={n} {form}"
            hold(errs, "magmax_matmul", hm.magmax_matmul(x, y), ref,
                 f"magmax_matmul {tag}")
            hold(errs, "magmax_matmul_scratch",
                 hm.magmax_matmul_scratch(x, y), ref,
                 f"magmax_matmul_scratch {tag}")
        log(f"  magmax_matmul, magmax_matmul_scratch == plain at m={m} k={k} "
            f"n={n}, contiguous and padded K-major operands")
    a = torch.full((WRAP_MN, WRAP_K), MAG_MAX, dtype=torch.int8,
                   device=DEVICE)
    ref = hm.magmax_plain(a, a.t())
    assert int(ref[0].max()) == MAG_MAX ** 2 * WRAP_K
    for name, fn in (("magmax_matmul", hm.magmax_matmul),
                     ("magmax_matmul_scratch", hm.magmax_matmul_scratch)):
        hold(errs, name, fn(a, a.t()), ref, f"{name} all {MAG_MAX} k={WRAP_K}")
    log(f"  magmax_matmul, magmax_matmul_scratch == plain at k = {WRAP_K}, "
        f"m = n = {WRAP_MN}, every magnitude {MAG_MAX} (products 2^29)")

# (x, e): reconstruct must give x * 2^e rounded to nearest even
ROUNDING_VALUES = [
    # ties both ways, ties broken by a far sticky bit, a tie below 2^-1022
    (2 ** 53 + 1, 0), (2 ** 53 + 3, 0), ((2 ** 54 + 2) * 3, -1),
    (2 ** 54 + 2 + 1, 0), ((2 ** 53 + 1) * 2 ** 40 + 1, -40), (2 ** 53, 7),
    (2 ** 53 - 1, -9), ((2 ** 53 + 1) * 2 ** 50, -1100),
    (-(2 ** 53 + 1), 13),
    # subnormals, underflow to 0, overflow to inf
    (3, -1080), (12345, -1100), (1, -1074), (1, -1075), (7, 1020),
    (-5, -1076), (2 ** 60, 1000),
    # a subnormal tie rounding up into the smallest normal; the largest
    # finite value; a tie rounding up past it into inf
    (2 ** 53 - 1, -1075), (-(2 ** 53 - 1), -1075), (2 ** 53 - 1, 971),
    (2 ** 54 - 1, 970), (-(2 ** 54 - 1), 970),
]


def exact_f64(x, e):
    v = Fraction(x) * Fraction(2) ** e
    if abs(v) >= 2 ** 1024 - 2 ** 970:   # largest finite + half an ulp
        return float("inf") if x > 0 else float("-inf")
    return float(v)


def phase_rounding(errs):
    """Phase 3b: reconstruct's rounding branches on the card."""
    for L in (8, 14, 20):
        half = tables.big_m(L) // 2
        vals = [(x, e) for x, e in ROUNDING_VALUES if abs(x) < half]
        r = torch.tensor([[[x % tables.MODULI[j] for x, _ in vals]]
                          for j in range(L)], dtype=torch.int64)
        sft_a = torch.zeros((1, 1), dtype=torch.int32, device=DEVICE)
        sft_b = -torch.tensor([[e for _, e in vals]], dtype=torch.int32,
                              device=DEVICE)
        want = torch.tensor([[exact_f64(x, e) for x, e in vals]],
                            dtype=torch.float64)
        for r8 in ((r - 128).to(torch.int8), r.to(torch.uint8)):
            r8 = r8.to(DEVICE)
            c = hk.reconstruct(r8, sft_a, sft_b, L)
            tag = f"reconstruct rounding L={L} {r8.dtype}"
            hold(errs, "reconstruct", c,
                 hk.reconstruct_plain(r8, sft_a, sft_b, L), tag)
            assert torch.equal(bits64(c.cpu()), bits64(want)), \
                f"{tag}: not the correctly rounded values"
        # the same values as raw int32 products (a residue plus a multiple
        # of its modulus, negative ones too) and as 16-bit limbs
        mods = torch.tensor(tables.MODULI[:L]).view(L, 1, 1)
        mult = torch.arange(-3, len(vals) - 3).view(1, 1, -1) * 1000003
        prod = (r + mods * (mult % 7919 - 4000)).to(torch.int32).to(DEVICE)
        limbs = torch.stack(rec.accumulate_weighted(r, L)).to(
            torch.int32).to(DEVICE)
        for x, kind in ((prod, "residues"), (limbs, "limbs")):
            c = hk.reconstruct(x, sft_a, sft_b, L, input_kind=kind)
            tag = f"reconstruct rounding L={L} int32 {kind}"
            hold(errs, "reconstruct", c,
                 hk.reconstruct_plain(x, sft_a, sft_b, L, "f64", 0, kind),
                 tag)
            assert torch.equal(bits64(c.cpu()), bits64(want)), \
                f"{tag}: not the correctly rounded values"
        log(f"  reconstruct rounding branches == plain == exact, L={L}, "
            f"{len(vals)} values, int8, uint8, int32 products and limbs")


def phase_accurate_kernels(errs):
    """Phase 3c: the accurate-mode kernels vs their plain versions, then
    encode, matmul and reconstruct on accurate shifts (near 1050 for the
    special operands' zero row and column)."""
    for (m, k, n), Ls, special in CASES:
        a, b = operands(m, k, n, 7, special)
        tag = f"m={m} k={k} n={n}"
        pea, peb = hk.emax_plain(a, 1), hk.emax_plain(b, 0)
        hold(errs, "emax", (hk.emax(a, 1), hk.emax(b, 0)), (pea, peb),
             f"emax {tag}")
        pma, pmb = hk.mag7_plain(a, pea, 1), hk.mag7_plain(b, peb, 0)
        ma, mb = hk.mag7(a, pea, 1), hk.mag7(b, peb, 0)
        hold(errs, "mag7", (ma, mb), (pma, pmb), f"mag7 {tag}")
        smax = hm.magmax_plain(pma, pmb)
        # mag7's K-major views, and contiguous operands the wrapper copies
        for x, y in ((ma, mb), (pma, pmb)):
            hold(errs, "magmax_matmul", hm.magmax_matmul(x, y), smax,
                 f"magmax_matmul {tag}")
        if special:
            assert (int(pea[0]), int(pea[1]), int(peb[0, 3])) == (1, 0, 0)
        for L in Ls:
            sa = enc.accurate_sft(smax[0], pea, L)
            sb = enc.accurate_sft(smax[1], peb, L)
            if special:
                t_a = tables.threshold_accurate(L)
                assert int(sa[1]) == int(sb[0, 3]) == t_a - 1 + 1023
            a8 = hk.encode_slices(a, sa, L, axis=1)
            b8 = hk.encode_slices(b, sb, L, axis=0)
            hold(errs, "encode_slices", (a8, b8),
                 (hk.encode_slices_plain(a, sa, L, 1),
                  hk.encode_slices_plain(b, sb, L, 0)),
                 f"encode_slices accurate {tag} L={L}")
            r8 = hm.matmul_mod_u8(a8, b8, L, centered=True)
            hold(errs, "matmul_mod_u8", r8,
                 hm.matmul_mod_u8_plain(a8, b8, L, centered=True),
                 f"matmul_mod_u8 accurate {tag} L={L}")
            hold(errs, "reconstruct", hk.reconstruct(r8, sa, sb, L),
                 hk.reconstruct_plain(r8, sa, sb, L),
                 f"reconstruct accurate {tag} L={L}")
        log(f"  accurate kernels == plain at {tag} L={Ls}")


def log2_probe_values():
    """Every integer s in [1, 2^20], and +-4096 around every step of
    floor(-0.51 * log2(s) + T) up to 2^29 (64 * 64 * k at k = 2^17)."""
    top = 64 * 64 * tables.MAX_K
    parts = [np.arange(1, 2 ** 20 + 1)]
    i = 1
    while 2.0 ** (i / 0.51) <= top:
        c = int(round(2.0 ** (i / 0.51)))
        parts.append(np.arange(c - 4096, c + 4097))
        i += 1
    s = np.unique(np.concatenate(parts))
    return s[(s >= 1) & (s <= top)].astype(np.int32)


def phase_log2():
    """Phase 3d: accurate_sft computed by torch on the card vs on the CPU,
    for every moduli count; and its f32 log2 at every f32 value max(smax,
    1) can take (integers to 2^24, then every f32 to 2^29)."""
    s = torch.from_numpy(log2_probe_values()).reshape(1, -1)
    e = torch.full_like(s, 1023)
    sd, ed = s.to(DEVICE), e.to(DEVICE)
    n_sft = 0
    moduli_counts = range(2, tables.MAX_MODULI + 1)
    for L in moduli_counts:
        got = enc.accurate_sft(sd, ed, L).cpu()
        ref = enc.accurate_sft(s, e, L)
        diff = got != ref
        if bool(diff.any()):
            frac = enc.accurate_sft_floor_frac(s, L)
            assert int((got.long() - ref.long()).abs().max()) <= 1
            assert float(frac[diff].max()) < SHIFT_RULE_FRAC, \
                f"accurate shift differs away from a floor boundary, L={L}"
        n_sft += int(diff.sum())
    x = torch.cat([torch.arange(1, 2 ** 24 + 1, dtype=torch.int32).float(),
                   torch.arange(0x4B800001, 0x4E000001,
                                dtype=torch.int32).view(torch.float32)])
    card = torch.log2(x.to(DEVICE).double()).float().cpu()
    host = torch.log2(x.double()).float()
    n_log2 = int((card.view(torch.int32) != host.view(torch.int32)).sum())
    pairs = s.numel() * len(moduli_counts)
    log(f"  accurate_sft card vs CPU: {n_sft} of {pairs} (value, L) pairs "
        f"differ (rule holds); f32 log2 differs at {n_log2} of "
        f"{x.numel()} f32 values")


def complex_operands(m, k, n, seed, special):
    """(a_re, a_im, b_re, b_im) on the card; with special, besides the real
    operands' special lines in both parts, a row of A whose Im part is all
    zero and a column of B whose Re part is."""
    a_re, b_re = operands(m, k, n, seed, special)
    a_im, b_im = operands(m, k, n, seed + 10, special)
    if special:
        a_im[4, :] = 0.0
        b_re[:, 5] = 0.0
    return a_re, a_im, b_re, b_im


def check_joint_sft(kern, plain, re, im, axis, L):
    """The shift rule for a shift shared by Re and Im: the pre-floor value
    of the joint norm (plain statistics, 2k terms). Returns the max
    |difference|."""
    diff = kern != plain
    if not bool(diff.any()):
        return 0
    _, nrm2, _ = enc.merge_stats(enc.fast_stats(re, axis),
                                 enc.fast_stats(im, axis))
    frac = enc.sft_floor_frac(nrm2, 2 * re.shape[axis], L)
    worst = int((kern.long() - plain.long()).abs().max())
    assert worst <= 1, f"joint shift differs by {worst}"
    assert float(frac[diff].max()) < SHIFT_RULE_FRAC, \
        "joint shift differs away from a floor boundary"
    log(f"    joint shift rule used at {int(diff.sum())} rows/cols")
    return worst


def stats_key(x):
    """The kernel-line entry a fast_stats launch on x counts under: the
    f64 statistics mode as fast_sft, its f32 form as its own."""
    key = build.form("fast_stats", enc.mant_bits_of(x) == 24)
    return KERNEL_OF.get(key, key)


def check_stats(errs, x, axis, L):
    """fast_stats vs its plain version on an f64 or f32 operand: emax and
    the any flag bit-equal, the norm under the floor-boundary rule on the
    shift it gives (at the operand's bias)."""
    got, ref = hk.fast_stats(x, axis), hk.fast_stats_plain(x, axis)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2]), \
        "fast_stats: emax or any flag differs from the plain version"
    kdim, mb = x.shape[axis], enc.mant_bits_of(x)
    e = check_sft(enc.sft_from_stats(*got, kdim, L, mb),
                  enc.sft_from_stats(*ref, kdim, L, mb), x, axis, L)
    errs[stats_key(x)] = max(errs[stats_key(x)], e)


def mag7_complex_plain(re, im, axis):
    """|Re| + |Im| magnitudes at the complex shift, every step plain."""
    e = torch.maximum(hk.emax_plain(re, axis), hk.emax_plain(im, axis))
    shift = enc.MAG_SHIFT_COMPLEX
    return (hk.mag7_plain(re, e, axis, shift)
            + hk.mag7_plain(im, e, axis, shift)), e


def phase_complex_kernels(errs):
    """Phase 3e: the complex path's kernels vs their plain versions."""
    for (m, k, n), Ls, special in COMPLEX_CASES:
        a_re, a_im, b_re, b_im = complex_operands(m, k, n, 17, special)
        tag = f"m={m} k={k} n={n}"
        for x, axis in ((a_re, 1), (a_im, 1), (b_re, 0), (b_im, 0)):
            for L in Ls:
                check_stats(errs, x, axis, L)
            e = hk.emax_plain(x, axis)
            shift = enc.MAG_SHIFT_COMPLEX
            hold(errs, "mag7", hk.mag7(x, e, axis, shift),
                 hk.mag7_plain(x, e, axis, shift), f"mag7 shift 4 {tag}")
        mags = []
        for re, im, axis in ((a_re, a_im, 1), (b_re, b_im, 0)):
            got, ref = (hk.mag7_operand_complex(re, im, axis),
                        mag7_complex_plain(re, im, axis))
            hold(errs, "mag7", got, ref, f"complex magnitudes {tag}")
            mags.append(got[0])
        smax = hm.magmax_plain(mags[0].contiguous(), mags[1].contiguous())
        hold(errs, "magmax_matmul", hm.magmax_matmul(*mags), smax,
             f"magmax_matmul complex {tag}")
        for L in Ls:
            sa = enc.joint_fast_sft(a_re, a_im, L, 1)
            sb = enc.joint_fast_sft(b_re, b_im, L, 0)
            errs["fast_sft"] = max(
                errs["fast_sft"],
                check_joint_sft(enc.joint_fast_sft(a_re, a_im, L, 1,
                                                   stats=hk.fast_stats),
                                sa, a_re, a_im, 1, L),
                check_joint_sft(enc.joint_fast_sft(b_re, b_im, L, 0,
                                                   stats=hk.fast_stats),
                                sb, b_re, b_im, 0, L))
            if special:
                assert int(sa[1]) == 0 and int(sb[0, 3]) == 0
            a8 = [hk.encode_slices(x, sa, L, 1) for x in (a_re, a_im)]
            b8 = [hk.encode_slices(x, sb, L, 0) for x in (b_re, b_im)]
            hold(errs, "encode_slices", tuple(a8 + b8),
                 tuple([hk.encode_slices_plain(x, sa, L, 1)
                        for x in (a_re, a_im)]
                       + [hk.encode_slices_plain(x, sb, L, 0)
                          for x in (b_re, b_im)]),
                 f"encode_slices complex {tag} L={L}")
            kara = (sg.recenter_add_int8(a8[0], a8[1], L),
                    sg.recenter_add_int8(b8[0], b8[1], L))
            for ks in (None, kara):
                for centered in (True, False):
                    form = "4-dot" if ks is None else "Karatsuba"
                    hold(errs, "matmul_complex_mod",
                         hm.matmul_complex_mod(*a8, *b8, L, centered, ks),
                         hm.matmul_complex_mod_plain(*a8, *b8, L, centered,
                                                     ks),
                         f"matmul_complex_mod {form} {tag} L={L} "
                         f"centered={centered}")
        log(f"  complex kernels == plain at {tag} L={Ls}")


def complex_edge_slices(pattern, L, m, k, n, seed):
    """(A parts, B parts), three each (Re, Im, the Karatsuba sum, taken
    as given: the kernel takes any int8), on the card, in one of
    COMPLEX_EDGE_PATTERNS."""
    a = [torch.empty((L, m, k), dtype=torch.int8, device=DEVICE)
         for _ in range(3)]
    b = [torch.empty((L, k, n), dtype=torch.int8, device=DEVICE)
         for _ in range(3)]
    if pattern in ("neg", "odd"):
        for x in a + b:
            x.fill_(-128)
        if pattern == "odd":       # random in the 256 lane
            gen = torch.Generator(device=DEVICE).manual_seed(seed)
            for x in a + b:
                x[0] = torch.randint(-128, 128, x.shape[1:], generator=gen,
                                     dtype=torch.int8, device=DEVICE)
    elif pattern == "pos":
        for x in a + b:
            x.fill_(127)
    else:                          # mixed signs
        for x in a:
            x.fill_(-128)
        for x in b:
            x.fill_(127)
        b[2].fill_(-128)
        a[1][:, ::2] = 127
        b[1][:, :, 1::2] = -128
    return a, b


def phase_complex_edge(errs):
    """Phase 3e (also): matmul_complex_mod at k = 2^16 on extreme slices,
    both forms, centered and not, bit-equal to its plain version."""
    L, k = tables.MAX_MODULI, COMPLEX_EDGE_K
    m, n = COMPLEX_EDGE_MN
    for i, pattern in enumerate(COMPLEX_EDGE_PATTERNS):
        a, b = complex_edge_slices(pattern, L, m, k, n, 300 + i)
        for kara in (None, (a[2], b[2])):
            for centered in (True, False):
                form = "4-dot" if kara is None else "Karatsuba"
                hold(errs, "matmul_complex_mod",
                     hm.matmul_complex_mod(a[0], a[1], b[0], b[1], L,
                                           centered, kara),
                     hm.matmul_complex_mod_plain(a[0], a[1], b[0], b[1], L,
                                                 centered, kara),
                     f"matmul_complex_mod {form} k={k} {pattern} "
                     f"centered={centered}")
        del a, b
    log(f"  matmul_complex_mod == plain at k = {k}, m x n = {m} x {n}, L = "
        f"{L}, slices {', '.join(COMPLEX_EDGE_PATTERNS)}: both forms, "
        "centered and not")


def phase_pipelined_edges(errs):
    """Phase 3v (also): the ping-pong matmul_mod_u8_pipelined at PIPE_EDGES
    (k = 2^17 with the 256 lane all -128 and the odd lanes at +-127, then
    random; a ragged shape), PIPE_REPEATS runs each, bit-equal to each
    other, to the plain version and to matmul_mod_u8(centered=False)."""
    for i, (m, k, n, L) in enumerate(PIPE_EDGES):
        gen = torch.Generator(device=DEVICE).manual_seed(400 + i)
        a8, b8 = (torch.randint(-128, 128, shape, generator=gen,
                                dtype=torch.int8, device=DEVICE)
                  for shape in ((L, m, k), (L, k, n)))
        cases = [("random", a8, b8)]
        if k == tables.MAX_K:
            w8 = torch.full_like(a8, -127)
            v8 = torch.full_like(b8, 127)
            w8[0] = -128
            v8[0] = -128
            v8[1:, :, ::2] = -127
            cases.insert(0, ("wrap", w8, v8))
        for tag, x, y in cases:
            runs = [hm.matmul_mod_u8_pipelined(x, y, L)
                    for _ in range(PIPE_REPEATS)]
            for r in runs[1:]:
                assert torch.equal(r, runs[0]), \
                    f"matmul_mod_u8_pipelined {tag} m={m} k={k} n={n}: " \
                    "runs differ"
            hold(errs, "matmul_mod_u8_pipelined", runs[0],
                 hm.matmul_mod_u8_pipelined_plain(x, y, L),
                 f"matmul_mod_u8_pipelined {tag} m={m} k={k} n={n} L={L}")
            assert torch.equal(runs[0], hm.matmul_mod_u8(x, y, L)), \
                f"matmul_mod_u8_pipelined {tag} m={m} k={k} n={n}: not " \
                "matmul_mod_u8's"
            if tag == "wrap":
                assert bool((runs[0][0] == 0).all()), \
                    "the 256 lane's 2^31 is not 0 mod 256"
            del runs
        del a8, b8, cases
        log(f"  matmul_mod_u8_pipelined == plain == matmul_mod_u8 at m={m} "
            f"k={k} n={n} L={L}, {PIPE_REPEATS} runs bit-equal"
            + (" (and the wrapping 256 lane)" if k == tables.MAX_K else ""))


@contextlib.contextmanager
def switches(env):
    """The JAX package's switches set in this process, restored after."""
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def phase_variant_kernels(errs):
    """Phase 3v: the variant kernels vs their plain versions (and the
    default kernels whose bits they must give)."""
    for (m, k, n), Ls, special in VARIANT_CASES:
        a, b = operands(m, k, n, 7, special)
        tag = f"m={m} k={k} n={n}"
        mags = []
        for x, axis in ((a, 1), (b, 0)):
            got = hk.mag7_fused(x, axis)
            hold(errs, "mag7_fused", got, hk.mag7_fused_plain(x, axis),
                 f"mag7_fused {tag} axis={axis}")
            e = hk.emax(x, axis)
            assert torch.equal(got[1], e) and torch.equal(
                got[0], hk.mag7(x, e, axis)), \
                f"mag7_fused {tag}: not the emax + mag7 kernels' bits"
            mags.append(got[0])
        smax = hm.magmax_scratch_plain(*mags)
        assert all(torch.equal(x, y)
                   for x, y in zip(hm.magmax_matmul(*mags), smax))
        # mag7's K-major views, and contiguous operands the wrapper copies
        for x, y in (mags, [t.contiguous() for t in mags]):
            hold(errs, "magmax_matmul_scratch",
                 hm.magmax_matmul_scratch(x, y), smax,
                 f"magmax_matmul_scratch {tag}")
        for L in Ls:
            slices = []
            for x, axis in ((a, 1), (b, 0)):
                sl, sft = hk.fast_encode_fused(x, L, axis)
                assert torch.equal(sft, hk.fast_sft(x, L, axis)), \
                    f"fast_encode_fused {tag} L={L}: shifts differ from " \
                    "the fast_sft kernel's"
                _, psft = hk.fast_encode_fused_plain(x, L, axis)
                e = check_sft(sft, psft, x, axis, L)
                errs["fast_encode_fused"] = max(errs["fast_encode_fused"], e)
                hold(errs, "fast_encode_fused", sl,
                     hk.encode_slices_plain(x, sft, L, axis),
                     f"fast_encode_fused slices {tag} L={L} axis={axis}")
                slices.append(sl)
            r = hm.matmul_mod_u8_pipelined(*slices, L)
            hold(errs, "matmul_mod_u8_pipelined", r,
                 hm.matmul_mod_u8_pipelined_plain(*slices, L),
                 f"matmul_mod_u8_pipelined {tag} L={L}")
            assert torch.equal(r, hm.matmul_mod_u8(*slices, L)), \
                f"matmul_mod_u8_pipelined {tag} L={L}: not matmul_mod_u8's"
        log(f"  variant kernels == plain at {tag} L={Ls}")


def late_max_lines(x, axis):
    """x with its first lines (rows for axis=1, columns for axis=0) made
    hard for a kernel that reads a line once: line 0 at 2^-40 of itself
    but its last element 1.5 (the max arrives last, 40 binades up); line 1
    zero in its first half, then a subnormal, then its own values; line 2
    -0.0 at every third element; line 3 at 2^-70 of itself but its last
    element 1.5 (70 binades up, in a later 2048-wide chunk than its first
    nonzero where the line is longer than one)."""
    y = (x if axis == 1 else x.t()).clone()
    tiny = 5e-324 if y.dtype == torch.float64 else 1e-45
    y[0] *= 2.0 ** -40
    y[0, -1] = 1.5
    if y.shape[0] > 1:
        y[1, :y.shape[1] // 2] = 0.0
        y[1, y.shape[1] // 2] = tiny
    if y.shape[0] > 2:
        y[2, ::3] = -0.0
    if y.shape[0] > 3:
        y[3] *= 2.0 ** -70
        y[3, -1] = 1.5
    return (y if axis == 1 else y.t()).contiguous()


def hold_fused_stats(errs, x, axis, Ls, tag):
    """fast_encode_fused and mag7_fused (shifts 5 and 4) on x: the shifts
    the fast_sft kernel's bits (and the plain version's under the floor
    rule), the slices the plain encode's at them, the magnitudes and
    exponents the plain version's and the emax + mag7 kernels'; and
    fast_sft's statistics mode held to its plain version (check_stats)."""
    f32 = x.dtype == torch.float32
    enc_key = build.form("fast_encode_fused", f32)
    mag_key = build.form("mag7_fused", f32)
    check_stats(errs, x, axis, Ls[0])
    for L in Ls:
        sl, sft = hk.fast_encode_fused(x, L, axis)
        assert torch.equal(sft, hk.fast_sft(x, L, axis)), \
            f"fast_encode_fused {tag} L={L}: shifts differ from fast_sft's"
        _, psft = hk.fast_encode_fused_plain(x, L, axis)
        errs[enc_key] = max(errs[enc_key], check_sft(sft, psft, x, axis, L))
        hold(errs, enc_key, sl, hk.encode_slices_plain(x, sft, L, axis),
             f"fast_encode_fused slices {tag} L={L}")
    for shift in (enc.MAG_SHIFT, enc.MAG_SHIFT_COMPLEX):
        got = hk.mag7_fused(x, axis, shift)
        hold(errs, mag_key, got, hk.mag7_fused_plain(x, axis, shift),
             f"mag7_fused {tag} shift {shift}")
        e = hk.emax(x, axis)
        assert torch.equal(got[1], e) and torch.equal(
            got[0], hk.mag7(x, e, axis, shift)), \
            f"mag7_fused {tag} shift {shift}: not the emax + mag7 kernels' bits"


def phase_fused_stats_edges(errs):
    """Phase 3v: the fused statistics kernels at FUSED_EDGE_CASES, f64 and
    f32, each operand as made and with late-max lines."""
    for (m, k, n), Ls, special in FUSED_EDGE_CASES:
        for word in ("f64", "f32"):
            if word == "f64":
                a, b = operands(m, k, n, 9, special)
            else:
                a, b = operands32(m, k, n, 9, special)
            for x, axis in ((a, 1), (b, 0)):
                for late in (False, True):
                    y = late_max_lines(x, axis) if late else x
                    hold_fused_stats(errs, y, axis, Ls,
                                     f"{word} m={m} k={k} n={n} axis={axis}"
                                     + (" late max" if late else ""))
            del a, b
        log(f"  fast_encode_fused, mag7_fused (f64, f32, late-max lines) "
            f"== plain at m={m} k={k} n={n} L={Ls}")


def moduli_subsets(L):
    """The chunks of ModuliSchedule(L, 5), the 256 lane alone, and a tuple
    out of order (the last modulus first)."""
    subsets = [tuple(range(j0, j0 + w))
               for j0, w in planner.ModuliSchedule(L, 5).chunks()]
    return subsets + [(0,), tuple(dict.fromkeys(
        j for j in (L - 1, 0, 3, 1) if j < L))]


def phase_schedule_kernels(errs):
    """Phase 3s: the kernels' new inputs and the two CRT-fused GEMMs vs
    their plain versions."""
    for (m, k, n), Ls, special in SCHEDULE_CASES:
        a, b = operands(m, k, n, 7, special)
        for L in Ls:
            tag = f"m={m} k={k} n={n} L={L}"
            sa = hk.fast_sft_plain(a, L, axis=1)
            sb = hk.fast_sft_plain(b, L, axis=0)
            a8 = hk.encode_slices(a, sa, L, axis=1)
            b8 = hk.encode_slices(b, sb, L, axis=0)
            for idx in moduli_subsets(L):
                ai = hk.encode_slices(a, sa, L, 1, moduli_idx=idx)
                bi = hk.encode_slices(b, sb, L, 0, moduli_idx=idx)
                hold(errs, "encode_slices", (ai, bi),
                     (hk.encode_slices_plain(a, sa, L, 1, idx),
                      hk.encode_slices_plain(b, sb, L, 0, idx)),
                     f"encode_slices {tag} moduli {idx}")
                assert torch.equal(ai, a8[list(idx)]), \
                    f"encode_slices {tag} moduli {idx}: not the full " \
                    "call's slices"
                for centered in (True, False):
                    hold(errs, "matmul_mod_u8",
                         hm.matmul_mod_u8(ai, bi, L, centered, idx),
                         hm.matmul_mod_u8_plain(ai, bi, L, centered, idx),
                         f"matmul_mod_u8 {tag} moduli {idx}")
                hold(errs, "matmul_mod_u8_pipelined",
                     hm.matmul_mod_u8_pipelined(ai, bi, L, idx),
                     hm.matmul_mod_u8_plain(ai, bi, L, False, idx),
                     f"matmul_mod_u8_pipelined {tag} moduli {idx}")
            r8 = hm.matmul_mod_u8(a8, b8, L, centered=True)
            ref = hk.reconstruct(r8, sa, sb, L)
            limbs = hm.matmul_crt(a8, b8, L)
            hold(errs, "matmul_crt", limbs, hm.matmul_crt_plain(a8, b8, L),
                 f"matmul_crt {tag}")
            assert 0 <= int(limbs.min()) and int(limbs.max()) <= 0xFFFF, \
                f"matmul_crt {tag}: limbs not canonical"
            # a carry pushed back into limb 0: the same integer, not canonical
            pushed = limbs.clone()
            take = pushed[1].clamp(max=8000)
            pushed[1] -= take
            pushed[0] += take << 16
            prod = torch.stack([(a8[l].double() @ b8[l].double()).to(
                torch.int32) for l in range(L)])
            for x, kind, e in ((limbs, "limbs", 0), (limbs, "limbs", -7),
                               (pushed, "limbs", 0), (prod, "residues", 0),
                               (prod, "residues", 5)):
                c = hk.reconstruct(x, sa, sb, L, e_extra=e, input_kind=kind)
                hold(errs, "reconstruct", c,
                     hk.reconstruct_plain(x, sa, sb, L, "f64", e, kind),
                     f"reconstruct {tag} int32 {kind} e_extra={e}")
                if e == 0:
                    assert_bits_equal(c, ref, f"reconstruct {tag} int32 "
                                      f"{kind} vs residue input")
            fused = hm.matmul_reconstruct(a8, b8, sa, sb, L)
            hold(errs, "matmul_reconstruct", fused,
                 hm.matmul_reconstruct_plain(a8, b8, sa, sb, L),
                 f"matmul_reconstruct {tag}")
            assert_bits_equal(fused, ref, f"matmul_reconstruct {tag} vs "
                              "matmul_mod_u8 + reconstruct")
            # the chunk fold's torch ops on the card: uint8 residues added
            # into int32 limbs, left without carries for the reconstruct
            folded = rec.fold_chunk_(
                torch.zeros_like(limbs),
                hm.matmul_mod_u8(a8, b8, L, centered=False), L,
                tuple(range(L)))
            assert_bits_equal(
                hk.reconstruct(folded, sa, sb, L, input_kind="limbs"), ref,
                f"chunk fold {tag}")
            log(f"  schedule kernels == plain at {tag}")


def accurate_plain_sfts(a, b, L):
    """Accurate-mode shifts with every step a plain version (each operand
    at its own exponent bias, f64 or f32)."""
    ea, eb = hk.emax_plain(a, 1), hk.emax_plain(b, 0)
    sa, sb = hm.magmax_plain(hk.mag7_plain(a, ea, 1),
                             hk.mag7_plain(b, eb, 0))
    return (enc.accurate_sft(sa, ea, L, mant_bits=enc.mant_bits_of(a)),
            enc.accurate_sft(sb, eb, L, mant_bits=enc.mant_bits_of(b)))


def plain_gemm(a, b, L, sfts=None):
    """The main path with every step a plain version, on a's device."""
    if sfts is None:
        sfts = (hk.fast_sft_plain(a, L, 1), hk.fast_sft_plain(b, L, 0))
    sa, sb = sfts
    a8 = hk.encode_slices_plain(a, sa, L, 1)
    b8 = hk.encode_slices_plain(b, sb, L, 0)
    r8 = hm.matmul_mod_u8_plain(a8, b8, L, centered=True)
    return hk.reconstruct_plain(r8, sa, sb, L), sa, sb


def gate(c, oracle):
    """Max relerr of three 256 x 256 tiles of c against the dd oracle."""
    worst = 0.0
    for (r0, c0), (hi, lo) in oracle.items():
        got = c[r0:r0 + 256, c0:c0 + 256].cpu().numpy()
        rel, _ = relerr_vs_dd(got, hi, lo)
        worst = max(worst, rel)
    return worst


def main_call(a, b, fastmode, want, oracle):
    """One main-path call with the launch counts reset just before it and
    read just after; returns (output, launches, gate relerr)."""
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    c = gt.gemm(a, b, num_moduli=L_MAIN, fastmode=fastmode, device=DEVICE)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    mode = "fast" if fastmode else "accurate"
    log(f"  launches in the {N}^3 {mode} call: {launches}")
    assert launches == want, f"{mode} launch counts {launches}"
    assert c.shape == (N, N) and c.dtype == torch.float64
    assert bool(torch.isfinite(c).all()), "non-finite output"
    worst = gate(c, oracle)
    assert worst < 1e-8, f"{mode} relerr {worst} >= 1e-8"
    return c, launches, worst


def phase_slice(launches):
    """Phase 4: the main path at N^3 in both modes and the kernel-vs-plain
    slice at N_PLAIN^3."""
    a_np = phi_matrix(N, N, 0.5, seed=0)
    a = torch.from_numpy(a_np).to(DEVICE)
    b = a.t().contiguous()
    oracle = {(r0, c0): dd_gemm(a_np[r0:r0 + 256],
                                np.ascontiguousarray(a_np.T[:, c0:c0 + 256]))
              for r0, c0 in [(0, 0), (N // 2, N - 256), (N - 256, N - 256)]}
    c_fast, fast, rel_fast = main_call(a, b, True, FAST_LAUNCHES, oracle)
    c_accu, accu, rel_accu = main_call(a, b, False, ACCURATE_LAUNCHES,
                                       oracle)
    for name in KERNELS:
        launches[name] = fast.get(name, 0) + accu.get(name, 0)
    log(f"  gate tiles max relerr vs dd oracle: fast {rel_fast!r}, "
        f"accurate {rel_accu!r}")
    a2 = a[:N_PLAIN, :N_PLAIN].contiguous()
    b2 = b[:N_PLAIN, :N_PLAIN].contiguous()
    ck = gt.gemm(a2, b2, num_moduli=L_MAIN, device=DEVICE)
    cp, pa, pb = plain_gemm(a2, b2, L_MAIN)
    sa = hk.fast_sft(a2, L_MAIN, 1)
    sb = hk.fast_sft(b2, L_MAIN, 0)
    if not (torch.equal(sa, pa) and torch.equal(sb, pb)):
        check_sft(sa, pa, a2, 1, L_MAIN)
        check_sft(sb, pb, b2, 0, L_MAIN)
        cp, _, _ = plain_gemm(a2, b2, L_MAIN, (sa, sb))
    assert_bits_equal(ck, cp, f"{N_PLAIN}^3 kernel path vs plain path")
    log(f"  {N_PLAIN}^3 kernel path == all-plain path (bits)")
    ck = gt.gemm(a2, b2, num_moduli=L_MAIN, fastmode=False, device=DEVICE)
    sa, sb = tg.accurate_sfts(a2, b2, L_MAIN)
    pa, pb = accurate_plain_sfts(a2, b2, L_MAIN)
    assert torch.equal(sa, pa) and torch.equal(sb, pb), \
        "accurate shifts: kernel path vs plain path"
    cp, _, _ = plain_gemm(a2, b2, L_MAIN, (pa, pb))
    assert_bits_equal(ck, cp, f"{N_PLAIN}^3 accurate kernel path vs plain "
                      "path")
    log(f"  {N_PLAIN}^3 accurate kernel path == all-plain path (bits)")
    return a, b, rel_fast, rel_accu, {True: c_fast, False: c_accu}, oracle


def digest(t):
    """blake2b of a tensor's bytes (complex as its (re, im) words): phase
    4d's child and phase 4 compare outputs by it."""
    if t.is_complex():
        t = torch.view_as_real(t)
    host = t.contiguous().cpu().numpy()
    return hashlib.blake2b(memoryview(host).cast("B")).hexdigest()


def phase_intercept(a, b, refs, launches):
    """Phase 4i: the main path through interception at N^3 on phase 4's
    operands: `A @ B`, torch.matmul, torch.einsum and torch.mm under
    override_matmuls(profile=True), each with phase 4's fast bits and
    FAST_LAUNCHES; a 32 x 32 call native with no launch; one accurate call
    with ACCURATE_LAUNCHES and phase 4's accurate bits; nothing after the
    context's exit; then the intercepted call beside the direct gemm call
    in one rotation. Returns (intercepted ms, gemm ms, clock)."""
    calls = {"A @ B": lambda: a @ b,
             "torch.matmul": lambda: torch.matmul(a, b),
             "torch.einsum": lambda: torch.einsum("ij,jk->ik", a, b),
             "torch.mm": lambda: torch.mm(a, b)}
    icept.clear_profile_log()
    with icept.override_matmuls(num_moduli=L_MAIN, fastmode=True,
                                profile=True):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            build.LAUNCHES.clear()
            c = fn()
            torch.cuda.synchronize()
            counts = dict(build.LAUNCHES)
            log(f"  launches in the intercepted {name} ({N}^3 fast): "
                f"{counts}")
            assert counts == FAST_LAUNCHES, f"{name}: launch counts {counts}"
            assert_bits_equal(c, refs[True], f"intercepted {name} vs phase "
                              "4's fast gemm")
            add_launches(launches, counts)
            del c
        build.LAUNCHES.clear()
        small = a[:32, :32] @ b[:32, :32]
        torch.cuda.synchronize()
        assert not build.LAUNCHES, f"32 x 32 call launched {build.LAUNCHES}"
        assert icept.get_last_func_name() == \
            "matmul[32x32x32,float64]->native"
        del small
    records = icept.get_profile_log()
    assert [r.mode for r in records] == [f"emulate-{L_MAIN}"] * 4 + [
        "native"], [r.mode for r in records]
    assert all(r.seconds > 0 for r in records), records
    log("  profile log: " + "; ".join(
        f"{r.m}x{r.k}x{r.n} {r.dtype} {r.mode} {r.seconds * 1e3:.3f} ms"
        for r in records))
    with icept.override_matmuls(num_moduli=L_MAIN, fastmode=False):
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        c = a @ b
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
    log(f"  launches in the intercepted A @ B ({N}^3 accurate): {counts}")
    assert counts == ACCURATE_LAUNCHES, f"accurate launch counts {counts}"
    assert_bits_equal(c, refs[False], "intercepted accurate A @ B vs phase "
                      "4's accurate gemm")
    add_launches(launches, counts)
    del c
    build.LAUNCHES.clear()
    c = a @ b
    torch.cuda.synchronize()
    assert not build.LAUNCHES and not icept.is_library_loaded(), \
        f"A @ B after the context launched {build.LAUNCHES}"
    del c
    log(f"  4i: @, matmul, einsum and mm give phase 4's bits; the 32 x 32 "
        "call and A @ B after exit launch nothing of the port")

    def intercepted():
        with icept.override_matmuls(num_moduli=L_MAIN, fastmode=True):
            return a @ b

    with ClockSampler() as clock:
        by, _ = timed_rounds({
            "intercepted": intercepted,
            "gemm": lambda: gt.gemm(a, b, num_moduli=L_MAIN,
                                    device=DEVICE)}, MAIN_ROUNDS, 2)
    return (float(np.median(by["intercepted"])), float(np.median(by["gemm"])),
            clock.summary(), by)


# phase 4d: launch counts of the sharded calls on a 1x1 mesh
SHARDED_FAST_LAUNCHES = {"fast_stats": 2, "encode_slices": 2,
                         "matmul_mod_u8": 1, "reconstruct": 1}
SHARDED_ACCURATE_LAUNCHES = {"emax": 2, "mag7": 2, "encode_slices": 2,
                             "matmul_mod_u8": 1, "reconstruct": 1}
SHARDED_COMPLEX_LAUNCHES = {
    CT.COMPLEX_BIG_MATRIX_ENCODE: {"fast_stats": 4, "encode_slices": 4,
                                   "matmul_mod_u8": 1, "reconstruct": 1},
    CT.COMPLEX_CLASSIC_MULT: {"fast_stats": 4, "encode_slices": 4,
                              "matmul_complex_mod": 1, "reconstruct": 1},
    CT.COMPLEX_KARATSUBA_MULT: {"fast_stats": 4, "encode_slices": 4,
                                "matmul_complex_mod": 1, "reconstruct": 1}}
N_SHARDED_COMPLEX = 2048
# phase 4d's process and the backend its world of one rank must be on
SHARDED_CHILD = [sys.executable, os.path.abspath(__file__), "sharded-child"]
SHARDED_BACKEND = "nccl"


def rounds_text(mss):
    return ", ".join(f"{t:.3f}" for t in mss)


def phases_4i_4d(a, b, refs, launches, card):
    """Phases 4i and 4d on phase 4's operands and outputs, with their
    times beside gemm's."""
    i_ms, g_ms, i_clock, i_by = phase_intercept(a, b, refs, launches)
    log(f"  4i: intercepted A @ B {N}^3 fast median {i_ms:.3f} ms (rounds "
        f"{rounds_text(i_by['intercepted'])}) beside gemm {g_ms:.3f} ms "
        f"(rounds {rounds_text(i_by['gemm'])}) in one rotation, "
        f"{MAIN_ROUNDS} rounds, 2 calls per timing: ratio "
        f"{i_ms / g_ms:.4f} ({i_clock}; {card})")
    shard, glo = phase_sharded(a, refs, launches)
    for mode in ("fast", "accurate"):
        held = ("phase 4's bits" if mode not in glo.get("differ", {}) else
                f"phase 4's bits but at floor boundaries "
                f"({glo['differ'][mode]})")
        log(f"  4d: {GLOO_RANKS} ranks on this card over gloo, mesh 2x2, "
            f"gemm_sharded {N}^3 {mode}: {held}; launches a rank "
            f"{glo['launches'][mode]}; rank 0's call {glo['ms'][mode]:.1f} "
            f"ms wall (gloo stages every collective through host memory; "
            f"{card})")
    for mode in ("fast", "accurate"):
        s_by = shard["ms"][f"gemm_sharded {mode}"]
        d_by = shard["ms"][f"gemm {mode}"]
        s_ms, d_ms = float(np.median(s_by)), float(np.median(d_by))
        log(f"  4d: gemm_sharded {N}^3 {mode} (1x1 NCCL) median {s_ms:.3f} "
            f"ms (rounds {rounds_text(s_by)}) beside gemm {d_ms:.3f} ms "
            f"(rounds {rounds_text(d_by)}) in one rotation, {MAIN_ROUNDS} "
            f"rounds, 2 calls per timing: ratio {s_ms / d_ms:.4f} "
            f"({shard['clock']}; {card})")
    for name, prof in shard["profile"].items():
        log(f"  4d profile, one {name} fast call: device ops "
            f"{prof['total_ms']:.3f} ms; "
            + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in prof["top"]))


def sharded_main():
    """`python3 chip_smoke.py sharded`: build the kernels, run phase 4's
    main calls, then phases 4i and 4d, and stop (no result line)."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    build.lib()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    launches = {}
    a, b, _, _, refs, _ = phase_slice(launches)
    phases_4i_4d(a, b, refs, launches, card)
    log(f"phases 4, 4i and 4d passed in {time.perf_counter() - t0:.1f} s")


def sharded_child():
    """`python3 chip_smoke.py sharded-child`, phase 4d's process: a world of
    one rank on NCCL from the GEMMUL8_* variables, a 1x1 mesh, gemm_sharded
    at N^3 on phase 4's operands (A from the file SMOKE_A names, B = A.T)
    in both modes (launch counts asserted,
    digests of the outputs printed for phase 4 to compare), the three
    complex strategies at N_SHARDED_COMPLEX^3 bit-equal to the complex gemm,
    and the sharded calls beside gemm in one rotation; prints one line
    "4d-json {...}"."""
    import torch.distributed as dist

    from gemmul8_tpu_torch.parallel import distributed as sd
    from gemmul8_tpu_torch.parallel import multihost

    assert multihost.initialize_from_env(), "no process group started"
    assert dist.get_backend() == SHARDED_BACKEND, dist.get_backend()
    log("  " + multihost.process_summary())
    mesh = sd.make_mesh()
    assert (mesh.nx, mesh.ny) == (1, 1)
    a = torch.from_numpy(np.load(os.environ["SMOKE_A"])).to(DEVICE)
    b = a.t().contiguous()
    A, B = sd.shard_of(a, mesh, ("x", "y")), sd.shard_of(b, mesh, ("y", "x"))
    out = {"launches": {}, "digests": {}}
    for fastmode, want in ((True, SHARDED_FAST_LAUNCHES),
                           (False, SHARDED_ACCURATE_LAUNCHES)):
        mode = "fast" if fastmode else "accurate"
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        c = sd.gemm_sharded(A, B, mesh, num_moduli=L_MAIN, fastmode=fastmode)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        log(f"  launches in gemm_sharded {N}^3 {mode} (1x1 NCCL): {counts}")
        assert counts == want, f"sharded {mode} launch counts {counts}"
        assert c.shape == (N, N) and c.dtype == torch.float64
        out["launches"][mode] = counts
        out["digests"][mode] = digest(c)
        del c
    parts = [torch.from_numpy(phi_matrix(N_SHARDED_COMPLEX,
                                         N_SHARDED_COMPLEX, 0.5, seed=s))
             for s in (0, 1)]
    za = torch.complex(*parts).to(DEVICE)
    zb = za.t().contiguous()
    ZA, ZB = sd.shard_of(za, mesh, ("x", "y")), sd.shard_of(zb, mesh,
                                                             ("y", "x"))
    for ct, want in SHARDED_COMPLEX_LAUNCHES.items():
        ref = gt.gemm(za, zb, num_moduli=L_MAIN, compute_type=ct,
                      device=DEVICE)
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        c = sd.gemm_sharded_complex(ZA, ZB, mesh, num_moduli=L_MAIN,
                                    compute_type=ct)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        log(f"  launches in gemm_sharded_complex {N_SHARDED_COMPLEX}^3 "
            f"{ct.name}: {counts}")
        assert counts == want, f"sharded {ct.name} launch counts {counts}"
        assert c.dtype == torch.complex128
        assert torch.equal(torch.view_as_real(c).view(torch.int64),
                           torch.view_as_real(ref).view(torch.int64)), \
            f"gemm_sharded_complex {ct.name} vs the complex gemm"
        out["launches"][ct.name] = counts
        del c, ref
    log(f"  the three sharded complex strategies give the complex gemm's "
        f"bits at {N_SHARDED_COMPLEX}^3")
    with ClockSampler() as clock:
        by, _ = timed_rounds({
            "gemm_sharded fast": lambda: sd.gemm_sharded(
                A, B, mesh, num_moduli=L_MAIN),
            "gemm fast": lambda: gt.gemm(a, b, num_moduli=L_MAIN,
                                         device=DEVICE),
            "gemm_sharded accurate": lambda: sd.gemm_sharded(
                A, B, mesh, num_moduli=L_MAIN, fastmode=False),
            "gemm accurate": lambda: gt.gemm(a, b, num_moduli=L_MAIN,
                                             fastmode=False, device=DEVICE)},
            MAIN_ROUNDS, 2)
    out["ms"] = by
    out["clock"] = clock.summary()
    out["profile"] = {
        "gemm_sharded": device_profile(lambda: sd.gemm_sharded(
            A, B, mesh, num_moduli=L_MAIN)),
        "gemm": device_profile(lambda: gt.gemm(a, b, num_moduli=L_MAIN,
                                               device=DEVICE))}
    dist.destroy_process_group()
    print("4d-json " + json.dumps(out), flush=True)


def device_profile(fn, top=8):
    """torch.profiler over one call of fn: the device time of its
    costliest ops (name, ms, count) and the window's summed device ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    rows = sorted(prof.key_averages(), key=dev_ms, reverse=True)
    return {"total_ms": sum(dev_ms(e) for e in rows),
            "top": [(e.key[:60], dev_ms(e), e.count) for e in rows[:top]]}


# phase 4d: the 2x2 world of four ranks sharing this card over gloo
GLOO_RANKS = 4
GLOO_CHILD = [sys.executable, os.path.abspath(__file__), "gloo-child"]


def gloo_child():
    """`python3 chip_smoke.py gloo-child`, one of phase 4d's four ranks: a
    gloo world from the GEMMUL8_* variables whose 2x2 mesh names this card
    (gloo moves the CUDA shards through host memory); once the file GLOO_GO
    names exists, gemm_sharded at N^3 global on phase 4's operands (the
    file SMOKE_A) in both modes with launch counts; rank 0
    gathers the tiles, assembles them and prints "4d-gloo-json {...}" with
    their digests (and, where they differ from GLOO_WANT's, the rows and
    columns that differ)."""
    import torch.distributed as dist

    from gemmul8_tpu_torch.parallel import distributed as sd
    from gemmul8_tpu_torch.parallel import multihost

    assert multihost.initialize_from_env(force_cpu=True)
    assert dist.get_backend() == "gloo"
    torch.cuda.set_device(0)
    mesh = sd.make_mesh(shape=(2, 2), device="cuda:0")
    src = torch.from_numpy(np.load(os.environ["SMOKE_A"]))
    A = sd.shard_of(src, mesh, ("x", "y"))
    B = sd.shard_of(src.t(), mesh, ("y", "x"))
    del src
    want = json.loads(os.environ["GLOO_WANT"])
    while not os.path.exists(os.environ["GLOO_GO"]):   # the 1x1 run is done
        time.sleep(0.2)
    out = {"launches": {}, "digests": {}, "ms": {}}
    for fastmode, counts_want in ((True, SHARDED_FAST_LAUNCHES),
                                  (False, SHARDED_ACCURATE_LAUNCHES)):
        mode = "fast" if fastmode else "accurate"
        dist.barrier()
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        tile = sd.gemm_sharded(A, B, mesh, num_moduli=L_MAIN,
                               fastmode=fastmode)
        torch.cuda.synchronize()
        out["ms"][mode] = (time.perf_counter() - t0) * 1e3
        counts = dict(build.LAUNCHES)
        assert counts == counts_want, f"rank {mesh.rank} {mode}: {counts}"
        tiles = ([torch.empty_like(tile, device="cpu")
                  for _ in range(GLOO_RANKS)] if mesh.rank == 0 else None)
        dist.gather(tile.cpu(), tiles, dst=0)
        del tile
        if mesh.rank == 0:
            full = sd.assemble(tiles, mesh)
            out["launches"][mode] = counts
            out["digests"][mode] = digest(full)
            if out["digests"][mode] != want[mode]:
                out.setdefault("differ", {})[mode] = full_differs(full,
                                                                  fastmode)
            del full, tiles
    dist.destroy_process_group()
    if mesh.rank == 0:
        print("4d-gloo-json " + json.dumps(out), flush=True)


def full_differs(full, fastmode):
    """Where the 2x2 result differs from the 1x1 call's words on the card:
    the rows and columns holding a differing word, and the floor-boundary
    fraction of their 1x1 shifts (fast mode), for the parent to judge."""
    a = torch.from_numpy(np.load(os.environ["SMOKE_A"])).to(DEVICE)
    b = a.t().contiguous()
    one = gt.gemm(a, b, num_moduli=L_MAIN, fastmode=fastmode, device=DEVICE)
    diff = bits64(full.to(DEVICE)) != bits64(one)
    rows = torch.nonzero(diff.any(dim=1)).flatten()
    cols = torch.nonzero(diff.any(dim=0)).flatten()
    rec = {"words": int(diff.sum()), "rows": rows.tolist()[:64],
           "cols": cols.tolist()[:64]}
    if fastmode:
        fa = enc.sft_floor_frac(hk.fast_stats(a, 1)[1], N, L_MAIN).flatten()
        fb = enc.sft_floor_frac(hk.fast_stats(b, 0)[1], N, L_MAIN).flatten()
        near_a = fa < SHIFT_RULE_FRAC
        near_b = fb < SHIFT_RULE_FRAC
        ok = diff & (near_a[:, None] | near_b[None, :])
        rec["off_boundary_words"] = int((diff & ~ok).sum())
    rel = ((full.to(DEVICE) - one).abs() / one.abs())[diff]
    rec["max_relerr_vs_1x1"] = float(rel.max()) if rel.numel() else 0.0
    return rec


def child_output(text):
    """(the JSON record of a child's "4d...-json " line, or None), the other
    lines logged."""
    record = None
    for line in text.splitlines():
        if line.startswith("4d-json ") or line.startswith("4d-gloo-json "):
            record = json.loads(line.split(" ", 1)[1])
        else:
            log(line)
    return record


def phase_sharded(a, refs, launches):
    """Phase 4d: `sharded_child` in a process of its own, started with
    GEMMUL8_COORD on a free local port, NPROC 1 and PROC_ID 0 (a world of
    one rank on NCCL on this card), its fast and accurate outputs with the
    digests of phase 4's; then GLOO_RANKS `gloo_child` processes on this
    card over gloo, a 2x2 mesh at N^3 global, their assembled result with
    phase 4's digests (or differing only on rows and columns whose shift
    lies at a floor boundary, fast mode). A goes to the children as an .npy
    file; the gloo ranks start beside the 1x1 run and wait for it to end
    before they multiply. Returns (the 1x1 record, rank 0's record)."""
    from gemmul8_tpu_torch.parallel.smoke import free_port

    want = {"fast": digest(refs[True]), "accurate": digest(refs[False])}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.npy")
        np.save(path, a.cpu().numpy())
        go = os.path.join(tmp, "go")
        port = free_port()
        procs = [subprocess.Popen(GLOO_CHILD, stdout=subprocess.PIPE,
                                  text=True, env=dict(
                                      os.environ, SMOKE_A=path, GLOO_GO=go,
                                      GLOO_WANT=json.dumps(want),
                                      GEMMUL8_COORD=f"127.0.0.1:{port}",
                                      GEMMUL8_NPROC=str(GLOO_RANKS),
                                      GEMMUL8_PROC_ID=str(rank)))
                 for rank in range(GLOO_RANKS)]
        try:
            env = dict(os.environ, SMOKE_A=path,
                       GEMMUL8_COORD=f"127.0.0.1:{free_port()}",
                       GEMMUL8_NPROC="1", GEMMUL8_PROC_ID="0",
                       GEMMUL8_LOCAL_DEVICE_IDS=str(
                           torch.cuda.current_device()))
            proc = subprocess.run(SHARDED_CHILD, env=env,
                                  stdout=subprocess.PIPE, text=True,
                                  timeout=900)
            one = child_output(proc.stdout)
            assert proc.returncode == 0 and one is not None, \
                f"phase 4d's process exited {proc.returncode}"
            with open(go, "w"):
                pass
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for fastmode, mode in ((True, "fast"), (False, "accurate")):
        assert one["digests"][mode] == want[mode], \
            f"gemm_sharded {mode} vs phase 4's {mode} gemm: bits differ"
    for counts in one["launches"].values():
        add_launches(launches, counts)
    log("  4d: gemm_sharded on a 1x1 NCCL world gives phase 4's bits in "
        "both modes")
    glo = [child_output(text) for text in outs]
    codes = [p.returncode for p in procs]
    assert not any(codes) and glo[0] is not None, \
        f"phase 4d's gloo ranks exited {codes}"
    glo = glo[0]
    for mode in ("fast", "accurate"):
        diff = glo.get("differ", {}).get(mode)
        # a fast shift may differ by 1 where it lies at a floor boundary
        # (the norm's sum is associated by rank); both encodings are
        # valid, each word within the gate's 1e-8 of the other
        assert diff is None or (mode == "fast"
                                and diff["off_boundary_words"] == 0
                                and diff["max_relerr_vs_1x1"] < 1e-8), \
            f"2x2 gloo {mode} vs the 1x1 call: {diff}"
    for counts in glo["launches"].values():   # every rank's alike
        add_launches(launches, {k: v * GLOO_RANKS for k, v in counts.items()})
    return one, glo


def accurate_plain_sfts_complex(a_re, a_im, b_re, b_im, L):
    """Complex accurate-mode shifts with every step a plain version (each
    operand at its own exponent bias)."""
    ma, ea = mag7_complex_plain(a_re, a_im, 1)
    mb, eb = mag7_complex_plain(b_re, b_im, 0)
    sa, sb = hm.magmax_plain(ma, mb)
    shift = enc.MAG_SHIFT_COMPLEX
    return (enc.accurate_sft(sa, ea, L, shift,
                             mant_bits=enc.mant_bits_of(a_re)),
            enc.accurate_sft(sb, eb, L, shift,
                             mant_bits=enc.mant_bits_of(b_re)))


def plain_gemm_complex(parts, L, fastmode, karatsuba, sfts=None,
                       out="f64"):
    """The complex path with every step a plain version, on the parts'
    device: (complex128 or complex64 product, sft_a, sft_b)."""
    a_re, a_im, b_re, b_im = parts
    if sfts is None and fastmode:
        sfts = (enc.joint_fast_sft(a_re, a_im, L, 1),
                enc.joint_fast_sft(b_re, b_im, L, 0))
    elif sfts is None:
        sfts = accurate_plain_sfts_complex(*parts, L)
    sa, sb = sfts
    a8 = [hk.encode_slices_plain(x, sa, L, 1) for x in (a_re, a_im)]
    b8 = [hk.encode_slices_plain(x, sb, L, 0) for x in (b_re, b_im)]
    kara = None
    if karatsuba:
        kara = (sg.recenter_add_int8(*a8, L), sg.recenter_add_int8(*b8, L))
    r_re, r_im = hm.matmul_complex_mod_plain(*a8, *b8, L, True, kara)
    return (torch.complex(hk.reconstruct_plain(r_re, sa, sb, L, out),
                          hk.reconstruct_plain(r_im, sa, sb, L, out)), sa,
            sb)


def complex_relerrs(c, oracle):
    """|c - ref| / |ref| over three 256 x 256 tiles of c against the
    complex dd oracle, the difference taken against hi, then lo."""
    errs = []
    for (r0, c0), ((hr, lr), (hi_, li)) in oracle.items():
        got = c[r0:r0 + 256, c0:c0 + 256].cpu().numpy().astype(np.complex128)
        d = np.hypot((got.real - hr) - lr, (got.imag - hi_) - li)
        errs.append((d / np.hypot(hr, hi_)).ravel())
    return np.concatenate(errs)


def complex_gate(c, oracle):
    """Max complex_relerrs."""
    return float(complex_relerrs(c, oracle).max())


def complex_oracle(a_re, a_im, x_re=None, x_im=None):
    """dd products of three 256 x 256 tiles of A @ B, A = a_re + i a_im and
    B = X.T (X = A unless x_re, x_im are given): Re = [ReA, ImA] [ReB;
    -ImB] and Im = [ReA, ImA] [ImB; ReB] over the k-concatenation
    (negation is exact). Parts are f64 numpy arrays (f32 values widened)."""
    if x_re is None:
        x_re, x_im = a_re, a_im
    oracle = {}
    for r0, c0 in [(0, 0), (N // 2, N - 256), (N - 256, N - 256)]:
        rows = np.hstack([a_re[r0:r0 + 256], a_im[r0:r0 + 256]])
        b_re = x_re[c0:c0 + 256].T
        b_im = x_im[c0:c0 + 256].T
        oracle[(r0, c0)] = (dd_gemm(rows, np.vstack([b_re, -b_im])),
                            dd_gemm(rows, np.vstack([b_im, b_re])))
    return oracle


def complex_call(A, B, strat, fastmode, oracle):
    """One complex main-path call with the launch counts reset just before
    it and read just after: (output, launches, gate relerr)."""
    want = COMPLEX_FAST_LAUNCHES if fastmode else COMPLEX_ACCURATE_LAUNCHES
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    c = gt.gemm(A, B, num_moduli=L_MAIN, fastmode=fastmode,
                compute_type=strat, device=DEVICE)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    mode = f"{strat.name} {'fast' if fastmode else 'accurate'}"
    log(f"  launches in the complex {N}^3 {mode} call: {launches}")
    assert launches == want, f"complex {mode} launch counts {launches}"
    assert c.shape == (N, N) and c.dtype == torch.complex128
    assert bool(torch.isfinite(torch.view_as_real(c)).all()), \
        "non-finite output"
    worst = complex_gate(c, oracle)
    assert worst < 1e-8, f"complex {mode} relerr {worst} >= 1e-8"
    return c, launches, worst


def phase_complex(launches):
    """Phase 4c: the complex main path at N^3, all strategies, both modes,
    and the kernel-vs-plain complex path at N_PLAIN^3."""
    a_re = phi_matrix(N, N, 0.5, seed=0)
    a_im = phi_matrix(N, N, 0.5, seed=1)
    oracle = complex_oracle(a_re, a_im)
    A = torch.complex(torch.from_numpy(a_re), torch.from_numpy(a_im)).to(
        DEVICE)
    B = A.t().contiguous()
    rels, fast_bits = {}, []
    for strat, fastmode in COMPLEX_CALLS:
        c, counts, rel = complex_call(A, B, strat, fastmode, oracle)
        for name, cnt in counts.items():
            key = KERNEL_OF.get(name, name)
            launches[key] = launches.get(key, 0) + cnt
        rels[(strat, fastmode)] = rel
        if fastmode:
            fast_bits.append(c)
        else:
            moved = (torch.view_as_real(c).view(torch.int64)
                     != torch.view_as_real(fast_bits[0]).view(torch.int64))
            log(f"  {strat.name} accurate vs fast: {int(moved.sum())} of "
                f"{moved.numel()} output words differ")
        del c
    for c in fast_bits[1:]:
        assert torch.equal(torch.view_as_real(c).view(torch.int64),
                           torch.view_as_real(fast_bits[0]).view(
                               torch.int64)), \
            "the fast complex strategies disagree in bits"
    del fast_bits
    log("  the three fast complex strategies give identical bits")
    for (strat, fastmode), rel in rels.items():
        log(f"  gate tiles max relerr vs complex dd oracle, {strat.name} "
            f"{'fast' if fastmode else 'accurate'}: {rel!r}")

    parts = [x[:N_PLAIN, :N_PLAIN].contiguous()
             for x in cg.canon_complex(A) + cg.canon_complex(B)]
    A2 = torch.complex(parts[0], parts[1])
    B2 = torch.complex(parts[2], parts[3])
    for fastmode in (True, False):
        for strat in (CT.COMPLEX_CLASSIC_MULT, CT.COMPLEX_KARATSUBA_MULT):
            kara = strat == CT.COMPLEX_KARATSUBA_MULT
            ck = gt.gemm(A2, B2, num_moduli=L_MAIN, fastmode=fastmode,
                         compute_type=strat, device=DEVICE)
            cp, pa, pb = plain_gemm_complex(parts, L_MAIN, fastmode, kara)
            if fastmode:
                sa = enc.joint_fast_sft(parts[0], parts[1], L_MAIN, 1,
                                        stats=hk.fast_stats)
                sb = enc.joint_fast_sft(parts[2], parts[3], L_MAIN, 0,
                                        stats=hk.fast_stats)
                if not (torch.equal(sa, pa) and torch.equal(sb, pb)):
                    check_joint_sft(sa, pa, parts[0], parts[1], 1, L_MAIN)
                    check_joint_sft(sb, pb, parts[2], parts[3], 0, L_MAIN)
                    cp, _, _ = plain_gemm_complex(parts, L_MAIN, True, kara,
                                                  (sa, sb))
            else:
                sa, sb = cg.accurate_sfts_complex(*parts, L_MAIN)
                assert torch.equal(sa, pa) and torch.equal(sb, pb), \
                    "complex accurate shifts: kernel path vs plain path"
            assert torch.equal(torch.view_as_real(ck).view(torch.int64),
                               torch.view_as_real(cp).view(torch.int64)), \
                f"{N_PLAIN}^3 complex {strat.name} kernel path vs plain"
            log(f"  {N_PLAIN}^3 complex {strat.name} "
                f"{'fast' if fastmode else 'accurate'} kernel path == "
                "all-plain path (bits)")
    return A, B, rels


def phase_complex_peaks(A, B):
    """Phase 4c (memory): every complex strategy, fast and accurate, on
    complex128 (A, B) and on complex64 (A, B rounded) at N^3, then on
    complex128 and complex64 operands of the ragged shape PEAK_RAGGED (its
    buffers not multiples of 512 bytes, k not of 16), L_MAIN moduli: the
    peak device memory above the operands against planner.workspace_bytes,
    which must be at or above each peak, and within PLANNER_SLACK of each
    complex128 peak (the planner counts 8-byte words, so it over-counts
    complex64 calls)."""
    m, k, n = PEAK_RAGGED
    ragged = [torch.from_numpy(phi_matrix(r, c, 0.5, seed=s)
                               + 1j * phi_matrix(r, c, 0.5, seed=s + 1))
              .to(DEVICE) for r, c, s in ((m, k, 40), (k, n, 42))]
    for x, y in ((A, B), ragged):
        x64, y64 = x.to(torch.complex64), y.to(torch.complex64)
        shape = (x.shape[0], x.shape[1], y.shape[1])
        for word, pair in (("complex128", (x, y)), ("complex64", (x64, y64))):
            for strat in (CT.COMPLEX_BIG_MATRIX_ENCODE,
                          CT.COMPLEX_CLASSIC_MULT, CT.COMPLEX_KARATSUBA_MULT):
                plan = planner.workspace_bytes(shape[0], shape[2], shape[1],
                                               L_MAIN, strat)
                for fastmode in (True, False):
                    name = (f"{'x'.join(map(str, shape))} {word} "
                            f"{strat.name} "
                            f"{'fast' if fastmode else 'accurate'}")
                    c, counts, peak = counted(lambda: gt.gemm(
                        *pair, num_moduli=L_MAIN, fastmode=fastmode,
                        compute_type=strat, device=DEVICE))
                    assert c.shape == (shape[0], shape[2]) and bool(
                        torch.isfinite(torch.view_as_real(c)).all()), name
                    del c
                    assert counts.get("matmul_complex_mod") == 1, name
                    if word == "complex128":
                        check_plan(name, peak, plan)
                    else:
                        assert peak <= plan, \
                            f"{name}: peak {peak} over the planner's {plan}"
                    log(f"  {name}: peak device memory above the operands "
                        f"{peak} bytes, planner {plan} ({peak / plan:.4f})")
        del x64, y64


def phase_variants(a, b, refs, oracle, A, launches):
    """Phase 4v: one N^3 call per variant, each with the launch counts
    reset just before it and read just after, held to the default call's
    bits (refs: fastmode -> output) and to the gate; then the complex
    accurate call at N_PLAIN^3 under GEMMUL8_MAGMAX_SCRATCH=1. Returns the
    gate relerr of each N^3 call."""
    rels = {}
    for name, fastmode, env, want in VARIANT_CALLS:
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        with switches(env):
            c = gt.gemm(a, b, num_moduli=L_MAIN, fastmode=fastmode,
                        device=DEVICE)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        log(f"  launches in the {N}^3 {name} call: {counts}")
        assert counts == want, f"{name} launch counts {counts}"
        assert torch.equal(bits64(c), bits64(refs[fastmode])), \
            f"{name}: not the default call's bits"
        rels[name] = gate(c, oracle)
        assert rels[name] < 1e-8, f"{name} relerr {rels[name]} >= 1e-8"
        log(f"  {N}^3 {name} == default call (bits), gate relerr "
            f"{rels[name]!r}")
        for kname, cnt in counts.items():
            if kname in VARIANT_KERNELS:
                launches[kname] = launches.get(kname, 0) + cnt
        del c
    A2 = A[:N_PLAIN, :N_PLAIN].contiguous()
    B2 = A2.t().contiguous()
    ref = gt.gemm(A2, B2, num_moduli=L_MAIN, fastmode=False, device=DEVICE)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    with switches({"GEMMUL8_MAGMAX_SCRATCH": "1"}):
        c = gt.gemm(A2, B2, num_moduli=L_MAIN, fastmode=False, device=DEVICE)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    want = dict(COMPLEX_ACCURATE_LAUNCHES)
    want["magmax_matmul_scratch"] = want.pop("magmax_matmul")
    assert counts == want, f"complex MAGMAX_SCRATCH launch counts {counts}"
    assert torch.equal(torch.view_as_real(c).view(torch.int64),
                       torch.view_as_real(ref).view(torch.int64)), \
        "complex accurate MAGMAX_SCRATCH: not the default call's bits"
    log(f"  {N_PLAIN}^3 complex accurate MAGMAX_SCRATCH == default call "
        f"(bits); launches {counts}")
    return rels


def counted(fn):
    """(fn(), launch counts, peak of device memory above what was allocated
    before): the counts reset just before the call and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    build.LAUNCHES.clear()
    c = fn()
    torch.cuda.synchronize()
    return (c, dict(build.LAUNCHES),
            torch.cuda.max_memory_allocated() - before)


def crt_path(a, b, L):
    """fast_sft -> encode_slices -> matmul_crt -> reconstruct from limbs:
    the path matmul_crt has in the JAX package (no switch reaches it)."""
    sa, sb = hk.fast_sft(a, L, 1), hk.fast_sft(b, L, 0)
    limbs = hm.matmul_crt(hk.encode_slices(a, sa, L, 1),
                          hk.encode_slices(b, sb, L, 0), L)
    return hk.reconstruct(limbs, sa, sb, L, input_kind="limbs")


def schedule_calls():
    """Phase 4s's N^3 calls: (name, fastmode, fn(a, b), launch counts,
    planner chunk or None)."""
    L = L_MAIN
    budget = planner.workspace_bytes(N, N, N, L, moduli_chunk=BUDGET_CHUNK)
    sched = planner.plan_schedule(N, N, N, L, budget)
    assert sched.chunk == BUDGET_CHUNK and sched.num_chunks > 1, sched

    def chunked(pre, nchunks):
        return {**pre, "encode_slices": 2 * nchunks,
                "matmul_mod_u8": nchunks, "reconstruct": 1}

    def gemm(fastmode, env=None, **kwargs):
        return lambda a, b: under(env or {}, lambda: gt.gemm(
            a, b, num_moduli=L, fastmode=fastmode, device=DEVICE, **kwargs))

    fast_pre = {"fast_sft": 2}
    accu_pre = {"emax": 2, "mag7": 2, "magmax_matmul": 1}
    n5 = planner.ModuliSchedule(L, CHUNK).num_chunks
    fused = {"GEMMUL8_FUSED_RECONSTRUCT": "1"}
    return [
        (f"fast moduli_chunk={CHUNK}", True, gemm(True, moduli_chunk=CHUNK),
         chunked(fast_pre, n5), CHUNK),
        (f"accurate moduli_chunk={CHUNK}", False,
         gemm(False, moduli_chunk=CHUNK), chunked(accu_pre, n5), CHUNK),
        (f"fast max_workspace_bytes={budget}", True,
         gemm(True, max_workspace_bytes=budget),
         chunked(fast_pre, sched.num_chunks), BUDGET_CHUNK),
        ("fast FUSED_RECONSTRUCT", True, gemm(True, fused),
         {**fast_pre, "encode_slices": 2, "matmul_reconstruct": 1}, None),
        ("accurate FUSED_RECONSTRUCT", False, gemm(False, fused),
         {**accu_pre, "encode_slices": 2, "matmul_reconstruct": 1}, None),
        ("fast matmul_crt path", True, lambda a, b: crt_path(a, b, L),
         {**fast_pre, "encode_slices": 2, "matmul_crt": 1, "reconstruct": 1},
         None),
    ]


def check_plan(name, peak, plan):
    """A measured peak at or under the planner's figure, within
    PLANNER_SLACK of it."""
    assert peak <= plan, f"{name}: peak {peak} over the planner's {plan}"
    assert peak >= (1 - PLANNER_SLACK) * plan, \
        f"{name}: peak {peak} more than {PLANNER_SLACK:.0%} under the " \
        f"planner's {plan}"


def phase_schedules(a, b, refs, oracle, launches):
    """Phase 4s: the chunked, fused-reconstruct and matmul_crt paths at N^3,
    each held to the default call's bits (refs: fastmode -> output), its
    launch counts and the gate; the chunked calls' peak memory against the
    one-shot call's and the planner's figure; then each path at N_PLAIN^3
    against the all-plain path. Returns the gate relerr of each N^3 call."""
    L = L_MAIN
    one_shot = {}
    for fastmode in (True, False):
        c, _, one_shot[fastmode] = counted(lambda: gt.gemm(
            a, b, num_moduli=L, fastmode=fastmode, device=DEVICE))
        assert torch.equal(bits64(c), bits64(refs[fastmode]))
        del c
    plan = planner.workspace_bytes(N, N, N, L)
    for fastmode in (True, False):
        check_plan(f"one-shot {'fast' if fastmode else 'accurate'}",
                   one_shot[fastmode], plan)
    log(f"  one-shot {N}^3 calls: peak device memory above the operands "
        f"fast {one_shot[True]} bytes, accurate {one_shot[False]}; planner "
        f"{plan}")
    # a ragged k: the GEMM holds A's slices padded to kp beside them (C11)
    m, k, n = PEAK_RAGGED
    ar, br = operands(m, k, n, 21, False)
    for chunk in (None, CHUNK):
        kw = {} if chunk is None else {"moduli_chunk": chunk}
        _, _, peak = counted(lambda: gt.gemm(ar, br, num_moduli=L,
                                             device=DEVICE, **kw))
        plan = planner.workspace_bytes(m, n, k, L, moduli_chunk=chunk)
        name = (f"{m} x {k} x {n} fast "
                f"{'one-shot' if chunk is None else f'moduli_chunk={chunk}'}")
        check_plan(name, peak, plan)
        log(f"  {name}: peak device memory above the operands {peak} bytes, "
            f"planner {plan} ({peak / plan:.4f} of it)")
    del ar, br
    rels = {}
    for name, fastmode, fn, want, chunk in schedule_calls():
        c, counts, peak = counted(lambda: fn(a, b))
        log(f"  launches in the {N}^3 {name} call: {counts}")
        assert counts == want, f"{name} launch counts {counts}"
        assert torch.equal(bits64(c), bits64(refs[fastmode])), \
            f"{name}: not the default call's bits"
        rels[name] = gate(c, oracle)
        assert rels[name] < 1e-8, f"{name} relerr {rels[name]} >= 1e-8"
        del c
        line = (f"  {N}^3 {name} == default call (bits), gate relerr "
                f"{rels[name]!r}, peak {peak} bytes")
        if "FUSED_RECONSTRUCT" in name:
            line += (f" (one-shot {one_shot[fastmode]}: "
                     f"{peak / one_shot[fastmode]:.4f} of it)")
        if chunk is not None:
            plan = planner.workspace_bytes(N, N, N, L, moduli_chunk=chunk)
            assert peak < one_shot[fastmode], \
                f"{name}: peak {peak} not below the one-shot call's"
            check_plan(name, peak, plan)
            line += (f" (one-shot {one_shot[fastmode]}, planner at chunk "
                     f"{chunk}: {plan})")
        log(line)
        for kname in SCHEDULE_KERNELS:
            launches[kname] = launches.get(kname, 0) + counts.get(kname, 0)
    # N_PLAIN^3: every path against the all-plain path on the same shifts
    a2 = a[:N_PLAIN, :N_PLAIN].contiguous()
    b2 = b[:N_PLAIN, :N_PLAIN].contiguous()
    plain = {True: plain_gemm(a2, b2, L, (hk.fast_sft(a2, L, 1),
                                          hk.fast_sft(b2, L, 0)))[0],
             False: plain_gemm(a2, b2, L, tg.accurate_sfts(a2, b2, L))[0]}
    for name, fastmode, fn, _, _ in schedule_calls():
        if "max_workspace_bytes" in name:   # the budget is N^3's
            continue
        assert_bits_equal(fn(a2, b2), plain[fastmode],
                          f"{N_PLAIN}^3 {name} vs plain path")
        log(f"  {N_PLAIN}^3 {name} == all-plain path (bits)")
    return rels


def timed(fn, reps):
    """(ms per call, the warm-up call's output)."""
    first = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, first


def phase_times(a, b, errs):
    """Phase 5: ms per main-path use of each kernel (both operands where
    the path runs it twice) beside its plain version, and the whole call.
    The warm-up outputs of kernel and plain version are compared, so each
    kernel is also checked at the main path's shapes."""
    L = L_MAIN
    sa = hk.fast_sft(a, L, 1)
    sb = hk.fast_sft(b, L, 0)
    a8 = hk.encode_slices(a, sa, L, 1)
    b8 = hk.encode_slices(b, sb, L, 0)
    r8 = hm.matmul_mod_u8(a8, b8, L, centered=True)
    ea, eb = hk.emax(a, 1), hk.emax(b, 0)
    ma, mb = hk.mag7(a, ea, 1), hk.mag7(b, eb, 0)
    pairs = {
        "fast_sft": (lambda: (hk.fast_sft(a, L, 1), hk.fast_sft(b, L, 0)),
                     lambda: (hk.fast_sft_plain(a, L, 1),
                              hk.fast_sft_plain(b, L, 0))),
        "encode_slices": (
            lambda: (hk.encode_slices(a, sa, L, 1),
                     hk.encode_slices(b, sb, L, 0)),
            lambda: (hk.encode_slices_plain(a, sa, L, 1),
                     hk.encode_slices_plain(b, sb, L, 0))),
        "matmul_mod_u8": (
            lambda: hm.matmul_mod_u8(a8, b8, L, centered=True),
            lambda: hm.matmul_mod_u8_plain(a8, b8, L, centered=True)),
        "reconstruct": (lambda: hk.reconstruct(r8, sa, sb, L),
                        lambda: hk.reconstruct_plain(r8, sa, sb, L)),
        "emax": (lambda: (hk.emax(a, 1), hk.emax(b, 0)),
                 lambda: (hk.emax_plain(a, 1), hk.emax_plain(b, 0))),
        "mag7": (lambda: (hk.mag7(a, ea, 1), hk.mag7(b, eb, 0)),
                 lambda: (hk.mag7_plain(a, ea, 1), hk.mag7_plain(b, eb, 0))),
        "magmax_matmul": (lambda: hm.magmax_matmul(ma, mb),
                          lambda: hm.magmax_plain(ma, mb)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        ms, got = timed(kern, 5)
        pms, ref = timed(plain, 2)
        times[name] = (ms, pms)
        if name == "fast_sft":
            errs[name] = max(errs[name], check_sft(got[0], ref[0], a, 1, L),
                             check_sft(got[1], ref[1], b, 0, L))
        else:
            hold(errs, name, got, ref, f"{name} at {N}^2, {L} moduli")
        log(f"  {name} == plain at the main path's shapes ({N}^2, {L} "
            "moduli)")
        del got, ref
    for line in sft_half_lines("fast_sft", lambda x, ax: hk.fast_sft(x, L, ax),
                               (a,), (b,)):
        log(line)
    # the library's int8 GEMM on the same slices, without the mod epilogue:
    # L calls of torch._int_mm (the port never calls it)
    lib = {}
    b8t = b8.transpose(1, 2).contiguous()   # column-major B, untimed
    by, _ = timed_rounds({
        "matmul_mod_u8": lambda: hm.matmul_mod_u8(a8, b8, L, centered=True),
        "int_mm": lambda: [torch._int_mm(a8[l], b8t[l].t())
                           for l in range(L)]}, PROBE_ROUNDS, 2)
    lib["matmul_mod_u8"] = float(np.median(by["int_mm"]))
    mod_ms = float(np.median(by["matmul_mod_u8"]))
    bound_ms = 2 * L * N ** 3 / INT8_OPS_PER_S * 1e3
    log(f"  torch._int_mm x {L} on the same slices (the product without "
        f"the mod epilogue; B column-major): median {lib['matmul_mod_u8']:.3f}"
        f" ms (rounds {', '.join(f'{t:.3f}' for t in by['int_mm'])}) beside "
        f"matmul_mod_u8 {mod_ms:.3f} ms (rounds "
        f"{', '.join(f'{t:.3f}' for t in by['matmul_mod_u8'])}) in the same "
        f"rotation: matmul_mod_u8 / library "
        f"{mod_ms / lib['matmul_mod_u8']:.3f}; share of the {bound_ms:.3f} "
        f"ms bound (int8 ops) matmul_mod_u8 {bound_ms / mod_ms:.3f}, library "
        f"{bound_ms / lib['matmul_mod_u8']:.3f} ({hl.get('matmul_mod')})")
    del b8t
    total, _ = timed(lambda: gt.gemm(a, b, num_moduli=L, device=DEVICE), 3)
    total_accu, _ = timed(lambda: gt.gemm(a, b, num_moduli=L, fastmode=False,
                                          device=DEVICE), 3)
    return times, total, total_accu, lib


def gate_lines(s, axis):
    """The entries of a shift vector that the gate tiles' rows (axis 1) or
    columns (axis 0) use."""
    s = s.flatten()
    starts = (0, N // 2, N - 256) if axis == 1 else (0, N - 256)
    return torch.cat([s[i:i + 256] for i in starts])


def shifts_moved(fast, accurate, axis):
    """How many of the shifts accurate mode moves from fast mode's, in all
    and on the gate tiles' lines, and the range of the moves."""
    d = (accurate.long() - fast.long()).flatten()
    g = gate_lines(accurate, axis).long() - gate_lines(fast, axis).long()
    return (f"{int((d != 0).sum())} of {d.numel()} moved (by "
            f"{int(d.min())}..{int(d.max())}), {int((g != 0).sum())} of "
            f"{g.numel()} on the gate tiles' lines")


# the label of the library call timed in a kernel's rotation: one
# torch._int_mm per int8 product the kernel forms, without its epilogue
LIBRARY = "torch._int_mm, the same products"


def int_mm(a8, b8t, pairs=None):
    """A call of torch._int_mm for each int8 product: a8[l] (rows, k) times
    b8t[l] (cols, k, so column-major B) transposed, for every slice l, or
    for the (A, B) slice pairs given (the complex GEMM's four or three
    products a modulus). The port never calls it."""
    if pairs is None:
        return lambda: [torch._int_mm(x, y.t()) for x, y in zip(a8, b8t)]
    return lambda: [torch._int_mm(x[l], y[l].t()) for x, y in pairs
                    for l in range(x.shape[0])]


def timed_rounds(calls, rounds, reps, head_start=False):
    """ms per call of each entry of calls (name -> fn), over rounds in
    which the order rotates by one, so each call takes each place; no
    output is kept between timings. head_start: each timing's calls are
    enqueued behind HEAD_START_CYCLES of torch.cuda._sleep, so that the
    host's launches run ahead of the card. Returns (name -> list of ms,
    place -> list of ms)."""
    names = list(calls)
    for name in names:                     # warm-up
        calls[name]()
    torch.cuda.synchronize()
    by_name = {name: [] for name in names}
    by_place = {i: [] for i in range(len(names))}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for r in range(rounds):
        shift = r % len(names)
        for place, name in enumerate(names[shift:] + names[:shift]):
            if head_start:
                torch.cuda._sleep(HEAD_START_CYCLES)
            start.record()
            for _ in range(reps):
                calls[name]()
            stop.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(stop) / reps
            by_name[name].append(ms)
            by_place[place].append(ms)
    return by_name, by_place


def phase_complex_times(A, B, errs):
    """Phase 5c: at the main path's shapes (N^2, 14 moduli), fast_stats on
    each part and the joint shifts, and the complex magnitudes, held to
    their plain versions (stats and shifts under the floor-boundary rule,
    magnitudes bit for bit) and timed beside them; how many shifts accurate
    mode moves from fast mode's; ms of the Karatsuba sum slices and of
    matmul_complex_mod (4-dot and Karatsuba) beside its plain version, held
    bit for bit on the warm-up outputs; and each complex N^3 call over
    COMPLEX_ROUNDS rounds in rotated order."""
    L = L_MAIN
    a_re, a_im = cg.canon_complex(A)
    b_re, b_im = cg.canon_complex(B)
    parts = ((a_re, 1), (a_im, 1), (b_re, 0), (b_im, 0))
    times = {}
    for x, axis in parts:
        check_stats(errs, x, axis, L)
    times["fast_stats"] = (
        timed(lambda: [hk.fast_stats(x, ax) for x, ax in parts], 5)[0],
        timed(lambda: [hk.fast_stats_plain(x, ax) for x, ax in parts], 2)[0])
    sa = enc.joint_fast_sft(a_re, a_im, L, 1, stats=hk.fast_stats)
    sb = enc.joint_fast_sft(b_re, b_im, L, 0, stats=hk.fast_stats)
    errs["fast_sft"] = max(
        errs["fast_sft"],
        check_joint_sft(sa, enc.joint_fast_sft(a_re, a_im, L, 1),
                        a_re, a_im, 1, L),
        check_joint_sft(sb, enc.joint_fast_sft(b_re, b_im, L, 0),
                        b_re, b_im, 0, L))
    log(f"  fast_stats and the joint shifts == plain at the main path's "
        f"shapes ({N}^2, Re and Im, rows and columns)")
    for line in sft_half_lines("fast_stats", hk.fast_stats, (a_re, a_im),
                               (b_re, b_im)):
        log(line)
    ms, got = timed(lambda: (hk.mag7_operand_complex(a_re, a_im, 1),
                             hk.mag7_operand_complex(b_re, b_im, 0)), 5)
    pms, ref = timed(lambda: (mag7_complex_plain(a_re, a_im, 1),
                              mag7_complex_plain(b_re, b_im, 0)), 2)
    hold(errs, "mag7", got[0] + got[1], ref[0] + ref[1],
         f"complex magnitudes at {N}^2")
    times["complex magnitudes"] = (ms, pms)
    log(f"  mag7_operand_complex == plain at the main path's shapes ({N}^2, "
        "shift 4, rows and columns)")
    del got, ref
    acc_a, acc_b = cg.accurate_sfts_complex(a_re, a_im, b_re, b_im, L)
    log(f"  accurate vs fast shifts at {N}^3: A rows "
        f"{shifts_moved(sa, acc_a, 1)}; B columns "
        f"{shifts_moved(sb, acc_b, 0)}")
    a8 = [hk.encode_slices(x, sa, L, 1) for x in (a_re, a_im)]
    b8 = [hk.encode_slices(x, sb, L, 0) for x in (b_re, b_im)]
    del a_re, a_im, b_re, b_im, parts
    ms, kara = timed(lambda: (sg.recenter_add_int8(*a8, L),
                              sg.recenter_add_int8(*b8, L)), 3)
    times["recenter_add_int8"] = (ms, None)
    for form, ks in (("4-dot", None), ("Karatsuba", kara)):
        ms, got = timed(lambda: hm.matmul_complex_mod(*a8, *b8, L, True, ks),
                        3)
        pms, ref = timed(
            lambda: hm.matmul_complex_mod_plain(*a8, *b8, L, True, ks), 1)
        hold(errs, "matmul_complex_mod", got, ref,
             f"matmul_complex_mod {form} at {N}^2, {L} moduli")
        times[form] = (ms, pms)
        del got, ref
    log(f"  matmul_complex_mod == plain at the main path's shapes ({N}^2, "
        f"{L} moduli, both forms)")
    bt = [x.transpose(1, 2).contiguous() for x in b8]   # untimed
    by, _ = timed_rounds({
        "4-dot": lambda: hm.matmul_complex_mod(*a8, *b8, L, True, None),
        "4-dot " + LIBRARY: int_mm(None, None, [
            (a8[0], bt[0]), (a8[1], bt[1]), (a8[0], bt[1]), (a8[1], bt[0])]),
        "Karatsuba": lambda: hm.matmul_complex_mod(*a8, *b8, L, True, kara),
        "Karatsuba " + LIBRARY: int_mm(None, None, [
            (a8[0], bt[0]), (a8[1], bt[1]), (a8[0], bt[1])]),
    }, PROBE_ROUNDS, 1)
    times["library"] = {label: float(np.median(v)) for label, v in by.items()}
    del a8, b8, kara, bt
    calls, by_place = timed_rounds(
        {(strat, fastmode): (
            lambda s=strat, f=fastmode: gt.gemm(A, B, num_moduli=L,
                                                fastmode=f, compute_type=s,
                                                device=DEVICE))
         for strat, fastmode in COMPLEX_CALLS}, COMPLEX_ROUNDS, 2)
    return times, calls, by_place


def under(env, fn):
    """fn() with the switches env set, restored after (the call only
    enqueues its kernels, but reads the switches while it does)."""
    with switches(env):
        return fn()


def fused_encode_calls(a, b, L):
    """fast_encode_fused on both operands and on each half, beside
    fast_sft + encode_slices on the same (phase 5v's rotation)."""

    def sft_encode(x, axis):
        return hk.encode_slices(x, hk.fast_sft(x, L, axis), L, axis)

    return {
        "fast_encode_fused": lambda: (hk.fast_encode_fused(a, L, 1),
                                      hk.fast_encode_fused(b, L, 0)),
        "fast_sft + encode_slices": lambda: (sft_encode(a, 1),
                                             sft_encode(b, 0)),
        "fast_encode_fused A rows": lambda: hk.fast_encode_fused(a, L, 1),
        "fast_sft + encode_slices A rows": lambda: sft_encode(a, 1),
        "fast_encode_fused B columns": lambda: hk.fast_encode_fused(b, L, 0),
        "fast_sft + encode_slices B columns": lambda: sft_encode(b, 0)}


def phase_variant_times(a, b, errs):
    """Phase 5v: at the main path's shapes (N^2 operands, 14 moduli), each
    variant kernel beside the default kernels it replaces, VARIANT_ROUNDS
    rounds in rotated order, and its plain version, the warm-up outputs held
    bit for bit (fast_encode_fused's shifts: equal to fast_sft's kernel,
    under the floor rule against the plain version); then each variant call
    at N^3 against the default call of its mode, VARIANT_ROUNDS rounds in
    rotated order. Returns ({kernel: ({label: [ms]}, plain ms, the SM
    clock and power draw during its rotation)}, {call: [ms]})."""
    L = L_MAIN
    sa, sb = hk.fast_sft(a, L, 1), hk.fast_sft(b, L, 0)
    a8, b8 = hk.encode_slices(a, sa, L, 1), hk.encode_slices(b, sb, L, 0)
    b8t = b8.transpose(1, 2).contiguous()   # column-major B, untimed
    ma, _ = hk.mag7_fused(a, 1)
    mb, _ = hk.mag7_fused(b, 0)          # (k, n), column-major

    def emax_mag7(x, axis):
        e = hk.emax(x, axis)
        return hk.mag7(x, e, axis), e

    groups = {
        "fast_encode_fused": (
            fused_encode_calls(a, b, L),
            lambda: (hk.fast_encode_fused_plain(a, L, 1),
                     hk.fast_encode_fused_plain(b, L, 0))),
        "mag7_fused": (
            {"mag7_fused": lambda: (hk.mag7_fused(a, 1), hk.mag7_fused(b, 0)),
             "emax + mag7": lambda: (emax_mag7(a, 1), emax_mag7(b, 0)),
             "mag7_fused A rows": lambda: hk.mag7_fused(a, 1),
             "emax + mag7 A rows": lambda: emax_mag7(a, 1),
             "mag7_fused B columns": lambda: hk.mag7_fused(b, 0),
             "emax + mag7 B columns": lambda: emax_mag7(b, 0)},
            lambda: (hk.mag7_fused_plain(a, 1), hk.mag7_fused_plain(b, 0))),
        "magmax_matmul_scratch": (
            {"magmax_matmul_scratch": lambda: hm.magmax_matmul_scratch(ma, mb),
             "magmax_matmul": lambda: hm.magmax_matmul(ma, mb),
             LIBRARY: lambda: torch._int_mm(ma, mb)},
            lambda: hm.magmax_scratch_plain(ma, mb)),
        "matmul_mod_u8_pipelined": (
            {"matmul_mod_u8_pipelined":
                 lambda: hm.matmul_mod_u8_pipelined(a8, b8, L),
             "matmul_mod_u8 (uncentered)":
                 lambda: hm.matmul_mod_u8(a8, b8, L, centered=False),
             LIBRARY: int_mm(a8, b8t)},
            lambda: hm.matmul_mod_u8_pipelined_plain(a8, b8, L)),
    }
    times = {}
    for name, (kerns, plain) in groups.items():
        got = kerns[name]()
        pms, ref = timed(plain, 1)
        if name == "fast_encode_fused":
            for (sl, sft), (psl, psft), x, axis in zip(got, ref, (a, b),
                                                       (1, 0)):
                assert torch.equal(sft, sa if axis == 1 else sb)
                errs[name] = max(errs[name], check_sft(sft, psft, x, axis, L))
                if torch.equal(sft, psft):
                    hold(errs, name, sl, psl, f"{name} at {N}^2, {L} moduli")
        elif name == "mag7_fused":
            for x, y in zip(got, ref):
                hold(errs, name, x, y, f"{name} at {N}^2")
        else:
            hold(errs, name, got, ref, f"{name} at {N}^2, {L} moduli")
        del got, ref
        log(f"  {name} == plain at the main path's shapes ({N}^2, {L} "
            "moduli)")
        with ClockSampler() as clock:
            by_name, _ = timed_rounds(kerns, VARIANT_ROUNDS, 5)
        times[name] = (by_name, pms, clock.summary())
    del a8, b8, b8t, ma, mb
    calls = {"fast default": (True, {}), "accurate default": (False, {})}
    for name, fastmode, env, _ in VARIANT_CALLS:
        calls[name] = (fastmode, env)
    by_name, _ = timed_rounds(
        {name: (lambda f=f, env=env: under(env, lambda: gt.gemm(
            a, b, num_moduli=L, fastmode=f, device=DEVICE)))
         for name, (f, env) in calls.items()}, VARIANT_ROUNDS, 2)
    return times, by_name


def phase_schedule_times(a, b, errs):
    """Phase 5s: at the main path's shapes (N^2 operands, 14 moduli), the
    two CRT-fused GEMMs and limb-input reconstruct beside matmul_mod_u8 and
    reconstruct, SCHEDULE_ROUNDS rounds in rotated order, and beside their
    plain versions, the warm-up outputs held bit for bit; encode_slices on
    13 moduli in its three forms; the chunk fold; then the chunked and
    FUSED_RECONSTRUCT calls at N^3 beside the default call of their mode.
    Returns ({label: [ms]}, {name: plain ms}, {call: [ms]}, the SM clock
    and power draw during the kernels' rotation)."""
    L = L_MAIN
    sa, sb = hk.fast_sft(a, L, 1), hk.fast_sft(b, L, 0)
    a8, b8 = hk.encode_slices(a, sa, L, 1), hk.encode_slices(b, sb, L, 0)
    r8 = hm.matmul_mod_u8(a8, b8, L, centered=True)
    limbs = hm.matmul_crt(a8, b8, L)
    b8t = b8.transpose(1, 2).contiguous()   # column-major B, untimed
    plain_ms = {}
    for name, got, plain in (
            ("matmul_crt", limbs, lambda: hm.matmul_crt_plain(a8, b8, L)),
            ("matmul_reconstruct", hm.matmul_reconstruct(a8, b8, sa, sb, L),
             lambda: hm.matmul_reconstruct_plain(a8, b8, sa, sb, L)),
            ("reconstruct (limbs)",
             hk.reconstruct(limbs, sa, sb, L, input_kind="limbs"),
             lambda: hk.reconstruct_plain(limbs, sa, sb, L, "f64", 0,
                                          "limbs"))):
        plain_ms[name], ref = timed(plain, 1)
        hold(errs, name.split()[0], got, ref, f"{name} at {N}^2, {L} moduli")
        log(f"  {name} == plain at the main path's shapes ({N}^2, {L} "
            "moduli)")
        del got, ref
    with ClockSampler() as clock:
        kerns, _ = timed_rounds({
            "matmul_crt": lambda: hm.matmul_crt(a8, b8, L),
            "matmul_reconstruct": lambda: hm.matmul_reconstruct(
                a8, b8, sa, sb, L),
            "matmul_mod_u8": lambda: hm.matmul_mod_u8(a8, b8, L,
                                                      centered=True),
            "reconstruct (limbs)": lambda: hk.reconstruct(
                limbs, sa, sb, L, input_kind="limbs"),
            "reconstruct": lambda: hk.reconstruct(r8, sa, sb, L),
            LIBRARY: int_mm(a8, b8t),
        }, SCHEDULE_ROUNDS, 3)
    del limbs, r8
    # the fused kernel against the pair it replaces and the library call,
    # resolved finer
    pair, _ = timed_rounds({
        "matmul_reconstruct, 10 rounds":
            lambda: hm.matmul_reconstruct(a8, b8, sa, sb, L),
        "matmul_mod_u8 + reconstruct, 10 rounds": lambda: hk.reconstruct(
            hm.matmul_mod_u8(a8, b8, L, centered=True), sa, sb, L),
        f"{LIBRARY}, 10 rounds": int_mm(a8, b8t),
    }, 10, 2)
    kerns.update(pair)
    del b8t
    ru = hm.matmul_mod_u8(a8, b8, L, centered=False)
    del a8, b8
    acc = torch.zeros((tables.num_limbs(L), N, N), dtype=torch.int32,
                      device=DEVICE)
    kerns["chunk fold (14 moduli, torch ops)"] = [timed(
        lambda: rec.fold_chunk_(acc.zero_(), ru, L, tuple(range(L))), 2)[0]]
    del acc, ru

    def encode(idx):
        return lambda: (hk.encode_slices(a, sa, L, 1, moduli_idx=idx),
                        hk.encode_slices(b, sb, L, 0, moduli_idx=idx))

    forms, _ = timed_rounds({
        "encode_slices moduli 0..12 (first moduli)": encode(tuple(range(13))),
        "encode_slices moduli 1..13 (a range)": encode(tuple(range(1, 14))),
        "encode_slices moduli 13, 0..11 (slots)":
            encode((13,) + tuple(range(12))),
    }, SCHEDULE_ROUNDS, 5)
    kerns.update(forms)
    fused = {"GEMMUL8_FUSED_RECONSTRUCT": "1"}
    calls = {"fast default": (True, {}, {}),
             f"fast moduli_chunk={CHUNK}": (True, {}, {"moduli_chunk": CHUNK}),
             "fast moduli_chunk=1": (True, {}, {"moduli_chunk": 1}),
             "fast FUSED_RECONSTRUCT": (True, fused, {}),
             "accurate default": (False, {}, {}),
             f"accurate moduli_chunk={CHUNK}": (False, {},
                                                {"moduli_chunk": CHUNK}),
             "accurate FUSED_RECONSTRUCT": (False, fused, {})}
    by_name, _ = timed_rounds(
        {name: (lambda f=f, env=env, kw=kw: under(env, lambda: gt.gemm(
            a, b, num_moduli=L, fastmode=f, device=DEVICE, **kw)))
         for name, (f, env, kw) in calls.items()}, SCHEDULE_ROUNDS, 2)
    return kerns, plain_ms, by_name, clock.summary()


def hold_all(errs, name, got, ref, what):
    """Every output of a kernel call and of its plain version bit-equal
    (None where the other is None)."""
    for x, y in zip(got, ref):
        assert (x is None) == (y is None), f"{what}: outputs differ in kind"
        if x is not None:
            hold(errs, name, x, y, what)


def phase_pipeline_kernels(errs):
    """Phase 3p: the pipeline's kernels vs their plain versions."""
    for (m, k, n), Ls, pm in PIPELINE_CASES:
        a, b = operands(m, k, n, 9, False)
        for L in Ls:
            tag = f"m={m} k={k} n={n} L={L} panel_m={pm}"
            sa = hk.fast_sft_plain(a, L, axis=1)
            sb = hk.fast_sft_plain(b, L, axis=0)
            a8 = hk.encode_slices(a, sa, L, axis=1)
            b8 = hk.encode_slices(b, sb, L, axis=0)
            bt = torch.empty((L, n, k), dtype=torch.int8, device=DEVICE)
            r0, _, _ = hp.matmul_rider_step(a8, bt, 0, None, -1, sa, sb, L,
                                            pm, b8=b8)
            assert torch.equal(bt, riders.kmajor(b8)), f"{tag}: B copy"
            pbt = torch.empty_like(bt)
            hold_all(errs, "matmul_rider_step", (r0,),
                     hp.matmul_rider_step_plain(a8, pbt, 0, None, -1, sa, sb,
                                                L, pm, b8=b8)[:1],
                     f"rider step, first {tag}")
            last = m // pm - 1
            for rec_on, enc_on in ((False, False), (True, False),
                                   (False, True), (True, True)):
                out = torch.zeros((m, n), dtype=torch.float64, device=DEVICE)
                a8p = riders.panel_rows(a8, 1, pm).contiguous()
                args = (bt, 1, r0 if rec_on else None, 0, sa, sb, L, pm)
                kw = dict(a_src=a if enc_on else None,
                          next_panel=min(2, last), out=out)
                for slices in (a8, a8p):
                    got = hp.matmul_rider_step(slices, *args, **kw)
                    ref = hp.matmul_rider_step_plain(
                        slices, *args, **{**kw, "out": out.clone()})
                    hold_all(errs, "matmul_rider_step", got, ref,
                             f"rider step rec={rec_on} enc={enc_on} "
                             f"{'all of A' if slices is a8 else 'panel'} "
                             f"{tag}")
                # without out=: the previous panel's rows as a tensor
                hold_all(errs, "matmul_rider_step",
                         hp.matmul_rider_step(a8p, *args, a_src=kw["a_src"],
                                              next_panel=kw["next_panel"]),
                         hp.matmul_rider_step_plain(
                             a8p, *args, a_src=kw["a_src"],
                             next_panel=kw["next_panel"]),
                         f"rider step pieces rec={rec_on} enc={enc_on} {tag}")
            # the pair: B's left half encoded, its right half by the rider
            tiles = (0, max(n // 2 // 512, 1))
            b8l = hk.encode_slices(b, sb, L, 0, col_tiles=tiles)
            h = min(tiles[1] * 512, n)
            assert torch.equal(b8l[:, :, :h], b8[:, :, :h]), \
                f"encode_slices col_tiles {tag}"
            if h == n // 2:
                for src in (None, a):
                    a8_0 = riders.panel_rows(a8, 0, pm).contiguous()
                    got = hp.matmul_bsplit_pair(a8_0, b8l, b, sa, sb, L, pm,
                                                a_src=src)
                    hold_all(errs, "matmul_bsplit_pair", got,
                             hp.matmul_bsplit_pair_plain(
                                 a8_0, b8l, b, sa, sb, L, pm, a_src=src),
                             f"bsplit pair a_src={src is not None} {tag}")
                    assert torch.equal(got[1], bt), f"{tag}: pair's B"
            # the last panel's reconstruct into rows of the output, and
            # reconstruct(out=)
            out = torch.zeros((m, n), dtype=torch.float64, device=DEVICE)
            hp.reconstruct_into(r0, sa, sb, L, out, last, pm)
            rows = riders.panel_rows(out, last, pm)
            ref = torch.zeros_like(out)
            hp.reconstruct_into_plain(r0, sa, sb, L, ref, last, pm)
            hold(errs, "reconstruct_into", out, ref, f"reconstruct_into {tag}")
            assert not out[:last * pm].any(), f"{tag}: rows of no panel"
            into = torch.zeros((pm + 8, n), dtype=torch.float64,
                               device=DEVICE)
            hk.reconstruct(r0, riders.panel_rows(sa, last, pm), sb, L,
                           out=into[8:])
            hold(errs, "reconstruct", into[8:], rows,
                 f"reconstruct(out=) {tag}")
        log(f"  pipeline kernels == plain at m={m} k={k} n={n} L={Ls} "
            f"panel_m={pm}")
    # col_tiles on a ragged width, along rows and columns
    a, b = operands(1000, 777, 1500, 7, True)
    for x, axis in ((a, 1), (b, 0)):
        sft = hk.fast_sft_plain(x, L_MAIN, axis)
        for tiles in ((0, 1), (1, 2), (2, 3), (0, 3)):
            if tiles[0] * enc.ENC_BLOCK[1] >= x.shape[1]:
                continue
            got = hk.encode_slices(x, sft, L_MAIN, axis, col_tiles=tiles)
            c0, c1 = enc.col_range(tiles, x.shape[1])
            ref = hk.encode_slices_plain(x, sft, L_MAIN, axis,
                                         col_tiles=tiles)
            hold(errs, "encode_slices", got[:, :, c0:c1], ref[:, :, c0:c1],
                 f"encode_slices col_tiles={tiles} axis={axis}")
    log("  encode_slices(col_tiles=) == plain at 1000 x 777 x 1500")


def phase_golden():
    """Phase 3g: the golden file's entries with the kernels: the JAX
    package's shifts and output digests."""
    specs, arrays = golden.load(GOLDEN)
    for name, spec in specs.items():
        sa, sb, digest = golden.port_entry(spec, DEVICE)
        assert np.array_equal(sa, arrays[f"{name}.sft_a"]) and \
            np.array_equal(sb, arrays[f"{name}.sft_b"]), \
            f"golden {name}: shifts differ from the JAX package's"
        assert digest == str(arrays[f"{name}.digest"]), \
            f"golden {name}: output bits differ from the JAX package's"
    log(f"  {len(specs)} golden entries (JAX package, CPU) == kernels on "
        f"the card: {', '.join(specs)}")


def pipeline_calls():
    """Phase 4p's N^3 calls: (name, fastmode, GEMMUL8_PIPELINE, launch
    counts)."""
    panels = N // PANEL_M
    pre = {True: {"fast_sft": 2},
           False: {"emax": 2, "mag7": 2, "magmax_matmul": 1}}
    steps = {"encode_slices": 2, "matmul_rider_step": panels,
             "reconstruct_into": 1}
    split = {"encode_slices": 2, "matmul_bsplit_pair": 2,
             "matmul_rider_step": panels - 1, "reconstruct_into": 1}
    return [(f"{'fast' if f else 'accurate'} PIPELINE={pipe}", f, pipe,
             {**pre[f], **(split if pipe == "3" else steps)})
            for f, pipe in ((True, "1"), (True, "2"), (True, "3"),
                            (False, "1"), (False, "3"))]


def panel_calls(n_wide):
    """The column-panel calls on a (N, n_wide) B: (name, GEMMUL8_PIPELINE,
    launch counts)."""
    cols = n_wide // N_PANEL
    both = {"fast_sft": 1 + cols, "encode_slices": 1 + cols}
    return [(f"n_panel={N_PANEL}", "0",
             {**both, "matmul_mod_u8": cols, "reconstruct": cols}),
            (f"n_panel={N_PANEL} PIPELINE=1", "1",
             {**both, "matmul_rider_step": cols * (N // PANEL_M),
              "reconstruct_into": cols})]


def pipe_gemm(a, b, fastmode, pipe, **kwargs):
    return under({"GEMMUL8_PIPELINE": pipe}, lambda: gt.gemm(
        a, b, num_moduli=L_MAIN, fastmode=fastmode, device=DEVICE, **kwargs))


def phase_pipeline(a, b, refs, oracle, launches):
    """Phase 4p: the pipelined calls at N^3 and the column-panel calls on an
    N x N_WIDE B, each held to the one-shot call's bits, its launch counts
    and the gate, its peak memory logged beside the one-shot call's; then
    each at N_PLAIN^3 against the all-plain path. Returns (gate relerr of
    each call, the wide B, the one-shot call's peak memory by name)."""
    L = L_MAIN
    assert pl.choose_panels(N, N, N, L) == (PANEL_M, 512)
    assert pl.choose_panels(N, N, N, L, True) == (PANEL_M, 512)
    assert pl.bsplit_applicable(N, N, N, L, PANEL_M, 512)
    assert pl.choose_panels(N, N_PANEL, N, L) == (PANEL_M, 512)
    one_shot, rels = {}, {}
    for fastmode in (True, False):
        c, _, one_shot[fastmode] = counted(lambda: gt.gemm(
            a, b, num_moduli=L, fastmode=fastmode, device=DEVICE))
        assert torch.equal(bits64(c), bits64(refs[fastmode]))
        del c
    for name, fastmode, pipe, want in pipeline_calls():
        c, counts, peak = counted(lambda: pipe_gemm(a, b, fastmode, pipe))
        log(f"  launches in the {N}^3 {name} call: {counts}")
        assert counts == want, f"{name} launch counts {counts}"
        assert torch.equal(bits64(c), bits64(refs[fastmode])), \
            f"{name}: not the one-shot call's bits"
        rels[name] = gate(c, oracle)
        assert rels[name] < 1e-8, f"{name} relerr {rels[name]} >= 1e-8"
        del c
        log(f"  {N}^3 {name} == one-shot call (bits), gate relerr "
            f"{rels[name]!r}, peak {peak} bytes (one-shot "
            f"{one_shot[fastmode]})")
        for kname in PIPELINE_KERNELS:
            launches[kname] = launches.get(kname, 0) + counts.get(kname, 0)
    # N x N_WIDE in column panels of N_PANEL, against its one-shot call
    b_wide = torch.from_numpy(phi_matrix(N, N_WIDE, 0.5, seed=2)).to(DEVICE)
    oracle_wide = {(r0, c0): dd_gemm(
        a[r0:r0 + 256].cpu().numpy(),
        np.ascontiguousarray(b_wide[:, c0:c0 + 256].cpu().numpy()))
        for r0, c0 in [(0, 0), (N // 2, N_WIDE // 2 + 128),
                       (N - 256, N_WIDE - 256)]}
    ref_wide, _, peak_wide = counted(lambda: gt.gemm(
        a, b_wide, num_moduli=L, device=DEVICE))
    rels[f"{N_WIDE} columns one-shot"] = gate(ref_wide, oracle_wide)
    assert rels[f"{N_WIDE} columns one-shot"] < 1e-8
    for name, pipe, want in panel_calls(N_WIDE):
        c, counts, peak = counted(lambda: pipe_gemm(a, b_wide, True, pipe,
                                                    n_panel=N_PANEL))
        log(f"  launches in the {N} x {N} x {N_WIDE} {name} call: {counts}")
        assert counts == want, f"{name} launch counts {counts}"
        assert torch.equal(bits64(c), bits64(ref_wide)), \
            f"{name}: not the one-shot call's bits"
        rels[name] = gate(c, oracle_wide)
        assert rels[name] < 1e-8, f"{name} relerr {rels[name]} >= 1e-8"
        del c
        log(f"  {N} x {N} x {N_WIDE} {name} == one-shot call (bits), gate "
            f"relerr {rels[name]!r}, peak {peak} bytes (one-shot "
            f"{peak_wide})")
        for kname in PIPELINE_KERNELS:
            launches[kname] = launches.get(kname, 0) + counts.get(kname, 0)
    del ref_wide
    # N_PLAIN^3: every call against the all-plain path on the same shifts
    a2 = a[:N_PLAIN, :N_PLAIN].contiguous()
    b2 = b[:N_PLAIN, :N_PLAIN].contiguous()
    assert pl.bsplit_applicable(N_PLAIN, N_PLAIN, N_PLAIN, L,
                                *pl.choose_panels(N_PLAIN, N_PLAIN, N_PLAIN,
                                                  L, True))
    assert pl.choose_panels(N_PLAIN, N_PLAIN // 2, N_PLAIN, L) is not None
    plain = {True: plain_gemm(a2, b2, L, (hk.fast_sft(a2, L, 1),
                                          hk.fast_sft(b2, L, 0)))[0],
             False: plain_gemm(a2, b2, L, tg.accurate_sfts(a2, b2, L))[0]}
    for name, fastmode, pipe, _ in pipeline_calls():
        assert_bits_equal(pipe_gemm(a2, b2, fastmode, pipe), plain[fastmode],
                          f"{N_PLAIN}^3 {name} vs plain path")
    for name, pipe, _ in panel_calls(N_WIDE):
        assert_bits_equal(pipe_gemm(a2, b2, True, pipe,
                                    n_panel=N_PLAIN // 2),
                          plain[True], f"{N_PLAIN}^3 {name} vs plain path")
    log(f"  {N_PLAIN}^3 pipelined and column-panel calls == all-plain path "
        "(bits)")
    return rels, b_wide, peak_wide


def phase_pipeline_times(a, b, b_wide, errs):
    """Phase 5p: at the main path's shapes (N^2 operands, 14 moduli, panels
    of PANEL_M rows), the rider step in its four forms, the pair and
    reconstruct_into beside what they replace and beside their plain
    versions (the warm-up outputs held bit for bit), PIPELINE_ROUNDS
    rounds in rotated order; then the pipelined calls against the default
    call of their mode, and the column-panel calls against the one-shot
    call on the wide B. Returns ({label: [ms]}, {kernel: plain ms},
    {call: [ms]})."""
    L, pm = L_MAIN, PANEL_M
    sa, sb = hk.fast_sft(a, L, 1), hk.fast_sft(b, L, 0)
    a8, b8 = hk.encode_slices(a, sa, L, 1), hk.encode_slices(b, sb, L, 0)
    bt = torch.empty((L, N, N), dtype=torch.int8, device=DEVICE)
    r0, _, _ = hp.matmul_rider_step(a8, bt, 0, None, -1, sa, sb, L, pm,
                                    b8=b8)
    b8t = b8.transpose(1, 2).contiguous()   # column-major B, untimed
    a8p = riders.panel_rows(a8, 1, pm).contiguous()
    a8_0 = riders.panel_rows(a8, 0, pm).contiguous()
    b8l = hk.encode_slices(b, sb, L, 0, col_tiles=(0, N // 2 // 512))
    out = torch.empty((N, N), dtype=torch.float64, device=DEVICE)
    nxt = min(2, N // pm - 1)        # the panel the encode rider encodes
    sa1, sa2 = riders.panel_rows(sa, 0, pm), riders.panel_rows(sa, nxt, pm)
    a2_rows = riders.panel_rows(a, nxt, pm)

    def step(rec_on, enc_on):
        return lambda: hp.matmul_rider_step(
            a8p, bt, 1, r0 if rec_on else None, 0, sa, sb, L, pm,
            a_src=a if enc_on else None, next_panel=nxt, out=out)

    plain_ms = {}
    for name, kern, plain in (
            ("matmul_rider_step", step(True, True),
             lambda: hp.matmul_rider_step_plain(
                 a8p, bt, 1, r0, 0, sa, sb, L, pm, a_src=a, next_panel=nxt,
                 out=out.clone())),
            ("matmul_bsplit_pair",
             lambda: hp.matmul_bsplit_pair(a8_0, b8l, b, sa, sb, L, pm,
                                           a_src=a),
             lambda: hp.matmul_bsplit_pair_plain(a8_0, b8l, b, sa, sb, L, pm,
                                                 a_src=a)),
            ("reconstruct_into",
             lambda: (hp.reconstruct_into(r0, sa, sb, L, out, N // pm - 1,
                                          pm),),
             lambda: (hp.reconstruct_into_plain(r0, sa, sb, L, out.clone(),
                                                N // pm - 1, pm),))):
        got = kern()
        plain_ms[name], ref = timed(plain, 1)
        if name == "reconstruct_into":
            got = (riders.panel_rows(got[0], N // pm - 1, pm),)
            ref = (riders.panel_rows(ref[0], N // pm - 1, pm),)
        hold_all(errs, name, got, ref, f"{name} at {N}^2, {L} moduli")
        del got, ref
        log(f"  {name} == plain at the main path's shapes ({N}^2 operands, "
            f"panels of {pm}, {L} moduli)")
    kerns, _ = timed_rounds({
        "rider step, no rider": step(False, False),
        "rider step, reconstruct rider": step(True, False),
        "rider step, encode rider": step(False, True),
        "matmul_rider_step": step(True, True),
        "matmul_mod_u8, one panel (its copy of B included)":
            lambda: hm.matmul_mod_u8(a8p, b8, L, centered=True),
        "reconstruct, one panel": lambda: hk.reconstruct(r0, sa1, sb, L),
        "encode_slices, one panel of A":
            lambda: hk.encode_slices(a2_rows, sa2, L, 1),
        "matmul_mod_u8 + reconstruct + encode_slices, one panel": lambda: (
            hm.matmul_mod_u8(a8p, b8, L, centered=True),
            hk.reconstruct(r0, sa1, sb, L),
            hk.encode_slices(a2_rows, sa2, L, 1)),
        "matmul_bsplit_pair": lambda: hp.matmul_bsplit_pair(
            a8_0, b8l, b, sa, sb, L, pm, a_src=a),
        "matmul_mod_u8 panel 0 + encode_slices of B's right half and of A "
        "panel 1": lambda: (
            hm.matmul_mod_u8(a8_0, b8, L, centered=True),
            hk.encode_slices(b, sb, L, 0, col_tiles=(N // 2 // 512,
                                                     N // 512)),
            hk.encode_slices(riders.panel_rows(a, 1, pm),
                             riders.panel_rows(sa, 1, pm), L, 1)),
        "reconstruct_into": lambda: hp.reconstruct_into(
            r0, sa, sb, L, out, N // pm - 1, pm),
        LIBRARY + ", one panel": int_mm(a8p, b8t),
    }, PIPELINE_ROUNDS, 5)
    del a8, b8, bt, r0, a8p, a8_0, b8l, out, b8t
    calls = {"fast default": (True, "0")}
    calls.update({name: (f, pipe) for name, f, pipe, _ in pipeline_calls()
                  if f})
    calls["accurate default"] = (False, "0")
    calls.update({name: (f, pipe) for name, f, pipe, _ in pipeline_calls()
                  if not f})
    by_name, _ = timed_rounds(
        {name: (lambda f=f, pipe=pipe: pipe_gemm(a, b, f, pipe))
         for name, (f, pipe) in calls.items()}, PIPELINE_ROUNDS, 2)
    wide = {f"{N_WIDE} columns one-shot": lambda: pipe_gemm(a, b_wide, True,
                                                            "0")}
    wide.update({name: (lambda pipe=pipe: pipe_gemm(
        a, b_wide, True, pipe, n_panel=N_PANEL))
        for name, pipe, _ in panel_calls(N_WIDE)})
    wide_ms, _ = timed_rounds(wide, PIPELINE_ROUNDS, 2)
    by_name.update(wide_ms)
    return kerns, plain_ms, by_name


# ---- f32 operands and output: phases 3f, 3b (f32), 4f, 5f -----------------

def operands32(m, k, n, seed, special):
    """f32 operands on the card; with special, A has a subnormal-only row,
    a zero row, -0.0, a row of mixed exponents, values near FLT_MAX and
    subnormals inside a normal row, and B a zero column, a subnormal-only
    column, subnormals inside a normal column and values near -FLT_MAX."""
    a = phi_matrix(m, k, 0.5, seed=seed).astype(np.float32)
    b = phi_matrix(k, n, 0.5, seed=seed + 1).astype(np.float32)
    if special:
        rng = np.random.default_rng(seed + 2)
        a[0, :] = rng.integers(1, 1 << 23, k).astype(np.uint32).view(
            np.float32)
        a[1, :] = 0.0
        a[2, ::7] = -0.0
        a[3, ::5] *= np.float32(2.0 ** 40)
        a[4, ::3] = np.float32(3.3e38)
        a[5, ::4] = np.uint32(5).view(np.float32)
        b[:, 3] = 0.0
        b[:, 4] = rng.integers(1, 1 << 23, k).astype(np.uint32).view(
            np.float32)
        b[::11, 5] = np.float32(1e-40)
        b[::3, 6] = np.float32(-3.3e38)
    return (torch.from_numpy(a).to(DEVICE), torch.from_numpy(b).to(DEVICE))


def phase_f32_kernels(errs):
    """Phase 3f: the f32 forms of fast_sft, encode_slices (every modulus,
    subsets of the moduli, column ranges), emax and mag7 against their
    plain versions on f32 operands, and reconstruct with f32 output on the
    matmul of their slices, on fast and accurate shifts."""
    for (m, k, n), Ls, special in F32_CASES:
        a, b = operands32(m, k, n, 17, special)
        tag0 = f"m={m} k={k} n={n} f32"
        pea, peb = hk.emax_plain(a, 1), hk.emax_plain(b, 0)
        hold(errs, "emax[f32]", (hk.emax(a, 1), hk.emax(b, 0)), (pea, peb),
             f"emax {tag0}")
        pma, pmb = hk.mag7_plain(a, pea, 1), hk.mag7_plain(b, peb, 0)
        hold(errs, "mag7[f32]", (hk.mag7(a, pea, 1), hk.mag7(b, peb, 0)),
             (pma, pmb), f"mag7 {tag0}")
        if special:   # the subnormal-only lines: max exponent 1
            assert (int(pea[0]), int(peb[0, 4])) == (1, 1)
        smax = hm.magmax_plain(pma, pmb)
        for L in Ls:
            tag = f"{tag0} L={L}"
            pa, pb = hk.fast_sft_plain(a, L, 1), hk.fast_sft_plain(b, L, 0)
            sa, sb = hk.fast_sft(a, L, 1), hk.fast_sft(b, L, 0)
            torch.cuda.synchronize()
            errs["fast_sft[f32]"] = max(errs["fast_sft[f32]"],
                                        check_sft(sa, pa, a, 1, L),
                                        check_sft(sb, pb, b, 0, L))
            acc = (enc.accurate_sft(smax[0], pea, L, mant_bits=24),
                   enc.accurate_sft(smax[1], peb, L, mant_bits=24))
            for mode, (xa, xb) in (("fast", (pa, pb)), ("accurate", acc)):
                a8 = hk.encode_slices(a, xa, L, axis=1)
                b8 = hk.encode_slices(b, xb, L, axis=0)
                hold(errs, "encode_slices[f32]", (a8, b8),
                     (hk.encode_slices_plain(a, xa, L, 1),
                      hk.encode_slices_plain(b, xb, L, 0)),
                     f"encode_slices {mode} {tag}")
                r8 = hm.matmul_mod_u8(a8, b8, L, centered=True)
                hold(errs, "reconstruct[f32]",
                     hk.reconstruct(r8, xa, xb, L, "f32"),
                     hk.reconstruct_plain(r8, xa, xb, L, "f32"),
                     f"reconstruct f32 output {mode} {tag}")
            for x, s, axis in ((a, pa, 1), (b, pb, 0)):
                for idx in moduli_subsets(L):
                    hold(errs, "encode_slices[f32]",
                         hk.encode_slices(x, s, L, axis, moduli_idx=idx),
                         hk.encode_slices_plain(x, s, L, axis,
                                                moduli_idx=idx),
                         f"encode_slices moduli_idx={idx} axis={axis} {tag}")
                for tiles in ((0, 1), (1, 2), (0, 3)):
                    if tiles[0] * enc.ENC_BLOCK[1] >= x.shape[1]:
                        continue
                    c0, c1 = enc.col_range(tiles, x.shape[1])
                    got = hk.encode_slices(x, s, L, axis, col_tiles=tiles)
                    ref = hk.encode_slices_plain(x, s, L, axis,
                                                 col_tiles=tiles)
                    hold(errs, "encode_slices[f32]", got[:, :, c0:c1],
                         ref[:, :, c0:c1],
                         f"encode_slices col_tiles={tiles} axis={axis} {tag}")
        log(f"  f32 kernel forms == plain at {tag0} L={Ls} (moduli subsets "
            "and column ranges of the encode too)")


# (x, e): reconstruct with f32 output must give x * 2^e rounded once to
# nearest even in f32
F32_ROUNDING_VALUES = [
    # f32 ties and one away on each side, a far sticky bit
    (2 ** 25 + 2, 0), (2 ** 25 + 1, 0), (2 ** 25 + 3, 0), (2 ** 25 + 6, 0),
    (2 ** 24 + 1, 0), (2 ** 24 + 3, 0), (-(2 ** 24 + 1), 5),
    ((2 ** 24 + 1) * 2 ** 40 + 1, -40),
    # rounding to f64 first and then to f32 would round these twice
    (2 ** 53 + 2 ** 29 + 1, -30), (2 ** 53 + 2 ** 29, -30),
    (2 ** 53 + 2 ** 29 - 1, -30), (-(2 ** 53 + 2 ** 29 + 1), 7),
    # f32 subnormals, underflow to 0, a subnormal tie rounding up into the
    # smallest normal, the largest finite value, overflow to inf
    (3, -151), (1, -150), (3, -150), (12345, -160), (1, -149), (-5, -151),
    (1, -152), (2 ** 24 - 1, -150), (-(2 ** 24 - 1), -150),
    (2 ** 24 - 1, 104), (2 ** 25 - 1, 103), (7, 126), (1, 127),
    (2 ** 60, 100), (-(2 ** 25 - 1), 103)]


def exact_f32(x, e):
    """x * 2^e rounded once to nearest even into f32 (subnormals, overflow
    to inf), from Python integers."""
    v = Fraction(x) * Fraction(2) ** e
    if v == 0:
        return 0.0
    a = abs(v)
    p = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** p > a:
        p -= 1                              # 2^p <= a < 2^(p+1)
    q = max(p, -126) - 23                   # the f32 step at a
    r = round(a / Fraction(2) ** q) * Fraction(2) ** q   # half to even
    if r >= 2 ** 128:
        return float("inf") if x > 0 else float("-inf")
    return float(r) if x > 0 else -float(r)


def phase_rounding_f32(errs):
    """Phase 3b, f32 output: reconstruct's f32 rounding from uint8, int8,
    int32 products and limbs (a carry pushed back into limb 0), held to its
    plain version and to the exactly rounded values."""
    for L in (8, 14, 20):
        half = tables.big_m(L) // 2
        vals = [(x, e) for x, e in F32_ROUNDING_VALUES if abs(x) < half]
        r = torch.tensor([[[x % tables.MODULI[j] for x, _ in vals]]
                          for j in range(L)], dtype=torch.int64)
        sft_a = torch.zeros((1, 1), dtype=torch.int32, device=DEVICE)
        sft_b = -torch.tensor([[e for _, e in vals]], dtype=torch.int32,
                              device=DEVICE)
        want = torch.tensor([[exact_f32(x, e) for x, e in vals]],
                            dtype=torch.float32)
        mods = torch.tensor(tables.MODULI[:L]).view(L, 1, 1)
        mult = torch.arange(-3, len(vals) - 3).view(1, 1, -1) * 1000003
        prod = (r + mods * (mult % 7919 - 4000)).to(torch.int32)
        limbs = torch.stack(rec.accumulate_weighted(r, L))
        back = limbs[1] > 0
        limbs[1][back] -= 1
        limbs[0][back] += 1 << 16
        for x, kind, what in (((r - 128).to(torch.int8), "residues", "int8"),
                              (r.to(torch.uint8), "residues", "uint8"),
                              (prod, "residues", "int32 products"),
                              (limbs.to(torch.int32), "limbs", "limbs")):
            x = x.to(DEVICE)
            c = hk.reconstruct(x, sft_a, sft_b, L, "f32", input_kind=kind)
            tag = f"reconstruct f32 rounding L={L} {what}"
            hold(errs, "reconstruct[f32]", c,
                 hk.reconstruct_plain(x, sft_a, sft_b, L, "f32", 0, kind),
                 tag)
            assert torch.equal(words(c.cpu()), words(want)), \
                f"{tag}: not the correctly rounded values"
        log(f"  reconstruct f32 rounding == plain == exact, L={L}, "
            f"{len(vals)} values (ties +-1, double-rounding traps, "
            "subnormals, inf), int8, uint8, int32 products and limbs")


def held_shifts(a, b, L, fastmode):
    """The all-plain path's shifts: the plain versions' (accurate: equal
    to the kernels'); in fast mode the kernels' where the floor rule lets
    a shift differ by 1."""
    if not fastmode:
        ka, kb = tg.accurate_sfts(a, b, L)
        pa, pb = accurate_plain_sfts(a, b, L)
        assert torch.equal(ka, pa) and torch.equal(kb, pb), \
            "accurate shifts: kernel path vs plain path"
        return pa, pb
    ka, kb = hk.fast_sft(a, L, 1), hk.fast_sft(b, L, 0)
    check_sft(ka, hk.fast_sft_plain(a, L, 1), a, 1, L)
    check_sft(kb, hk.fast_sft_plain(b, L, 0), b, 0, L)
    return ka, kb


def plain_call(a, b, L, fastmode, out_dtype, e_extra=0):
    """The all-plain path on f64, f32 or mixed operands (op N, shifts by
    held_shifts): plain encode, matmul and reconstruct into out_dtype."""
    sa, sb = held_shifts(a, b, L, fastmode)
    a8 = hk.encode_slices_plain(a, sa, L, 1)
    b8 = hk.encode_slices_plain(b, sb, L, 0)
    r8 = hm.matmul_mod_u8_plain(a8, b8, L, centered=True)
    return hk.reconstruct_plain(r8, sa, sb, L, out_dtype, e_extra)


def np_epilogue(raw, alpha, beta, c):
    """alpha * raw + beta * c in numpy on the host, each product and the sum
    rounded once in raw's dtype (f32: alpha, beta and c rounded to f32
    first): the epilogue's reference, independent of torch on the card."""
    raw = raw.cpu().numpy()
    dt = raw.dtype.type
    with np.errstate(over="ignore", under="ignore"):
        out = raw * dt(alpha) if alpha != 1.0 else raw
        if beta != 0.0:
            out = out + dt(beta) * c.astype(dt)
    return out


def f32_combos():
    """Phase 4f's N_PLAIN^3 calls: (name, a dtype, b dtype, gemm kwargs)."""
    calls = []
    for da, db in (("f32", "f32"), ("f64", "f32"), ("f32", "f64"),
                   ("f64", "f64")):
        for out in ("f32", "f64"):
            for fm in (True, False):
                calls.append((f"{da} x {db} -> {out} "
                              f"{'fast' if fm else 'accurate'}", da, db,
                              dict(out_dtype=out, fastmode=fm)))
    for fm in (True, False):
        mode = "fast" if fm else "accurate"
        calls += [
            (f"f32 x f64 op_a=T op_b=C {mode}", "f32", "f64",
             dict(fastmode=fm, op_a="T", op_b="C")),
            (f"f32 x f32 -> f32 alpha={ALPHA} beta={BETA} {mode}", "f32",
             "f32", dict(fastmode=fm, alpha=ALPHA, beta=BETA)),
            (f"f64 x f32 -> f64 alpha={ALPHA} beta={BETA} {mode}", "f64",
             "f32", dict(fastmode=fm, alpha=ALPHA, beta=BETA)),
            (f"f32 x f32 alpha=0.25 (folded) {mode}", "f32", "f32",
             dict(fastmode=fm, alpha=0.25)),
            (f"f32 x f32 moduli_chunk=3 {mode}", "f32", "f32",
             dict(fastmode=fm, moduli_chunk=3)),
            (f"f32 x f64 -> f32 n_panel=1024 {mode}", "f32", "f64",
             dict(fastmode=fm, out_dtype="f32", n_panel=1024)),
            (f"f16 x bf16 (widened) {mode}", "f16", "bf16",
             dict(fastmode=fm))]
    return calls


def check_f32_combo(name, a, b, kw, got, c_np):
    """One N_PLAIN^3 call against the all-plain path: each n_panel panel
    on its own shifts in accurate mode, the power-of-two alpha folded, the
    epilogue in numpy."""
    fm = kw["fastmode"]
    L = L_F32 if got.dtype == torch.float32 else L_MAIN
    out = "f32" if got.dtype == torch.float32 else "f64"
    alpha, beta = kw.get("alpha", 1.0), kw.get("beta", 0.0)
    e_extra = 0
    if beta == 0.0 and gt.api.pow2_exponent(alpha) is not None:
        e_extra, alpha = gt.api.pow2_exponent(alpha), 1.0
    if "n_panel" in kw and not fm:
        p = kw["n_panel"]
        raw = torch.cat([plain_call(a, b[:, j:j + p].contiguous(), L, fm,
                                    out, e_extra)
                         for j in range(0, b.shape[1], p)], dim=1)
    else:
        raw = plain_call(a, b, L, fm, out, e_extra)
    want = np_epilogue(raw, alpha, beta, c_np)
    assert np.array_equal(words(got.cpu()).numpy(),
                          words(torch.from_numpy(want)).numpy()), \
        f"{N_PLAIN}^3 {name}: not the all-plain path's bits"


def f32_main_calls(a, b32, a32, c_dev):
    """Phase 4f's N^3 calls: (name, fn, expected launch counts, gate kind:
    "f32" (median) or "f64" (max), or None where the bits are another
    call's)."""
    fast32 = {"fast_sft[f32]": 2, "encode_slices[f32]": 2,
              "matmul_mod_u8": 1, "reconstruct[f32]": 1}
    accu32 = {"emax[f32]": 2, "mag7[f32]": 2, "magmax_matmul": 1,
              "encode_slices[f32]": 2, "matmul_mod_u8": 1,
              "reconstruct[f32]": 1}
    mixed = {"fast_sft": 1, "fast_sft[f32]": 1, "encode_slices": 1,
             "encode_slices[f32]": 1, "matmul_mod_u8": 1, "reconstruct": 1}
    return [
        ("f32 x f32 -> f32 fast, 8 moduli", lambda: gt.gemm(
            a32, b32, num_moduli=L_F32, device=DEVICE), fast32, "f32"),
        ("f32 x f32 -> f32 accurate, 8 moduli", lambda: gt.gemm(
            a32, b32, num_moduli=L_F32, fastmode=False, device=DEVICE),
         accu32, "f32"),
        ("f64 x f32 -> f64 fast, 14 moduli", lambda: gt.gemm(
            a, b32, num_moduli=L_MAIN, device=DEVICE), mixed, "f64"),
        (f"f64 x f32 -> f64 alpha={ALPHA} beta={BETA}", lambda: gt.gemm(
            a, b32, num_moduli=L_MAIN, alpha=ALPHA, beta=BETA, c=c_dev,
            device=DEVICE), mixed, None),
        (f"f32 x f32 -> f32 alpha={ALPHA} beta={BETA}", lambda: gt.gemm(
            a32, b32, num_moduli=L_F32, alpha=ALPHA, beta=BETA, c=c_dev,
            device=DEVICE), fast32, None),
        ("f32 x f32 -> f32 op_a=T", lambda: gt.gemm(
            b32, b32, num_moduli=L_F32, op_a="T", device=DEVICE), fast32,
         None)]


def gate_median(c, oracle):
    """(max, median) relerr of the three 256 x 256 tiles of c together
    against the dd oracle."""
    got = np.concatenate([c[r0:r0 + 256, c0:c0 + 256].cpu().numpy()
                          .astype(np.float64) for r0, c0 in oracle])
    hi = np.concatenate([hi for hi, _ in oracle.values()])
    lo = np.concatenate([lo for _, lo in oracle.values()])
    return relerr_vs_dd(got, hi, lo)


def phase_f32(a, b, launches):
    """Phase 4f: every front-end combination at N_PLAIN^3 against the
    all-plain path; the f32 and mixed N^3 calls with launch counts, gates
    (f32: median relerr < F32_GATE_MEDIAN at 8 moduli; f64 < 1e-8), the
    epilogue in numpy and op_a="T"; peak memory beside the planner's
    figure. Returns (a32, b32, gate of each call)."""
    a_np = a.cpu().numpy()
    a32_np = a_np.astype(np.float32)
    a32 = torch.from_numpy(a32_np).to(DEVICE)
    b32 = a32.t().contiguous()
    c_np = phi_matrix(N, N, 0.5, seed=3)
    c_dev = torch.from_numpy(c_np).to(DEVICE)
    # N_PLAIN^3: every combination against the all-plain path
    n2 = N_PLAIN
    srcs = {"f64": (a[:n2, :n2].contiguous(), b[:n2, :n2].contiguous()),
            "f32": (a32[:n2, :n2].contiguous(), b32[:n2, :n2].contiguous())}
    srcs["f16"] = tuple(x.half() for x in srcs["f32"])
    srcs["bf16"] = tuple(x.bfloat16() for x in srcs["f32"])
    c2 = c_np[:n2, :n2].copy()
    for name, da, db, kw in f32_combos():
        a2, b2 = srcs[da][0], srcs[db][1]
        call_a = a2.t().contiguous() if kw.get("op_a", "N") != "N" else a2
        call_b = b2.t().contiguous() if kw.get("op_b", "N") != "N" else b2
        c_arg = c2 if kw.get("beta", 0.0) else None
        got = gt.gemm(call_a, call_b, num_moduli=L_F32
                      if kw.get("out_dtype") == "f32"
                      or (kw.get("out_dtype") is None
                          and "f64" not in (da, db)) else L_MAIN,
                      c=c_arg, device=DEVICE, **kw)
        check_f32_combo(name, a2.float() if da in ("f16", "bf16") else a2,
                        b2.float() if db in ("f16", "bf16") else b2, kw, got,
                        c2)
        del got
    log(f"  {N_PLAIN}^3: {len(f32_combos())} front-end calls (f32, mixed, "
        "f16/bf16 widened, f32/f64 output, op T/C, alpha/beta, the pow2 "
        "fold, moduli_chunk=3, n_panel=1024; fast and accurate) == all-plain "
        "path (bits), the epilogue held to numpy's separate roundings")
    # N^3
    b32_np = np.ascontiguousarray(a32_np.T)
    tiles = [(0, 0), (N // 2, N - 256), (N - 256, N - 256)]
    oracle32 = {(r0, c0): dd_gemm(a32_np[r0:r0 + 256].astype(np.float64),
                                  b32_np[:, c0:c0 + 256].astype(np.float64))
                for r0, c0 in tiles}
    oracle_mixed = {(r0, c0): dd_gemm(a_np[r0:r0 + 256],
                                      b32_np[:, c0:c0 + 256].astype(
                                          np.float64))
                    for r0, c0 in tiles}
    plan = planner.workspace_bytes(N, N, N, L_F32)
    rels, outs = {}, {}
    for name, fn, want, kind in f32_main_calls(a, b32, a32, c_dev):
        c, counts, peak = counted(fn)
        log(f"  launches in the {N}^3 {name} call: {counts}")
        assert counts == want, f"{name} launch counts {counts}"
        for key, cnt in counts.items():
            if key.endswith("[f32]"):
                launches[key] = launches.get(key, 0) + cnt
        assert c.shape == (N, N) and bool(torch.isfinite(c).all())
        line = f"  {N}^3 {name}: peak {peak} bytes above the operands"
        if kind == "f32":
            assert c.dtype == torch.float32
            rels[name] = gate_median(c, oracle32)
            assert rels[name][1] < F32_GATE_MEDIAN, \
                f"{name}: median relerr {rels[name][1]} >= {F32_GATE_MEDIAN}"
            line += (f" (planner, f64 output: {plan}); gate relerr max "
                     f"{rels[name][0]!r}, median {rels[name][1]!r}")
            outs.setdefault("f32", c)
        elif kind == "f64":
            assert c.dtype == torch.float64
            rels[name] = gate_median(c, oracle_mixed)
            assert rels[name][0] < 1e-8, f"{name}: relerr {rels[name][0]}"
            line += (f"; gate relerr max {rels[name][0]!r}, median "
                     f"{rels[name][1]!r}")
            outs["f64"] = c
        elif "alpha" in name:
            raw = outs["f32" if c.dtype == torch.float32 else "f64"]
            want_np = np_epilogue(raw, ALPHA, BETA, c_np)
            assert np.array_equal(words(c.cpu()).numpy(),
                                  words(torch.from_numpy(want_np)).numpy()), \
                f"{name}: not numpy's epilogue on the raw call"
            line += "; == numpy's separate roundings on the raw call (bits)"
        else:
            assert torch.equal(words(c), words(outs["f32"])), \
                f"{name}: not the op N call's bits"
            line += "; == the op N call (bits)"
        log(line)
        del c
    del outs
    return a32, b32, rels


def phase_f32_times(a, b, a32, b32, errs):
    """Phase 5f: at N^2 operands and 8 moduli, each f32 kernel form beside
    its f64 form (rotated rounds) and its plain version (warm-up outputs
    held bit for bit); then the f32 and f64 N^3 calls at 8 moduli and
    torch.matmul in f32 with TF32 off, F32_ROUNDS rounds in rotated order.
    Returns ({kernel: (f32 ms, f64 ms, plain ms)}, {call: [ms]})."""
    L = L_F32
    sft = {}
    for tag, (x, y) in (("f64", (a, b)), ("f32", (a32, b32))):
        sft[tag] = (hk.fast_sft(x, L, 1), hk.fast_sft(y, L, 0))
    sa, sb = sft["f32"]
    r8 = hm.matmul_mod_u8(hk.encode_slices(a32, sa, L, 1),
                          hk.encode_slices(b32, sb, L, 0), L, centered=True)
    ex = {"f64": (hk.emax(a, 1), hk.emax(b, 0)),
          "f32": (hk.emax(a32, 1), hk.emax(b32, 0))}

    def forms(tag):
        x, y = (a, b) if tag == "f64" else (a32, b32)
        s, e = sft[tag], ex[tag]
        out = "f32" if tag == "f32" else "f64"
        return {
            "fast_sft": lambda: (hk.fast_sft(x, L, 1), hk.fast_sft(y, L, 0)),
            "encode_slices": lambda: (hk.encode_slices(x, s[0], L, 1),
                                      hk.encode_slices(y, s[1], L, 0)),
            "emax": lambda: (hk.emax(x, 1), hk.emax(y, 0)),
            "mag7": lambda: (hk.mag7(x, e[0], 1), hk.mag7(y, e[1], 0)),
            "reconstruct": lambda: hk.reconstruct(r8, sa, sb, L, out)}

    plain = {
        "fast_sft": lambda: (hk.fast_sft_plain(a32, L, 1),
                             hk.fast_sft_plain(b32, L, 0)),
        "encode_slices": lambda: (hk.encode_slices_plain(a32, sa, L, 1),
                                  hk.encode_slices_plain(b32, sb, L, 0)),
        "emax": lambda: (hk.emax_plain(a32, 1), hk.emax_plain(b32, 0)),
        "mag7": lambda: (hk.mag7_plain(a32, ex["f32"][0], 1),
                         hk.mag7_plain(b32, ex["f32"][1], 0)),
        "reconstruct": lambda: hk.reconstruct_plain(r8, sa, sb, L, "f32")}
    f64_forms, f32_forms = forms("f64"), forms("f32")
    kerns = {}
    for name in F32_KERNELS:
        key = build.form(name, True)
        got = f32_forms[name]()
        ref = plain[name]()
        if name == "fast_sft":
            errs[key] = max(errs[key], check_sft(got[0], ref[0], a32, 1, L),
                            check_sft(got[1], ref[1], b32, 0, L))
        else:
            hold(errs, key, got, ref, f"{key} at {N}^2, {L} moduli")
        del got, ref
        by_name, _ = timed_rounds({key: f32_forms[name],
                                   name: f64_forms[name]}, F32_ROUNDS, 5)
        pms, _ = timed(plain[name], 2)
        kerns[key] = (float(np.median(by_name[key])),
                      float(np.median(by_name[name])), pms)
    for line in sft_half_lines("fast_sft", lambda x, ax: hk.fast_sft(x, L, ax),
                               (a32,), (b32,)):
        log(line)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        calls, _ = timed_rounds({
            "f32 fast-8": lambda: gt.gemm(a32, b32, num_moduli=L,
                                          device=DEVICE),
            "f32 accurate-8": lambda: gt.gemm(a32, b32, num_moduli=L,
                                              fastmode=False, device=DEVICE),
            "f64 fast-8": lambda: gt.gemm(a, b, num_moduli=L, device=DEVICE),
            "f64 accurate-8": lambda: gt.gemm(a, b, num_moduli=L,
                                              fastmode=False, device=DEVICE),
            "torch.matmul f32 (TF32 off)": lambda: torch.matmul(a32, b32)},
            F32_ROUNDS, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    return kerns, calls


# ---- complex64, mixed complex and the one-shot variants' f32 forms: -------
# ---- phases 3x, 4x, 5x ----------------------------------------------------

def c64_operands(m, k, n, seed, special):
    """(a_re, a_im, b_re, b_im) f32 parts on the card, each with phase 3f's
    special lines where special, and a row of A whose Im part is all zero
    and a column of B whose Re part is."""
    a_re, b_re = operands32(m, k, n, seed, special)
    a_im, b_im = operands32(m, k, n, seed + 10, special)
    if special:
        a_im[6, :] = 0.0
        b_re[:, 7] = 0.0
    return a_re, a_im, b_re, b_im


def phase_c64_kernels(errs):
    """Phase 3x: the f32 statistics mode on each part and the joint f32
    shift, the f32 |Re| + |Im| magnitudes, and fast_encode_fused[f32],
    mag7_fused[f32] and matmul_reconstruct[f32] against their plain
    versions at phase 3f's shapes and moduli counts (the fused stats
    kernels' shifts also equal to the fast_sft kernel's)."""
    key = build.form("fast_stats", True)
    for (m, k, n), Ls, special in F32_CASES:
        a_re, a_im, b_re, b_im = c64_operands(m, k, n, 23, special)
        tag = f"m={m} k={k} n={n} f32"
        for x, axis in ((a_re, 1), (a_im, 1), (b_re, 0), (b_im, 0)):
            for L in Ls:
                check_stats(errs, x, axis, L)
        for L in Ls:
            for re, im, axis in ((a_re, a_im, 1), (b_re, b_im, 0)):
                errs[key] = max(errs[key], check_joint_sft(
                    enc.joint_fast_sft(re, im, L, axis, stats=hk.fast_stats),
                    enc.joint_fast_sft(re, im, L, axis), re, im, axis, L))
        for re, im, axis in ((a_re, a_im, 1), (b_re, b_im, 0)):
            hold(errs, "mag7[f32]", hk.mag7_operand_complex(re, im, axis),
                 mag7_complex_plain(re, im, axis),
                 f"complex magnitudes {tag} axis={axis}")
        for x, axis in ((a_re, 1), (b_re, 0)):
            got = hk.mag7_fused(x, axis)
            hold(errs, "mag7_fused[f32]", got, hk.mag7_fused_plain(x, axis),
                 f"mag7_fused {tag} axis={axis}")
            e = hk.emax(x, axis)
            assert torch.equal(got[1], e) and torch.equal(
                got[0], hk.mag7(x, e, axis)), \
                f"mag7_fused[f32] {tag}: not the emax + mag7 kernels' bits"
            for L in Ls:
                sl, sft = hk.fast_encode_fused(x, L, axis)
                assert torch.equal(sft, hk.fast_sft(x, L, axis)), \
                    f"fast_encode_fused[f32] {tag} L={L}: shifts differ " \
                    "from the fast_sft kernel's"
                _, psft = hk.fast_encode_fused_plain(x, L, axis)
                errs["fast_encode_fused[f32]"] = max(
                    errs["fast_encode_fused[f32]"],
                    check_sft(sft, psft, x, axis, L))
                hold(errs, "fast_encode_fused[f32]", sl,
                     hk.encode_slices_plain(x, sft, L, axis),
                     f"fast_encode_fused slices {tag} L={L} axis={axis}")
        for L in Ls:
            sa, sb = hk.fast_sft(a_re, L, 1), hk.fast_sft(b_re, L, 0)
            a8 = hk.encode_slices(a_re, sa, L, 1)
            b8 = hk.encode_slices(b_re, sb, L, 0)
            got = hm.matmul_reconstruct(a8, b8, sa, sb, L, "f32")
            hold(errs, "matmul_reconstruct[f32]", got,
                 hm.matmul_reconstruct_plain(a8, b8, sa, sb, L, "f32"),
                 f"matmul_reconstruct f32 output {tag} L={L}")
            assert torch.equal(words(got), words(hk.reconstruct(
                hm.matmul_mod_u8(a8, b8, L, centered=True), sa, sb, L,
                "f32"))), f"matmul_reconstruct[f32] {tag} L={L}: not " \
                "matmul_mod_u8 + reconstruct's bits"
        log(f"  f32 stats (parts, joint), complex magnitudes, "
            f"fast_encode_fused, mag7_fused, matmul_reconstruct f32 forms == "
            f"plain at {tag} L={Ls}")


def c64_launches(fastmode):
    """The launch counts of a complex64 x complex64 call."""
    if fastmode:
        return {"fast_stats[f32]": 4, "encode_slices[f32]": 4,
                "matmul_complex_mod": 1, "reconstruct[f32]": 2}
    return {"emax[f32]": 4, "mag7[f32]": 4, "magmax_matmul": 1,
            "encode_slices[f32]": 4, "matmul_complex_mod": 1,
            "reconstruct[f32]": 2}


def np_epilogue_c64(raw, alpha, beta, c):
    """The complex64 epilogue in numpy on the host, as the JAX package's
    source writes it: alpha and beta rounded to f32, c narrowed to
    complex64, the full complex formula, each product and sum rounded
    once."""
    f32 = np.float32
    raw = raw.cpu().numpy()
    ore, oim = raw.real.copy(), raw.imag.copy()
    ar, ai = f32(alpha.real), f32(alpha.imag)
    br, bi = f32(beta.real), f32(beta.imag)
    cn = np.asarray(c, np.complex64)
    with np.errstate(over="ignore", invalid="ignore"):
        ore, oim = ore * ar - oim * ai, ore * ai + oim * ar
        ore = ore + cn.real * br - cn.imag * bi
        oim = oim + cn.real * bi + cn.imag * br
    out = np.empty(raw.shape, np.complex64)
    out.real, out.imag = ore, oim
    return out


def cwords(t):
    """The f32 or f64 words of a complex tensor, Re and Im interleaved."""
    return words(torch.view_as_real(t))


def counted_call(name, fn, want):
    """fn() with the launch counts reset just before it and read just
    after, asserted equal to want; returns (output, counts)."""
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    c = fn()
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    log(f"  launches in the {N}^3 {name} call: {counts}")
    assert counts == want, f"{name} launch counts {counts}"
    return c, counts


def add_launches(launches, counts):
    for name, cnt in counts.items():
        key = KERNEL_OF.get(name, name)
        launches[key] = launches.get(key, 0) + cnt


def phase_complex64(A, a32, b32, launches):
    """Phase 4x: at N^3, complex64 x complex64 -> complex64 at 8 moduli
    (A64 = A rounded to complex64 on the card, B64 = A64.T), the three
    strategies fast and Karatsuba and big-matrix accurate, each with its
    launch counts and the median relerr of three 256 x 256 tiles against
    the dd oracle of the complex64 operands (< F32_GATE_MEDIAN), the fast
    strategies' bits identical; complex128 x complex64 -> complex128 at 14
    moduli (gate < 1e-8); op_a="C" on conj(A64).T made by numpy on the
    host (the op N call's bits); complex alpha/beta with a complex64 c
    (numpy's epilogue on the host, on the raw call's bits); f32 x f32 ->
    f32 at 8 moduli under GEMMUL8_FUSED_ENCODE, GEMMUL8_FUSED_MAG7 and
    GEMMUL8_FUSED_RECONSTRUCT (the default call's bits, the variant's f32
    form launched); then at N_PLAIN^3 the complex64 and mixed kernel paths
    against the all-plain path. Returns (A64, B64, gates)."""
    L = L_F32
    A64 = A.to(torch.complex64)
    B64 = A64.t().contiguous()
    h_re = A64.real.cpu().numpy().astype(np.float64)
    h_im = A64.imag.cpu().numpy().astype(np.float64)
    oracle64 = complex_oracle(h_re, h_im)
    rels, fast_bits = {}, []
    for strat, fastmode in COMPLEX_CALLS:
        mode = f"complex64 {strat.name} {'fast' if fastmode else 'accurate'}"
        c, counts = counted_call(mode, lambda: gt.gemm(
            A64, B64, num_moduli=L, fastmode=fastmode, compute_type=strat,
            device=DEVICE), c64_launches(fastmode))
        add_launches(launches, counts)
        assert c.shape == (N, N) and c.dtype == torch.complex64
        assert bool(torch.isfinite(torch.view_as_real(c)).all())
        e = complex_relerrs(c, oracle64)
        rels[mode] = (float(e.max()), float(np.median(e)))
        assert rels[mode][1] < F32_GATE_MEDIAN, \
            f"{mode}: median relerr {rels[mode][1]} >= {F32_GATE_MEDIAN}"
        log(f"  {N}^3 {mode}: gate relerr max {rels[mode][0]!r}, median "
            f"{rels[mode][1]!r}")
        if fastmode:
            fast_bits.append(c)
        del c
    for c in fast_bits[1:]:
        assert torch.equal(cwords(c), cwords(fast_bits[0])), \
            "the fast complex64 strategies disagree in bits"
    raw = fast_bits[0]
    del fast_bits
    log("  the three fast complex64 strategies give identical bits")
    # complex128 x complex64
    a_re, a_im = (x.cpu().numpy() for x in cg.canon_complex(A))
    mixed = {"fast_stats": 2, "fast_stats[f32]": 2, "encode_slices": 2,
             "encode_slices[f32]": 2, "matmul_complex_mod": 1,
             "reconstruct": 2}
    c, counts = counted_call("complex128 x complex64 -> complex128, 14 "
                             "moduli", lambda: gt.gemm(
                                 A, B64, num_moduli=L_MAIN, device=DEVICE),
                             mixed)
    add_launches(launches, counts)
    assert c.dtype == torch.complex128 and bool(
        torch.isfinite(torch.view_as_real(c)).all())
    e = complex_relerrs(c, complex_oracle(a_re, a_im, h_re, h_im))
    rels["c128 x c64"] = (float(e.max()), float(np.median(e)))
    assert rels["c128 x c64"][0] < 1e-8, f"c128 x c64 relerr {e.max()}"
    log(f"  {N}^3 complex128 x complex64 -> complex128: gate relerr max "
        f"{rels['c128 x c64'][0]!r}, median {rels['c128 x c64'][1]!r}")
    del c, a_re, a_im, h_re, h_im
    # op C, on the conjugate transpose made by numpy on the host
    stored = torch.from_numpy(np.ascontiguousarray(
        np.conj(A64.cpu().numpy()).T)).to(DEVICE)
    c, counts = counted_call("complex64 op_a=C", lambda: gt.gemm(
        stored, B64, num_moduli=L, op_a="C", device=DEVICE),
        c64_launches(True))
    add_launches(launches, counts)
    assert torch.equal(cwords(c), cwords(raw)), \
        "op_a=C on numpy's conj(A).T: not the op N call's bits"
    log(f"  {N}^3 complex64 op_a=C on numpy's conj(A).T == the op N call "
        "(bits)")
    del c, stored
    # complex alpha/beta with a complex64 c, against numpy on the host
    c_np = (phi_matrix(N, N, 0.5, seed=3)
            + 1j * phi_matrix(N, N, 0.5, seed=4)).astype(np.complex64)
    c_dev = torch.from_numpy(c_np).to(DEVICE)
    c, counts = counted_call(
        f"complex64 alpha={C_ALPHA} beta={C_BETA}", lambda: gt.gemm(
            A64, B64, num_moduli=L, alpha=C_ALPHA, beta=C_BETA, c=c_dev,
            device=DEVICE), c64_launches(True))
    add_launches(launches, counts)
    want = np_epilogue_c64(raw, C_ALPHA, C_BETA, c_np)
    assert np.array_equal(cwords(c.cpu()).numpy(),
                          cwords(torch.from_numpy(want)).numpy()), \
        "complex alpha/beta: not numpy's separate roundings on the raw call"
    log(f"  {N}^3 complex64 alpha={C_ALPHA} beta={C_BETA}: == numpy's "
        "separate f32 roundings on the raw call (bits)")
    del c, c_dev, c_np, want, raw
    # f32 calls under the one-shot variants' switches
    defaults = {}
    for name, fastmode, env, want in F32_SWITCH_CALLS:
        if fastmode not in defaults:
            defaults[fastmode] = gt.gemm(a32, b32, num_moduli=L,
                                         fastmode=fastmode, device=DEVICE)
        c, counts = counted_call(name, lambda: under(env, lambda: gt.gemm(
            a32, b32, num_moduli=L, fastmode=fastmode, device=DEVICE)), want)
        add_launches(launches, counts)
        assert torch.equal(words(c), words(defaults[fastmode])), \
            f"{name}: not the default call's bits"
        log(f"  {N}^3 {name} == the default call (bits)")
        del c
    del defaults
    # N_PLAIN^3 against the all-plain path
    n2 = N_PLAIN
    A2, B2 = A64[:n2, :n2].contiguous(), B64[:n2, :n2].contiguous()
    for fastmode in (True, False):
        for strat in (CT.COMPLEX_CLASSIC_MULT, CT.COMPLEX_KARATSUBA_MULT):
            check_plain_complex(A2, B2, L, fastmode, strat)
    check_plain_complex(A[:n2, :n2].contiguous(), B2, L_MAIN, True,
                        CT.COMPLEX_BIG_MATRIX_ENCODE)
    return A64, B64, rels


def check_plain_complex(A2, B2, L, fastmode, strat):
    """One N_PLAIN^3 complex call through the kernels against the all-plain
    path (the kernels' joint fast shifts where the floor rule lets them
    differ)."""
    parts = list(cg.canon_complex(A2)) + list(cg.canon_complex(B2))
    out = "f64" if torch.float64 in (parts[0].dtype, parts[2].dtype) \
        else "f32"
    kara = strat == CT.COMPLEX_KARATSUBA_MULT
    ck = gt.gemm(A2, B2, num_moduli=L, fastmode=fastmode, compute_type=strat,
                 device=DEVICE)
    cp, pa, pb = plain_gemm_complex(parts, L, fastmode, kara, out=out)
    if fastmode:
        sa = enc.joint_fast_sft(parts[0], parts[1], L, 1, stats=hk.fast_stats)
        sb = enc.joint_fast_sft(parts[2], parts[3], L, 0, stats=hk.fast_stats)
        if not (torch.equal(sa, pa) and torch.equal(sb, pb)):
            check_joint_sft(sa, pa, parts[0], parts[1], 1, L)
            check_joint_sft(sb, pb, parts[2], parts[3], 0, L)
            cp, _, _ = plain_gemm_complex(parts, L, True, kara, (sa, sb), out)
    else:
        sa, sb = cg.accurate_sfts_complex(*parts, L)
        assert torch.equal(sa, pa) and torch.equal(sb, pb), \
            "complex accurate shifts: kernel path vs plain path"
    kinds = f"{A2.dtype} x {B2.dtype}".replace("torch.", "")
    assert ck.dtype == cp.dtype and torch.equal(cwords(ck), cwords(cp)), \
        f"{N_PLAIN}^3 {kinds} {strat.name} kernel path vs plain"
    log(f"  {N_PLAIN}^3 {kinds} {strat.name} "
        f"{'fast' if fastmode else 'accurate'} kernel path == all-plain "
        "path (bits)")


def phase_complex64_times(A, A64, B64, a, b, a32, b32, errs):
    """Phase 5x: at N^2 operands, 8 moduli, each new f32 form beside its
    f64 form and the kernels it replaces (medians of F32_ROUNDS rotated
    rounds) and beside its plain version, the warm-up outputs held to it
    (shifts under the floor rule, everything else bit for bit): the
    statistics mode on the four parts (A's rows, B's columns),
    fast_encode_fused and mag7_fused on A's rows and B's columns,
    matmul_reconstruct on their slices; then the complex64 N^3 calls and
    torch.matmul in complex64 with TF32 off, F32_ROUNDS rotated rounds.
    Returns ({key: (ms, {label: ms}, plain ms)}, {call: [ms]})."""
    L = L_F32
    p64 = list(cg.canon_complex(A)) + list(cg.canon_complex(A.t()))
    p32 = list(cg.canon_complex(A64)) + list(cg.canon_complex(B64))
    axes = (1, 1, 0, 0)
    for x, axis in zip(p32, axes):
        check_stats(errs, x, axis, L)
    for line in sft_half_lines("fast_stats", hk.fast_stats, p32[:2], p32[2:]):
        log(line)
    kerns = {}

    def record(key, rounds, plain):
        pms, _ = timed(plain, 1)
        meds = {label: float(np.median(v)) for label, v in rounds.items()}
        kerns[key] = (meds[key], meds, pms)

    record("fast_stats[f32]", timed_rounds({
        "fast_stats[f32]": lambda: [hk.fast_stats(x, ax)
                                    for x, ax in zip(p32, axes)],
        "fast_stats (f64 parts)": lambda: [hk.fast_stats(x, ax)
                                           for x, ax in zip(p64, axes)],
    }, F32_ROUNDS, 5)[0], lambda: [hk.fast_stats_plain(x, ax)
                                   for x, ax in zip(p32, axes)])
    del p64, p32
    key = "fast_encode_fused[f32]"
    got = (hk.fast_encode_fused(a32, L, 1), hk.fast_encode_fused(b32, L, 0))
    for (sl, sft), x, axis in zip(got, (a32, b32), (1, 0)):
        errs[key] = max(errs[key], check_sft(
            sft, hk.fast_sft_plain(x, L, axis), x, axis, L))
        hold(errs, key, sl, hk.encode_slices_plain(x, sft, L, axis),
             f"{key} at {N}^2, {L} moduli, axis={axis}")
    (a8, sa), (b8, sb) = got
    del got
    record(key, timed_rounds({
        key: lambda: (hk.fast_encode_fused(a32, L, 1),
                      hk.fast_encode_fused(b32, L, 0)),
        "fast_encode_fused (f64)": lambda: (hk.fast_encode_fused(a, L, 1),
                                            hk.fast_encode_fused(b, L, 0)),
        "fast_sft[f32] + encode_slices[f32]": lambda: [
            hk.encode_slices(x, hk.fast_sft(x, L, ax), L, ax)
            for x, ax in ((a32, 1), (b32, 0))],
    }, F32_ROUNDS, 5)[0], lambda: (hk.fast_encode_fused_plain(a32, L, 1),
                                   hk.fast_encode_fused_plain(b32, L, 0)))
    key = "mag7_fused[f32]"
    for x, axis in ((a32, 1), (b32, 0)):
        hold(errs, key, hk.mag7_fused(x, axis), hk.mag7_fused_plain(x, axis),
             f"{key} at {N}^2, axis={axis}")
    record(key, timed_rounds({
        key: lambda: (hk.mag7_fused(a32, 1), hk.mag7_fused(b32, 0)),
        "mag7_fused (f64)": lambda: (hk.mag7_fused(a, 1),
                                     hk.mag7_fused(b, 0)),
        "emax[f32] + mag7[f32]": lambda: [
            hk.mag7(x, hk.emax(x, ax), ax) for x, ax in ((a32, 1), (b32, 0))],
    }, F32_ROUNDS, 5)[0], lambda: (hk.mag7_fused_plain(a32, 1),
                                   hk.mag7_fused_plain(b32, 0)))
    key = "matmul_reconstruct[f32]"
    hold(errs, key, hm.matmul_reconstruct(a8, b8, sa, sb, L, "f32"),
         hm.matmul_reconstruct_plain(a8, b8, sa, sb, L, "f32"),
         f"{key} at {N}^2, {L} moduli")
    b8t = b8.transpose(1, 2).contiguous()   # column-major B, untimed
    record(key, timed_rounds({
        LIBRARY: int_mm(a8, b8t),
        key: lambda: hm.matmul_reconstruct(a8, b8, sa, sb, L, "f32"),
        "matmul_reconstruct (f64 output)": lambda: hm.matmul_reconstruct(
            a8, b8, sa, sb, L),
        "matmul_mod_u8 + reconstruct[f32]": lambda: hk.reconstruct(
            hm.matmul_mod_u8(a8, b8, L, centered=True), sa, sb, L, "f32"),
    }, F32_ROUNDS, 2)[0], lambda: hm.matmul_reconstruct_plain(
        a8, b8, sa, sb, L, "f32"))
    del a8, b8, b8t
    log(f"  the new f32 forms == plain at the main path's shapes ({N}^2, "
        f"{L} moduli)")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        calls = {f"{strat.name} {'fast' if f else 'accurate'}":
                 (lambda s=strat, f=f: gt.gemm(A64, B64, num_moduli=L,
                                               fastmode=f, compute_type=s,
                                               device=DEVICE))
                 for strat, f in COMPLEX_CALLS}
        calls["torch.matmul complex64 (TF32 off)"] = \
            lambda: torch.matmul(A64, B64)
        by_name, _ = timed_rounds(calls, F32_ROUNDS, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    return kerns, by_name


# ---- the riders' f32 forms, batched and timed calls: phases 3r, 4r, 5r, --
# ---- 4b, 5b ---------------------------------------------------------------

def spread_special(a, b, pm):
    """a and b with the special lines of operands() / operands32() (A's
    rows 0-5, B's columns 3-6) copied into the first rows of every A panel
    and into B's right half, where the encode riders read."""
    a, b = a.clone(), b.clone()
    for p in range(1, a.shape[0] // pm):
        a[p * pm:p * pm + 6] = a[:6]
    h = b.shape[1] // 2
    b[:, h + 3:h + 7] = b[:, 3:7]
    return a, b


def rider_operands(m, k, n, pm, seed):
    """{word: (a, b)} on the card for "f64" and "f32", with the special
    lines spread over every panel and B's right half."""
    return {"f64": spread_special(*operands(m, k, n, seed, True), pm),
            "f32": spread_special(*operands32(m, k, n, seed, True), pm)}


def phase_rider_f32_kernels(errs):
    """Phase 3r: the riders' f32 forms against their plain versions on
    the card, bit-equal, at phase 3p's shapes and moduli, with f32 and f64
    special lines in every panel and in B's right half: the rider step in
    each new (A word, output word) form with each rider combination, with
    and without out=, on the residues of its operands and on random
    residues; the pair in each new (A word, B word) form with and without
    the A-panel-1 rider; reconstruct_into with f32 output."""
    for (m, k, n), Ls, pm in PIPELINE_CASES:
        ops = rider_operands(m, k, n, pm, 9)
        last = m // pm - 1
        for L in Ls:
            tag = f"m={m} k={k} n={n} L={L} panel_m={pm}"
            rng = np.random.default_rng(L)
            r_rand = torch.from_numpy(np.stack([
                rng.integers(0, tables.MODULI[j], (pm, n))
                for j in range(L)]).astype(np.uint8)).to(DEVICE)
            enc_ops = {}
            for aw, bw in (("f64", "f64"), ("f64", "f32"), ("f32", "f64"),
                           ("f32", "f32")):
                a, b = ops[aw][0], ops[bw][1]
                sa = hk.fast_sft_plain(a, L, axis=1)
                sb = hk.fast_sft_plain(b, L, axis=0)
                a8 = hk.encode_slices(a, sa, L, axis=1)
                b8 = hk.encode_slices(b, sb, L, axis=0)
                enc_ops[aw, bw] = (a, b, sa, sb, a8, b8)
            # the step: the words of A's source and of the output
            for aw, ow in (("f64", "f32"), ("f32", "f64"), ("f32", "f32")):
                a, b, sa, sb, a8, b8 = enc_ops[aw, "f64"]
                name = build.form("matmul_rider_step", aw == "f32",
                                  ow == "f32")
                bt = riders.kmajor(b8)
                a8p = riders.panel_rows(a8, 1, pm).contiguous()
                r1 = hp.matmul_rider_step_plain(a8, bt, 1, None, -1, sa, sb,
                                                L, pm)[0]
                for r_prev, enc_on in ((None, False), (None, True),
                                       (r1, False), (r1, True),
                                       (r_rand, True)):
                    kw = dict(a_src=a if enc_on else None,
                              next_panel=min(2, last), a_kind=aw,
                              out_kind=ow)
                    args = (bt, 1, r_prev, 0, sa, sb, L, pm)
                    what = (f"{name} rec={r_prev is not None} enc={enc_on}"
                            f"{' random residues' if r_prev is r_rand else ''}"
                            f" {tag}")
                    for slices in (a8, a8p):
                        out = torch.zeros((m, n), device=DEVICE,
                                          dtype=riders.KINDS[ow])
                        hold_all(errs, name,
                                 hp.matmul_rider_step(slices, *args,
                                                      out=out, **kw),
                                 hp.matmul_rider_step_plain(
                                     slices, *args, out=out.clone(), **kw),
                                 what)
                    hold_all(errs, name,
                             hp.matmul_rider_step(a8p, *args, **kw),
                             hp.matmul_rider_step_plain(a8p, *args, **kw),
                             f"{what} pieces")
            # the pair: the words of A's and of B's sources
            for aw, bw in (("f64", "f32"), ("f32", "f64"), ("f32", "f32")):
                a, b, sa, sb, a8, b8 = enc_ops[aw, bw]
                name = build.form("matmul_bsplit_pair", aw == "f32",
                                  bw == "f32")
                b8l = hk.encode_slices(b, sb, L, 0,
                                       col_tiles=(0, n // 2 // 512))
                a8_0 = riders.panel_rows(a8, 0, pm).contiguous()
                for src in (None, a):
                    kw = dict(a_src=src, a_kind=aw, b_kind=bw)
                    got = hp.matmul_bsplit_pair(a8_0, b8l, b, sa, sb, L, pm,
                                                **kw)
                    hold_all(errs, name, got, hp.matmul_bsplit_pair_plain(
                        a8_0, b8l, b, sa, sb, L, pm, **kw),
                        f"{name} a_src={src is not None} {tag}")
                    assert torch.equal(got[1], riders.kmajor(b8)), \
                        f"{name} {tag}: B"
            # the last panel into f32 rows: its residues and random ones
            a, b, sa, sb, a8, b8 = enc_ops["f32", "f32"]
            r_last = hm.matmul_mod_u8(
                riders.panel_rows(a8, last, pm).contiguous(), b8, L)
            for r in (r_last, r_rand):
                out = torch.zeros((m, n), dtype=torch.float32, device=DEVICE)
                hp.reconstruct_into(r, sa, sb, L, out, last, pm, "f32")
                ref = hp.reconstruct_into_plain(r, sa, sb, L,
                                                torch.zeros_like(out), last,
                                                pm, "f32")
                hold(errs, "reconstruct_into[f32]", out, ref,
                     f"reconstruct_into[f32] {tag}")
                assert not out[:last * pm].any(), f"{tag}: rows of no panel"
            del enc_ops
        log(f"  riders' f32 forms == plain at m={m} k={k} n={n} L={Ls} "
            f"panel_m={pm} (f32 special lines in every panel)")


def phase_rider_edges(errs):
    """Phases 3p/3r, the wgmma rider kernel's edges: at RIDER_EDGE_CASES,
    every (A word, output word) form of the rider step with both riders
    (out= given) and every (A word, B word) form of the pair against their
    plain versions, bit-equal, f64 and f32 special lines in every panel and
    in B's right half; the pair RIDER_REPEATS times, every run's outputs
    bit-equal to the first's."""
    words2 = (("f64", "f64"), ("f64", "f32"), ("f32", "f64"), ("f32", "f32"))
    for (m, k, n), Ls, pm in RIDER_EDGE_CASES:
        ops = rider_operands(m, k, n, pm, 11)
        last = m // pm - 1
        for L in Ls:
            tag = f"m={m} k={k} n={n} L={L} panel_m={pm}"
            for aw, bw in words2:
                a, b = ops[aw][0], ops[bw][1]
                sa = hk.fast_sft_plain(a, L, axis=1)
                sb = hk.fast_sft_plain(b, L, axis=0)
                a8 = hk.encode_slices(a, sa, L, axis=1)
                b8 = hk.encode_slices(b, sb, L, axis=0)
                a8_0 = riders.panel_rows(a8, 0, pm).contiguous()
                name = build.form("matmul_bsplit_pair", aw == "f32",
                                  bw == "f32")
                kw = dict(a_src=a, a_kind=aw, b_kind=bw)
                ref = hp.matmul_bsplit_pair_plain(a8_0, b8, b, sa, sb, L, pm,
                                                  **kw)
                first = None
                for run in range(RIDER_REPEATS):
                    got = hp.matmul_bsplit_pair(a8_0, b8, b, sa, sb, L, pm,
                                                **kw)
                    hold_all(errs, name, got, ref,
                             f"{name} run {run} {tag}")
                    if first is None:
                        first = got
                    else:
                        for x, y in zip(got, first):
                            assert torch.equal(x, y), \
                                f"{name} {tag}: run {run} differs"
                # the step on the B this pair wrote, its words (aw, ow)
                ow = bw
                name = build.form("matmul_rider_step", aw == "f32",
                                  ow == "f32")
                bt, r0 = first[1], first[0]
                out = torch.zeros((m, n), device=DEVICE,
                                  dtype=riders.KINDS[ow])
                skw = dict(a_src=a, next_panel=min(2, last), a_kind=aw,
                           out_kind=ow)
                args = (bt, 1, r0, 0, sa, sb, L, pm)
                for slices in (a8, riders.panel_rows(a8, 1, pm).contiguous()):
                    hold_all(errs, name,
                             hp.matmul_rider_step(slices, *args, out=out,
                                                  **skw),
                             hp.matmul_rider_step_plain(
                                 slices, *args, out=out.clone(), **skw),
                             f"{name} {tag}")
        log(f"  rider step and pair == plain at m={m} k={k} n={n} L={Ls} "
            f"panel_m={pm}, every word form (pair x{RIDER_REPEATS}, "
            "bit-equal runs)")


def pipeline_f32_calls(a, b, a32, b32, b32_wide):
    """Phase 4r's calls: (name, (A, B, moduli, fastmode, out_dtype,
    GEMMUL8_PIPELINE, extra arguments), launch counts)."""
    panels = N // PANEL_M
    step = build.form
    f32 = {"fast_sft[f32]": 2, "encode_slices[f32]": 2}
    rec32 = {"reconstruct_into[f32]": 1}
    cols = N_WIDE // N_PANEL
    return [
        ("f32 x f32 -> f32 fast PIPELINE=1", (a32, b32, L_F32, True, None,
                                              "1", {}),
         {**f32, step("matmul_rider_step", True, True): panels, **rec32}),
        ("f32 x f32 -> f32 fast PIPELINE=2", (a32, b32, L_F32, True, None,
                                              "2", {}),
         {**f32, step("matmul_rider_step", True, True): panels, **rec32}),
        ("f32 x f32 -> f32 fast PIPELINE=3", (a32, b32, L_F32, True, None,
                                              "3", {}),
         {**f32, step("matmul_bsplit_pair", True, True): 2,
          step("matmul_rider_step", True, True): panels - 1, **rec32}),
        ("f32 x f32 -> f32 accurate PIPELINE=1",
         (a32, b32, L_F32, False, None, "1", {}),
         {"emax[f32]": 2, "mag7[f32]": 2, "magmax_matmul": 1,
          "encode_slices[f32]": 2,
          step("matmul_rider_step", True, True): panels, **rec32}),
        ("f64 x f32 -> f64 fast PIPELINE=3", (a, b32, L_MAIN, True, None,
                                              "3", {}),
         {"fast_sft": 1, "fast_sft[f32]": 1, "encode_slices": 1,
          "encode_slices[f32]": 1, step("matmul_bsplit_pair", False, True): 2,
          "matmul_rider_step": panels - 1, "reconstruct_into": 1}),
        ("f32 x f64 -> f32 fast PIPELINE=2", (a32, b, L_F32, True, "f32",
                                              "2", {}),
         {"fast_sft": 1, "fast_sft[f32]": 1, "encode_slices": 1,
          "encode_slices[f32]": 1,
          step("matmul_rider_step", True, True): panels, **rec32}),
        ("f32 x f64 -> f64 fast PIPELINE=3", (a32, b, L_MAIN, True, None,
                                              "3", {}),
         {"fast_sft": 1, "fast_sft[f32]": 1, "encode_slices": 1,
          "encode_slices[f32]": 1, step("matmul_bsplit_pair", True, False): 2,
          step("matmul_rider_step", True, False): panels - 1,
          "reconstruct_into": 1}),
        ("f64 x f64 -> f32 fast PIPELINE=2", (a, b, L_F32, True, "f32", "2",
                                              {}),
         {"fast_sft": 2, "encode_slices": 2,
          step("matmul_rider_step", False, True): panels, **rec32}),
        (f"f32 x f32 -> f32 {N} x {N} x {N_WIDE} n_panel={N_PANEL} "
         "PIPELINE=1", (a32, b32_wide, L_F32, True, None, "1",
                        {"n_panel": N_PANEL}),
         {"fast_sft[f32]": 1 + cols, "encode_slices[f32]": 1 + cols,
          step("matmul_rider_step", True, True): cols * panels,
          "reconstruct_into[f32]": cols}),
    ]


def f32_pipe_gemm(args, pipe=None):
    """gemm on phase 4r's arguments under GEMMUL8_PIPELINE=pipe (default:
    the call's own level; "0" and no n_panel: its one-shot call)."""
    x, y, L, fastmode, out_dtype, level, kw = args
    if pipe == "0":
        kw = {}
    return under({"GEMMUL8_PIPELINE": level if pipe is None else pipe},
                 lambda: gt.gemm(x, y, num_moduli=L, fastmode=fastmode,
                                 out_dtype=out_dtype, device=DEVICE, **kw))


def phase_pipeline_f32(a, b, a32, b32, b_wide, launches):
    """Phase 4r: the f32, mixed and f32-output calls under GEMMUL8_PIPELINE
    1-3 and n_panel at N^3 (and N x N x N_WIDE), each held to its
    one-shot call's bits, with its launch counts and its peak of device
    memory beside the one-shot call's. Returns (the calls, the wide f32
    B)."""
    b32_wide = b_wide.float()
    calls = pipeline_f32_calls(a, b, a32, b32, b32_wide)
    for name, args, want in calls:
        ref, _, peak_ref = counted(lambda: f32_pipe_gemm(args, "0"))
        c, counts, peak = counted(lambda: f32_pipe_gemm(args))
        log(f"  launches in the {name} call: {counts}")
        assert counts == want, f"{name} launch counts {counts}"
        assert_bits_equal(c, ref, f"{name} vs its one-shot call")
        assert bool(torch.isfinite(c).all()), f"{name}: not finite"
        log(f"  {name} == one-shot call (bits, {c.dtype}), peak {peak} "
            f"bytes (one-shot {peak_ref})")
        for key, cnt in counts.items():
            if key in RIDER_F32_FORMS:
                launches[key] = launches.get(key, 0) + cnt
        del c, ref
    return calls, b32_wide


def rider_f32_setups(a, b, a32, b32):
    """Phase 5r: per form, (its moduli count, the kernel call, its plain
    version, the f64 form's call on the same panel) at the main path's
    shapes, panels of PANEL_M rows; the rider step with both riders."""
    pm = PANEL_M
    nxt = min(2, N // pm - 1)        # the panel the encode rider encodes
    src = {"f64": (a, b), "f32": (a32, b32)}
    memo = {}

    def prep(aw, bw, L):
        key = (aw, bw, L)
        if key not in memo:
            x, y = src[aw][0], src[bw][1]
            sa, sb = hk.fast_sft(x, L, 1), hk.fast_sft(y, L, 0)
            a8, b8 = hk.encode_slices(x, sa, L, 1), hk.encode_slices(
                y, sb, L, 0)
            bt = riders.kmajor(b8)
            r0 = hm.matmul_mod_u8(riders.panel_rows(a8, 0, pm).contiguous(),
                                  b8, L)
            b8l = hk.encode_slices(y, sb, L, 0, col_tiles=(0, N // 2 // 512))
            memo[key] = dict(x=x, y=y, sa=sa, sb=sb, bt=bt, r0=r0, b8l=b8l,
                             a8p=riders.panel_rows(a8, 1, pm).contiguous(),
                             a8_0=riders.panel_rows(a8, 0, pm).contiguous())
            del a8, b8
        return memo[key]

    def step(aw, ow, L, plain=False, as_f64=False):
        d = prep(aw, "f64", L)
        fn = hp.matmul_rider_step_plain if plain else hp.matmul_rider_step
        kind = "f64" if as_f64 else ow
        x = a if as_f64 else d["x"]
        out = torch.empty((N, N), dtype=riders.KINDS[kind], device=DEVICE)
        return lambda: fn(d["a8p"], d["bt"], 1, d["r0"], 0, d["sa"], d["sb"],
                          L, pm, a_src=x, next_panel=nxt, out=out,
                          a_kind="f64" if as_f64 else aw, out_kind=kind)

    def pair(aw, bw, L, plain=False, as_f64=False):
        d = prep(aw, bw, L)
        fn = hp.matmul_bsplit_pair_plain if plain else hp.matmul_bsplit_pair
        x, y = (a, b) if as_f64 else (d["x"], d["y"])
        return lambda: fn(d["a8_0"], d["b8l"], y, d["sa"], d["sb"], L, pm,
                          a_src=x, a_kind="f64" if as_f64 else aw,
                          b_kind="f64" if as_f64 else bw)

    def into(plain=False, as_f64=False):
        d = prep("f32", "f32", L_F32)
        fn = hp.reconstruct_into_plain if plain else hp.reconstruct_into
        kind = "f64" if as_f64 else "f32"
        out = torch.empty((N, N), dtype=riders.KINDS[kind], device=DEVICE)
        return lambda: (fn(d["r0"], d["sa"], d["sb"], L_F32, out,
                           N // pm - 1, pm, kind),)

    def library(aw, bw, L):
        # torch._int_mm x L over one panel's products (the step's and the
        # pair's both), on the form's own slices; bt is (L, n, k)
        d = prep(aw, bw, L)
        return int_mm(d["a8p"], d["bt"])

    setups = {}
    for aw, ow, L in (("f32", "f32", L_F32), ("f64", "f32", L_F32),
                      ("f32", "f64", L_MAIN)):
        setups[build.form("matmul_rider_step", aw == "f32", ow == "f32")] = (
            L, step(aw, ow, L), step(aw, ow, L, plain=True),
            step(aw, ow, L, as_f64=True), library(aw, "f64", L))
    for aw, bw, L in (("f32", "f32", L_F32), ("f64", "f32", L_MAIN),
                      ("f32", "f64", L_MAIN)):
        setups[build.form("matmul_bsplit_pair", aw == "f32", bw == "f32")] = (
            L, pair(aw, bw, L), pair(aw, bw, L, plain=True),
            pair(aw, bw, L, as_f64=True), library(aw, bw, L))
    setups["reconstruct_into[f32]"] = (L_F32, into(), into(plain=True),
                                       into(as_f64=True), None)
    return setups


def phase_pipeline_f32_times(a, b, a32, b32, calls, errs):
    """Phase 5r: each rider f32 form at the main path's shapes beside its
    f64 form on the same residues (PIPELINE_ROUNDS rotated rounds) and its
    plain version (the warm-up outputs held bit for bit); then each phase
    4r call beside its one-shot call, PIPELINE_ROUNDS rotated rounds.
    The GEMM forms are timed beside torch._int_mm over their own int8
    products in the same rotation. Returns ({form: (ms, f64 form ms, plain
    ms, moduli, library ms or None)}, {call: [ms]})."""
    kerns = {}
    for name, (L, kern, plain, f64_form, lib) in rider_f32_setups(
            a, b, a32, b32).items():
        got = kern()
        pms, ref = timed(plain, 1)
        if name == "reconstruct_into[f32]":
            rows = slice((N // PANEL_M - 1) * PANEL_M, N)
            got, ref = (got[0][rows],), (ref[0][rows],)
        hold_all(errs, name, got, ref, f"{name} at {N}^2, {L} moduli")
        del got, ref
        rotation = {name: kern, "f64 form": f64_form}
        if lib is not None:
            rotation[LIBRARY] = lib
        by_name, _ = timed_rounds(rotation, PIPELINE_ROUNDS, 5)
        kerns[name] = (float(np.median(by_name[name])),
                       float(np.median(by_name["f64 form"])), pms, L,
                       None if lib is None
                       else float(np.median(by_name[LIBRARY])))
        log(f"  {name} == plain at {N}^2 operands, panels of {PANEL_M}, "
            f"{L} moduli")
    timings = {}
    for name, args, _ in calls:
        timings[f"{name}: one-shot"] = lambda args=args: f32_pipe_gemm(
            args, "0")
        timings[name] = lambda args=args: f32_pipe_gemm(args)
    by_call, _ = timed_rounds(timings, PIPELINE_ROUNDS, 2)
    return kerns, by_call


def phase_batched_timed(a, b, a32, A64, B64):
    """Phase 4b: gemm_batched on a batch of 2 N^3 products, f64 fast at 14
    moduli ((A, B) and (B, A)) and complex64 at 8 ((A64, B64) and (B64,
    A64)), each element bit-equal to gemm on it, with the launch counts;
    gemm_timed at N^3, f64 fast at 14 moduli and f32 at 8: gemm's bits,
    four phase times each >= 0, the mod phase under 1% of their sum.
    Returns ({call: (batched fn, single fns)}, {call: times})."""
    batches = {
        f"f64 fast, {L_MAIN} moduli": (
            torch.stack([a, b]), torch.stack([b, a]),
            dict(num_moduli=L_MAIN),
            {"fast_sft": 4, "encode_slices": 4, "matmul_mod_u8": 2,
             "reconstruct": 2}),
        f"complex64 fast, {L_F32} moduli": (
            torch.stack([A64, B64]), torch.stack([B64, A64]),
            dict(num_moduli=L_F32),
            {"fast_stats[f32]": 8, "encode_slices[f32]": 8,
             "matmul_complex_mod": 2, "reconstruct[f32]": 4})}
    calls = {}
    for name, (xs, ys, kw, want) in batches.items():
        c, counts, peak = counted(lambda: gt.gemm_batched(xs, ys,
                                                          device=DEVICE,
                                                          **kw))
        log(f"  launches in the batched {name} call (2 x {N}^3): {counts}")
        assert counts == want, f"batched {name} launch counts {counts}"
        assert c.shape == (2, N, N)
        for i in range(2):
            one = gt.gemm(xs[i], ys[i], device=DEVICE, **kw)
            ok = c.dtype == one.dtype and torch.equal(
                cwords(c[i]) if c.is_complex() else words(c[i]),
                cwords(one) if one.is_complex() else words(one))
            assert ok, f"batched {name}: element {i} is not gemm's bits"
            del one
        log(f"  gemm_batched {name}, 2 x {N}^3: each element == gemm on it "
            f"(bits, {c.dtype}), peak {peak} bytes")
        del c
        calls[f"gemm_batched {name} (2 elements)"] = (
            lambda xs=xs, ys=ys, kw=kw: gt.gemm_batched(xs, ys,
                                                        device=DEVICE, **kw),
            [lambda x=xs[i], y=ys[i], kw=kw: gt.gemm(x, y, device=DEVICE,
                                                     **kw)
             for i in range(2)])
    times = {}
    for name, x, y, L in ((f"f64 fast, {L_MAIN} moduli", a, b, L_MAIN),
                          (f"f32 fast, {L_F32} moduli", a32, a32.t(),
                           L_F32)):
        y = y.contiguous()
        c, t = gt.gemm_timed(x, y, num_moduli=L, iters=3)
        assert len(t) == 4 and all(isinstance(v, float) and v >= 0.0
                                   for v in t), f"gemm_timed {name}: {t}"
        assert t[2] < 0.01 * sum(t), f"gemm_timed {name}: mod phase {t}"
        assert_bits_equal(c, gt.gemm(x, y, num_moduli=L, device=DEVICE),
                          f"gemm_timed {name} vs gemm")
        c2, t2 = gt.gemm(x, y, num_moduli=L, return_times=True)
        assert_bits_equal(c2, c, f"gemm(return_times=True) {name}")
        times[name] = (t, (x, y, L))
        log(f"  gemm_timed {name} at {N}^3 == gemm (bits); "
            f"gemm(return_times=True) too")
        del c, c2
    return calls, times


def phase_batched_timed_times(calls, times):
    """Phase 5b: each batched call beside the single calls of its elements
    (PIPELINE_ROUNDS rotated rounds); each timed call's phases (iters=5)
    beside the fused call's median. Returns ({call: (ms per element,
    single ms)}, {call: (phases s, fused ms)})."""
    batched = {}
    for name, (fn, singles) in calls.items():
        by_name, _ = timed_rounds(
            {name: fn, "the two single calls": lambda s=singles: [
                f() for f in s]}, PIPELINE_ROUNDS, 1)
        batched[name] = (float(np.median(by_name[name])) / 2,
                         float(np.median(by_name["the two single calls"]))
                         / 2)
    phases = {}
    for name, (_, (x, y, L)) in times.items():
        _, t = gt.gemm_timed(x, y, num_moduli=L, iters=5)
        assert all(v >= 0.0 for v in t) and t[2] < 0.01 * sum(t)
        by_name, _ = timed_rounds({"fused": lambda: gt.gemm(
            x, y, num_moduli=L, device=DEVICE)}, PIPELINE_ROUNDS, 2)
        phases[name] = (t, float(np.median(by_name["fused"])))
    return batched, phases


# ---- the probes (B16): phases 3q, 4q, 5q ----------------------------------

def phase_probe_kernels(errs):
    """Phase 3q: each probe kernel against its plain version, bit for bit
    (launches not counted)."""
    x = torch.from_numpy(pclz.edge_words()).to(DEVICE)
    hold(errs, "probe_clz", hq.clz(x), hq.clz_plain(x), "clz edge words")
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, PROBE_CLZ_WORDS,
                                      dtype=np.int32)).to(DEVICE)
    hold(errs, "probe_clz", hq.clz(x), hq.clz_plain(x), "clz random words")
    x = torch.from_numpy(pclz.limb_words(PROBE_CLZ_WORDS)).to(DEVICE)
    hold(errs, "probe_clz", hq.clz(x, "exp"), hq.clz_plain(x),
         "clz exponent form on limbs")
    log(f"  clz == plain: edge words, {PROBE_CLZ_WORDS} random words, the "
        "exponent form on as many limbs")
    for case, v in pvpu.inputs().items():
        v = torch.from_numpy(v).to(DEVICE)
        hold(errs, "probe_vpu_ops", hq.vpu_chain(v, case, PROBE_STEPS_CHECK),
             hq.vpu_chain_plain(v, case, PROBE_STEPS_CHECK), f"chain {case}")
    log(f"  the nine op chains == plain at STEPS {PROBE_STEPS_CHECK}")
    for variant in pmxu.VARIANTS:
        for L in (2, 8, 14, 20):
            for bm in (8, 16):
                for n in (1024, 1000):
                    r = torch.from_numpy(pmxu.make_input(
                        variant, L, bm, 1024, n, seed=L + bm)).to(DEVICE)
                    hold(errs, "probe_mxu_crt", hq.mxu_crt(r, L, bm, variant),
                         hq.mxu_crt_plain(r, L, bm, variant),
                         f"mxu_crt {variant} L={L} bm={bm} n={n}")
    log("  mxu_crt == plain: 4 variants x L 2, 8, 14, 20 x bm 8, 16, m = "
        "1024, n = 1024 and 1000")
    L = L_MAIN
    for n in (PROBE_N_SMALL, PROBE_N_CHECK):
        rng = np.random.default_rng(12)
        a8, b8 = (torch.from_numpy(rng.integers(-128, 128, (L, n, n),
                                                dtype=np.int8)).to(DEVICE)
                  for _ in range(2))
        res = hm.matmul_mod_u8(a8, b8, L)
        for variant in pdd.VARIANTS:
            r = pdd.make_rider(variant, n, L)
            rin = None if r is None else torch.from_numpy(r).to(DEVICE)
            nops = 16 if variant in pdd.CHAIN else 0
            got = hq.deaddep(a8, b8, L, nops, variant, rin)
            hold_all(errs, "probe_deaddep", got,
                     hq.deaddep_plain(a8, b8, L, nops, variant, rin),
                     f"deaddep {variant} at n={n}")
            assert torch.equal(got[0], res), f"deaddep {variant}: residues"
        log(f"  deaddep == plain, every variant at n={n}, {L} moduli: "
            "residues == matmul_mod_u8's, hbmio's words, the rec riders' "
            "f64 words == plain reconstruct with shifts 0")
        del a8, b8, res
    build.LAUNCHES.clear()


def probe_main_calls():
    """Phase 4q's calls: the probes' entry point with each script's
    defaults (deaddep with the -1 and -2 riders too)."""
    return [["clz"], ["vpu_ops"], ["mxu_crt"],
            ["deaddep", str(N), str(L_MAIN), "0", "16", "32", "-1", "-2"]]


def phase_probes(launches):
    """Phase 4q: the probes' main path, `python -m gemmul8_tpu_torch.probes`
    with each script's defaults, each call with the launch counts reset
    just before it and read just after: every variant it runs launched."""
    for argv in probe_main_calls():
        out, counts, _ = counted(lambda a=argv: probes_main(a))
        log(f"  probes {' '.join(argv)}: launches {counts}")
        name = f"probe_{argv[0]}"
        want = {"clz": [f"clz[{f}]" for f in pclz.FORMS],
                "vpu_ops": [f"vpu_ops[{c}]" for c in pvpu.CASES],
                "mxu_crt": ["mxu_crt[full]"],
                "deaddep": [f"deaddep[{v}]" for v in pdd.VARIANTS]}[argv[0]]
        for key in want:
            assert counts.get(f"probe_{key}", 0) > 0, f"{key} not launched"
        assert set(counts) == {f"probe_{k}" for k in want}, counts
        launches[name] = sum(counts.values())
        if argv[0] == "clz":
            assert out["correct"], "clz probe disagrees with its plain version"
        assert all(np.isfinite(v) and v > 0 for v in out.values()
                   if not isinstance(v, bool)), out


def timed_pairs(fx, fy, pairs):
    """ms of fx minus ms of fy over pairs of adjacent calls, the order
    alternating from pair to pair (each call timed alone, after a
    warm-up call of each)."""
    fx(), fy()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    out = []
    for i in range(pairs):
        ms = {}
        for which, f in ((("x", fx), ("y", fy)) if i % 2 == 0
                         else (("y", fy), ("x", fx))):
            start.record()
            f()
            stop.record()
            torch.cuda.synchronize()
            ms[which] = start.elapsed_time(stop)
        out.append(ms["x"] - ms["y"])
    return out


def spread_ms(d):
    """'median [least, most]' of differences d (ms)."""
    return (f"{float(np.median(d)):+.3f} [{float(np.min(d)):+.3f}, "
            f"{float(np.max(d)):+.3f}]")


@functools.lru_cache(maxsize=None)
def library_sass():
    """cuobjdump -sass of the built library, taken once a run."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(build.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def sass_counts():
    """{kernel name: Counter of opcodes} of the chain kernels
    (gm8_vpu_<case>), from cuobjdump -sass of the built library."""
    out, cur = {}, None
    for line in library_sass().splitlines():
        if "Function :" in line:
            name = re.search(r"Function : (\S+)", line).group(1)
            cur = name if name.startswith("gm8_vpu_") else None
            if cur:
                out[cur] = collections.Counter()
            continue
        if cur is None:     # only the chains' instructions are counted
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                      line)
        if m:
            out[cur][m.group(1)] += 1
    return out


# the main-path instances of the two kernels redesigned on the tensor cores
# (f64 words, up to 16 moduli; int8 residues, f64 output, 4-word tail), by
# a part of their mangled names
MMA_SASS = {"encode_slices": "encode_kernelIyLi1E",
            "reconstruct": "reconstruct_kernelILi1EyLi4E"}
SASS_CLASSES = {"IMMA": ("IMMA",), "LDSM/LDS": ("LDSM", "LDS"),
                "STS": ("STS",), "LDG": ("LDG",), "STG": ("STG",),
                "IMAD": ("IMAD",), "f64 and conversions": (
                    "DADD", "DMUL", "DFMA", "DSETP", "I2F", "F2I", "FRND"),
                "BRA/BSSY/BSYNC": ("BRA", "BSSY", "BSYNC")}


def mma_loop_sass():
    """{kernel: [(instructions, {class: count}), ...]} of the loops (a
    backward branch and what it spans) of the MMA_SASS instances, from
    cuobjdump -sass of the built library, outermost first. Static counts:
    a branch's both sides are counted, rare paths (ragged edges, the
    tail's near-tie fix) included."""
    code, cur = {}, None
    for line in library_sass().splitlines():
        if "Function :" in line:
            name = re.search(r"Function : (\S+)", line).group(1)
            cur = next((k for k, part in MMA_SASS.items() if part in name),
                       None)
            if cur:
                code[cur] = []
            continue
        if cur is None:     # only the MMA_SASS instances are read
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)\S*(.*)", line)
        if m:
            code[cur].append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = {}
    for name, ins in code.items():
        loops = []
        for addr, op, rest in ins:
            t = (re.search(r"0x([0-9a-f]+)", rest.split(";")[0])
                 if op == "BRA" else None)
            if t and int(t.group(1), 16) < addr:
                body = [o for a, o, _ in ins if int(t.group(1), 16) <= a
                        <= addr]
                loops.append((len(body), {
                    cls: sum(o in ops for o in body)
                    for cls, ops in SASS_CLASSES.items()}))
        out[name] = sorted(loops, key=lambda x: -x[0])
    return out


def chain_bound_ms(case, clock_mhz, steps=pvpu.STEPS):
    """The least time of one chain call: its instructions a rep
    (VPU_MIX) at the CUDA C++ Programming Guide's compute capability 9.0
    rates a clock an SM (VPU_RATE), the slowest class or the issue of 128
    a clock an SM, whichever is larger, x 132 SMs x the SM clock."""
    mix = VPU_MIX[case]
    per_rep = max(max(cnt / VPU_RATE[c] for c, cnt in mix.items()),
                  sum(mix.values()) / 128)
    clocks = pvpu.ops(steps) * per_rep / SMS
    return clocks / (clock_mhz * 1e6) * 1e3


def phase_probe_times(errs):
    """Phase 5q: times at the probes' own sizes, medians of rotated
    rounds; returns ({name: (ms, plain ms)}, {name: bound}, {name:
    library ms})."""
    times, bounds, library = {}, {}, {}
    marks = [("start", time.perf_counter())]
    # clz: both forms on the timing words, beside the plain version
    x = torch.from_numpy(pclz.limb_words(pclz.N_TIME)).to(DEVICE)
    by, _ = timed_rounds({f: (lambda f=f: hq.clz(x, f)) for f in pclz.FORMS},
                         PROBE_ROUNDS, 10)
    pms, ref = timed(lambda: hq.clz_plain(x), 2)
    for f in pclz.FORMS:
        hold(errs, "probe_clz", hq.clz(x, f), ref, f"clz {f} at 2^26")
    med = {f: float(np.median(v)) for f, v in by.items()}
    b = bound(8 * pclz.N_TIME)
    log(f"  clz on {pclz.N_TIME} limb words: __clz median {med['clz']:.4f} "
        f"ms, f32-exponent trick {med['exp']:.4f} ms (rounds "
        f"{', '.join(f'{t:.4f}' for t in by['clz'])} / "
        f"{', '.join(f'{t:.4f}' for t in by['exp'])}); plain {pms:.3f} ms; "
        f"bound {b[0]:.4f} ms ({b[1]})")
    times["probe_clz"], bounds["probe_clz"] = (med["clz"], pms), b
    marks.append(("clz", time.perf_counter()))
    # the nine chains at STEPS 2048, the SM clock sampled meanwhile
    xs = {c: torch.from_numpy(v).to(DEVICE) for c, v in pvpu.inputs().items()}
    with ClockSampler() as clock:
        by, _ = timed_rounds({c: (lambda c=c: hq.vpu_chain(xs[c], c))
                              for c in pvpu.CASES}, PROBE_ROUNDS, 40)
    mhz = float(np.median(clock.mhz)) if clock.mhz else float("nan")
    sass = sass_counts()
    ms_sum = pms_sum = b_sum = 0.0
    for c in pvpu.CASES:
        ms = float(np.median(by[c]))
        pms, ref = timed(lambda c=c: hq.vpu_chain_plain(xs[c], c), 1)
        hold(errs, "probe_vpu_ops", hq.vpu_chain(xs[c], c), ref,
             f"chain {c} at STEPS {pvpu.STEPS}")
        name = "gm8_vpu_" + VPU_KERNEL[c]
        ops = {op: n for op, n in sass[name].items() if op in VPU_OPCODES}
        bms = chain_bound_ms(c, mhz)
        log(f"  {c:14s}: median {ms:.3f} ms, {pvpu.ops() / ms / 1e9:.2f} T "
            f"op/s (JAX count); SASS of {name} {ops} (16 reps a step); "
            f"bound {bms:.3f} ms at {mhz:.0f} MHz ({VPU_MIX[c]} a rep); "
            f"plain {pms:.1f} ms")
        ms_sum, pms_sum, b_sum = ms_sum + ms, pms_sum + pms, b_sum + bms
        del ref
    log(f"  SM clock during the chains: median {mhz:.0f} MHz over "
        f"{len(clock.mhz)} samples (min {min(clock.mhz, default=0):.0f}, "
        f"max {max(clock.mhz, default=0):.0f})")
    times["probe_vpu_ops"] = (ms_sum, pms_sum)
    bounds["probe_vpu_ops"] = (b_sum, "operations")
    del xs
    marks.append(("chains", time.perf_counter()))
    # the CRT contraction: four variants at the script's defaults
    variant, bm, _, L, m, n = pmxu.DEFAULTS
    rs = {v: torch.from_numpy(pmxu.make_input(v, L, bm, m, n)).to(DEVICE)
          for v in pmxu.VARIANTS}
    calls = {v: (lambda v=v: hq.mxu_crt(rs[v], L, bm, v))
             for v in pmxu.VARIANTS}
    zeros_a = torch.zeros((m, 1), dtype=torch.int32, device=DEVICE)
    zeros_b = torch.zeros((1, n), dtype=torch.int32, device=DEVICE)
    calls["reconstruct (same residues)"] = lambda: hk.reconstruct(
        rs["full"], zeros_a, zeros_b, L)
    wp = torch.from_numpy(rec.crt_mxu_consts(L, bm)[0]).to(DEVICE)
    rp = pmxu.centered_planes(rs["full"], L, 1, "full").reshape(
        L, m // bm, bm, n).permute(0, 2, 1, 3).reshape(L * bm, -1)
    # B column-major, made untimed: cuBLASLt's int8 kernels take B so, and
    # row-major B ran 5x slower on the H100
    rp = rp.t().contiguous().t()
    calls["torch._int_mm W' x R"] = lambda: torch._int_mm(wp, rp)
    by, _ = timed_rounds(calls, PROBE_ROUNDS, 5)
    b = bound(pmxu.bytes_moved(L, m, n))
    for v in pmxu.VARIANTS:
        pms, ref = timed(lambda v=v: hq.mxu_crt_plain(rs[v], L, bm, v), 1)
        hold(errs, "probe_mxu_crt", hq.mxu_crt(rs[v], L, bm, v), ref,
             f"mxu_crt {v} at {m}x{n}")
        del ref
        ms = float(np.median(by[v]))
        log(f"  mxu_crt {v} ({m}x{n}, L={L}, bm={bm}): median {ms:.3f} ms "
            f"(rounds {', '.join(f'{t:.3f}' for t in by[v])}); plain "
            f"{pms:.3f} ms; bound {b[0]:.3f} ms ({b[1]})")
        if v == variant:
            times["probe_mxu_crt"], bounds["probe_mxu_crt"] = (ms, pms), b
    for label in list(calls)[len(pmxu.VARIANTS):]:
        log(f"  {label}: median {float(np.median(by[label])):.3f} ms")
    library["probe_mxu_crt"] = float(np.median(by["torch._int_mm W' x R"]))
    del rs, rp, calls
    marks.append(("mxu_crt", time.perf_counter()))
    # integer work inside the GEMM's block at the script's size
    n, L = N, L_MAIN
    rng = np.random.default_rng(0)
    a8, b8 = (torch.from_numpy(rng.integers(-128, 128, (L, n, n),
                                            dtype=np.int8)).to(DEVICE)
              for _ in range(2))
    riders = {v: pdd.make_rider(v, n, L) for v in pdd.VARIANTS}
    riders = {v: None if r is None else torch.from_numpy(r).to(DEVICE)
              for v, r in riders.items()}
    configs = [("base", 0)] + [(v, k) for k in (0, 16, 32)
                               for v in pdd.CHAIN] + [("recbody", 0),
                                                      ("recmxu", 0)]
    calls = {f"{v} nops={k}": (lambda v=v, k=k: hq.deaddep(
        a8, b8, L, k, v, riders[v])) for v, k in configs}
    # each config's median over rotated rounds; its differences to base,
    # for a chain to the same variant at nops 0 (its scratch and aux
    # without the chain), for recmxu to recbody, from adjacent pairs of
    # calls: the card's clock
    # drifts at its power cap, and a round of 18 calls spans 0.5 s. base
    # against itself gives the pairs' own spread.
    refs = {}
    for label, (v, k) in zip(calls, configs):
        refs[label] = [("base", "base nops=0")]
        if k:
            refs[label].append(("nops 0", f"{v} nops=0"))
        if v == "recmxu":
            refs[label].append(("recbody", "recbody nops=0"))
    # the library call over the same int8 products (torch._int_mm x L)
    # and matmul_mod_u8 (base's GEMM alone), in the configs' rotation (not
    # among the configs)
    b8t = b8.transpose(1, 2).contiguous()   # column-major B, untimed
    with ClockSampler() as clock:
        by, _ = timed_rounds({**calls,
                              "matmul_mod_u8": lambda: hm.matmul_mod_u8(
                                  a8, b8, L),
                              LIBRARY: int_mm(a8, b8t)},
                             PROBE_DEADDEP_ROUNDS, 2)
        diffs = {label: [(what, timed_pairs(calls[label], calls[ref],
                                            PROBE_DEADDEP_PAIRS))
                         for what, ref in refs[label]] for label in calls}
    mhz = float(np.median(clock.mhz)) if clock.mhz else float("nan")
    # the same work in SM clock cycles, which the clock's swings leave
    # alone: each config's launch span (probes.deaddep.sm_cycles), median
    # of PROBE_DEADDEP_STAMPED calls
    stamps = torch.empty((pdd.tiles(n, L), 3), dtype=torch.int64,
                         device=DEVICE)
    cyc = {}
    for label, (v, k) in zip(calls, configs):
        spans = []
        for _ in range(PROBE_DEADDEP_STAMPED):
            hq.deaddep(a8, b8, L, k, v, riders[v], stamps=stamps)
            spans.append(pdd.sm_cycles(stamps))
        cyc[label] = np.array(spans) / 1e3
    for label, (v, k) in zip(calls, configs):
        spread = "; ".join(f"{spread_ms(d)} over {what}"
                           for what, d in diffs[label])
        imads = pdd.injected_ops(n, L, k, v) // 2
        serial = imads / (64 * SMS * mhz * 1e6) * 1e3
        kc = float(np.median(cyc[label]))
        dk = "; ".join(f"{kc - float(np.median(cyc[ref])):+.1f} over {what}"
                       for what, ref in refs[label])
        serial_kc = imads / (64 * SMS) / 1e3
        share = ""
        if k:   # the span over the same variant's nops 0, of serial time
            over = kc - float(np.median(cyc[f"{v} nops=0"]))
            share = f"; {over / serial_kc:.3f} of its serial time"
        log(f"  deaddep {label:17s}: median {float(np.median(by[label])):.3f}"
            f" ms; {spread}; span {kc:.1f} [{cyc[label].min():.1f}, "
            f"{cyc[label].max():.1f}] kcycles ({dk}); injected "
            f"{imads} multiply-adds, serial {serial:.3f} ms at 64 a clock "
            f"an SM, {mhz:.0f} MHz, {serial_kc:.1f} kcycles{share}")
    log(f"  (medians over {PROBE_DEADDEP_ROUNDS} rotated rounds; a "
        f"difference: median [least, most] over {PROBE_DEADDEP_PAIRS} "
        "adjacent pairs; a span: SM clock cycles of the launch, median "
        f"[least, most] of {PROBE_DEADDEP_STAMPED} calls; rounds by config: "
        + "; ".join(
            f"{label} {', '.join(f'{t:.3f}' for t in by[label])}"
            for label in calls) + ")")
    for label, (v, k) in zip(calls, configs):
        pms, ref = timed(lambda v=v, k=k: hq.deaddep_plain(
            a8, b8, L, k, v, riders[v]), 1)
        hold_all(errs, "probe_deaddep", hq.deaddep(a8, b8, L, k, v,
                                                   riders[v]),
                 ref, f"deaddep {label} at n={n}")
        del ref
        if label == "deaddep nops=16":
            times["probe_deaddep"] = (float(np.median(by[label])), pms)
    log(f"  deaddep == plain at n={n}, {L} moduli, every config above: "
        "residues, aux, hbmio's words, the rec riders' f64 words")
    del b8t
    library["probe_deaddep"] = float(np.median(by[LIBRARY]))
    base_ms = float(np.median(by["base nops=0"]))
    mm_ms = float(np.median(by["matmul_mod_u8"]))
    log(f"  deaddep beside {LIBRARY} (x {L} torch._int_mm, in the configs' "
        f"rotation) median {library['probe_deaddep']:.3f} ms: base nops=0 "
        f"ratio {base_ms / library['probe_deaddep']:.3f}"
        f", deaddep nops=16 ratio "
        f"{times['probe_deaddep'][0] / library['probe_deaddep']:.3f}; base "
        f"{base_ms:.3f} ms beside matmul_mod_u8 {mm_ms:.3f} ms in the same "
        f"rotation (rounds "
        f"{', '.join(f'{t:.3f}' for t in by['matmul_mod_u8'])}): ratio "
        f"{base_ms / mm_ms:.3f}")
    bounds["probe_deaddep"] = bound(2 * L * n * n + L * n * n,
                                    L * 2 * n ** 3)
    log(f"  deaddep nops=16 plain {times['probe_deaddep'][1]:.1f} ms; bound "
        f"{bounds['probe_deaddep'][0]:.3f} ms "
        f"({bounds['probe_deaddep'][1]}); SM clock median {mhz:.0f} MHz")
    marks.append(("deaddep", time.perf_counter()))
    log("  phase 5q's parts, wall s: " + ", ".join(
        f"{label} {t - t_prev:.1f}" for (_, t_prev), (label, t)
        in zip(marks, marks[1:])))
    return times, bounds, library


def kernel_bounds_riders(L_of):
    """bound() of each rider f32 form's phase-5r work, as kernel_bounds
    counts the f64 forms, with each source word read as 8 or 4 bytes and
    each output word written as 8 or 4; L_of: the form's moduli count."""
    pm, k, n = PANEL_M, N, N
    out = {}
    for aw, ow in ((4, 4), (8, 4), (4, 8)):
        name = build.form("matmul_rider_step", aw == 4, ow == 4)
        L = L_of[name]
        out[name] = bound(
            L * (pm * k + k * n + pm * n) + L * pm * n + ow * pm * n
            + aw * pm * k + L * pm * k + 4 * (3 * pm + n),
            L * 2 * pm * n * k)
    for aw, bw in ((4, 4), (8, 4), (4, 8)):
        name = build.form("matmul_bsplit_pair", aw == 4, bw == 4)
        L = L_of[name]
        out[name] = bound(
            L * pm * k + L * k * (n // 2) + bw * k * (n // 2) + L * pm * n
            + L * k * n + aw * pm * k + L * pm * k + 4 * (2 * pm + n),
            L * 2 * pm * n * k)
    L = L_of["reconstruct_into[f32]"]
    out["reconstruct_into[f32]"] = bound(L * pm * n + 4 * (pm + n)
                                         + 4 * pm * n)
    return out


def kernel_bounds_c64(L):
    """bound() of each phase-5x measurement at N^2, L moduli, as
    kernel_bounds counts (each input read once, each output written once):
    the statistics on four f32 parts (emax int64, nrm2 f32, flag bool per
    line), the fused kernels on A's rows and B's columns, the f32-output
    matmul_reconstruct; and two bounds of earlier rows, the statistics mode
    on four f64 parts and the Karatsuba complex GEMM (3 products of L
    moduli)."""
    x, s = 2 * N * N, 8 * N
    ops = 2 * N ** 3
    return {"fast_stats[f32]": bound(4 * (4 * N * N + 13 * N)),
            "fast_encode_fused[f32]": bound(4 * x + L * x + s),
            "mag7_fused[f32]": bound(4 * x + x + s),
            "matmul_reconstruct[f32]": bound(L * x + s + 4 * N * N, L * ops),
            "fast_stats (f64 parts)": bound(4 * (8 * N * N + 13 * N)),
            "matmul_complex_mod Karatsuba": bound(
                3 * L_MAIN * x + 2 * L_MAIN * N * N, 3 * L_MAIN * ops)}


def kernel_bounds_f32(a32, b32, L):
    """bound() of each f32 form's phase-5f work (both operands where the
    path runs it twice), as kernel_bounds counts: f32 elements read as 4
    bytes; reconstruct's f32 output written as 4."""
    m, k = a32.shape
    n = b32.shape[1]
    x = a32.numel() + b32.numel()
    s = 4 * (m + n)
    return {"fast_sft[f32]": bound(4 * x + s),
            "encode_slices[f32]": bound(4 * x + s + L * x),
            "emax[f32]": bound(4 * x + s),
            "mag7[f32]": bound(4 * x + s + x),
            "reconstruct[f32]": bound(L * m * n + s + 4 * m * n)}


def bound(nbytes, ops=0):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of nbytes of device memory at HBM_BYTES_PER_S and ops int8
    tensor-core operations at INT8_OPS_PER_S."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_half_lines(timing, name, pair, a, b):
    """Phase 5v's lines for a fused statistics kernel: each half (A's
    rows, B's columns) as a share of its read-once bound (and, for B's
    encode, of the read-twice bound: its strips are read again to encode),
    beside the pair's time for the same half and the rotation's SM clock.
    timing: phase_variant_times' (medians by label, plain ms, clock)."""
    by_label, _, clock = timing
    lines = []
    for half, (rows, kdim) in (("A rows", tuple(a.shape)),
                               ("B columns", tuple(b.shape)[::-1])):
        ms = float(np.median(by_label[f"{name} {half}"]))
        pms = float(np.median(by_label[f"{pair} {half}"]))
        x = rows * kdim
        out = L_MAIN * x if name == "fast_encode_fused" else \
            rows * (-(-kdim // 16) * 16)
        once = bound(8 * x + out + 4 * rows)[0]
        line = (f"  {name} {half}: median {ms:.3f} ms; share of its "
                f"read-once bound {once:.3f} ms {once / ms:.3f}")
        if name == "fast_encode_fused" and half == "B columns":
            twice = bound(16 * x + out + 4 * rows)[0]
            line += (f", of the read-twice bound {twice:.3f} ms "
                     f"{twice / ms:.3f}")
        lines.append(line + f"; {pair} {half} {pms:.3f} ms, ratio "
                     f"{ms / pms:.3f} in one rotation; {clock}")
    return lines


def sft_half_lines(name, kern, a_parts, b_parts):
    """The halves of fast_sft (name "fast_sft") or of its statistics mode
    ("fast_stats") at the main path's shapes: A's rows and B's columns,
    each over its parts (kern(x, axis) on each), timed apart beside emax
    on the same parts in one rotation (HALF_ROUNDS rounds, head started,
    the SM clock and power draw sampled), each as a share of its read-once
    bound: every word read once, every line's outputs written once."""
    halves = (("A rows", a_parts, 1), ("B columns", b_parts, 0))
    calls = {}
    for half, parts, axis in halves:
        calls[f"{name} {half}"] = (
            lambda p=parts, ax=axis: [kern(x, ax) for x in p])
        calls[f"emax {half}"] = (
            lambda p=parts, ax=axis: [hk.emax(x, ax) for x in p])
    with ClockSampler() as clock:
        by_name, _ = timed_rounds(calls, HALF_ROUNDS, HALF_REPS,
                                  head_start=True)
    lines = []
    for half, parts, axis in halves:
        x = parts[0]
        rows = x.shape[1 - axis]
        word = "f64" if x.dtype == torch.float64 else "f32"
        got = {}
        for k in (name, "emax"):
            ms = float(np.median(by_name[f"{k} {half}"]))
            lim = bound(len(parts) * (x.element_size() * x.numel()
                                      + LINE_OUT_BYTES[k] * rows))[0]
            got[k] = (ms, lim)
        (ms, lim), (ems, elim) = got[name], got["emax"]
        lines.append(
            f"  {name} {half} ({word}, {len(parts)} x {x.shape[0]} x "
            f"{x.shape[1]}): median {ms:.4f} ms; share of its read-once "
            f"bound {lim:.4f} ms {lim / ms:.3f}; emax {half} {ems:.4f} ms, "
            f"share {elim / ems:.3f}; ratio to emax {ms / ems:.3f} in one "
            f"rotation; {clock.summary()} ({card_line()})")
    return lines


def kernel_bounds(a, b, L):
    """bound() of each kernel's phase-5 work on a (m, k) and b (k, n), each
    input read once and each output written once: both operands where the
    path runs the kernel twice; the complex GEMM in its 4-dot form on parts
    of these shapes. Integer and f32 ALU work is not counted (no published
    peak; it is below the byte bound of these kernels)."""
    m, k = a.shape
    n = b.shape[1]
    pm = PANEL_M                     # the pipeline's kernels: one panel
    x = a.numel() + b.numel()        # f64 elements of both operands
    s = 4 * (m + n)                  # int32 shifts, exponents or maxima
    ops = 2 * m * n * k              # int8 operations of one product
    slices = L * (m * k + k * n)     # int8 residues of both operands
    return {
        "fast_sft": bound(8 * x + s),
        "encode_slices": bound(8 * x + s + L * x),
        "matmul_mod_u8": bound(slices + L * m * n, L * ops),
        "reconstruct": bound(L * m * n + s + 8 * m * n),
        "emax": bound(8 * x + s),
        "mag7": bound(8 * x + s + x),
        "magmax_matmul": bound(x + s, ops),
        "matmul_complex_mod": bound(2 * slices + 2 * L * m * n, 4 * L * ops),
        "fast_encode_fused": bound(8 * x + L * x + s),
        "mag7_fused": bound(8 * x + x + s),
        "magmax_matmul_scratch": bound(x + s, ops),
        "matmul_mod_u8_pipelined": bound(slices + L * m * n, L * ops),
        "matmul_crt": bound(slices + 4 * tables.num_limbs(L) * m * n,
                            L * ops),
        "matmul_reconstruct": bound(slices + s + 8 * m * n, L * ops),
        # not a kernel of its own: reconstruct on its limb input
        "reconstruct (limbs)": bound(4 * tables.num_limbs(L) * m * n + s
                                     + 8 * m * n),
        # both riders: A's panel slices, B, the previous panel's residues,
        # the next panel's f64 rows and the shifts read; the residues, the
        # previous panel's f64 rows and the next panel's slices written
        "matmul_rider_step": bound(
            L * (pm * k + k * n + pm * n) + L * pm * n + 8 * pm * n
            + 8 * pm * k + L * pm * k + 4 * (3 * pm + n), L * 2 * pm * n * k),
        # with the A-panel-1 rider: panel 0's slices, B's left-half slices
        # and B's right half in f64 read; the residues, all of B's slices
        # (K-major) and A-panel 1's slices written
        "matmul_bsplit_pair": bound(
            L * pm * k + L * k * (n // 2) + 8 * k * (n // 2) + L * pm * n
            + L * k * n + 8 * pm * k + L * pm * k + 4 * (2 * pm + n),
            L * 2 * pm * n * k),
        "reconstruct_into": bound(L * pm * n + 4 * (pm + n) + 8 * pm * n),
    }


# The comparison harness and its baselines (phases 3h, 4h, 5h)
OSI_CASES = [((2048, 2048, 2048), (8, 9), False),
             ((1000, 777, 1500), (3, 8, 13), True)]
OSI_COMPLEX = ((300, 130, 200), 9)
# tests/test_scale_bands.py's GH200 bands and rule: accuracy_sweep's copy
REF_FAST, REF_ACCU = accuracy_sweep.REF_FAST, accuracy_sweep.REF_ACCU
SCALE_M, SCALE_K = accuracy_sweep.BAND_M, accuracy_sweep.BAND_K
PARITY_M, PARITY_K, PARITY_LS = 256, 1024, (8, 14, 20)
HARNESS_ITERS = 5
TIME_AGREE = 0.10                   # OS2-fast-14 against phase 5's call


def mp_bands(errs):
    """tests/test_mpgemm.py's ladder on median relerrs by mode."""
    M = mp.Mode
    assert errs[M.BF16X3] < errs[M.BF16TC] / 10, errs
    assert errs[M.BF16X6] < errs[M.BF16X3], errs
    assert errs[M.BF16TC] > 1e-4, errs
    assert errs[M.BF16X3] < 5e-6, errs
    assert errs[M.NATIVE] < 5e-7, errs
    assert errs[M.SCALING] < 5e-6, errs
    assert errs[M.AUTO] < 5e-6, errs


def phase_baselines():
    """Phase 3h: OS-I and mpgemm on the card against the same functions on
    the host's CPU: ozimmu_gemm bit for bit (the card's padded
    torch._int_mm route), ozimmu_zgemm bit for bit, exp_stats and
    mantissa_loss_stats equal; mp_gemm's six modes and mp_cgemm float32
    and within tests/test_mpgemm.py's bands of the dd oracle."""
    for (m, k, n), splits, special in OSI_CASES:
        a, b = operands(m, k, n, 31, special)
        ac, bc = a.cpu(), b.cpu()
        for s in splits:
            t0 = time.perf_counter()
            got = ozimmu.ozimmu_gemm(a, b, s).cpu()
            t1 = time.perf_counter()
            want = ozimmu.ozimmu_gemm(ac, bc, s, device="cpu")
            t2 = time.perf_counter()
            assert_bits_equal(got, want, f"ozimmu_gemm {m}x{k}x{n} s={s}")
            rel = float(((got - ac @ bc).abs()
                         / (ac.abs() @ bc.abs()).clamp_min(1e-300)).max())
            log(f"  ozimmu_gemm {m} x {k} x {n} s={s}"
                f"{' (zeros, -0.0, subnormals)' if special else ''}: card == "
                f"CPU bit for bit (card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} "
                f"s); max |c - AB| / (|A||B|) {rel:.3e}")
        for s in (3, 9, 16):
            for x, axis in ((a, 1), (b, 0)):
                kern = float(ozimmu.mantissa_loss_stats(x, s, axis))
                plain = float(ozimmu.mantissa_loss_stats(x.cpu(), s, axis,
                                                         device="cpu"))
                assert kern == plain, ("mantissa_loss_stats", s, kern, plain)
        assert (ozimmu.auto_num_split(a, b)
                == ozimmu.auto_num_split(ac, bc, device="cpu"))
    (m, k, n), s = OSI_COMPLEX
    z = [phi_matrix(*shape, 0.5, seed=40 + i) for i, shape in
         enumerate(((m, k), (m, k), (k, n), (k, n)))]
    z[0][1, :] = 0.0
    z[3][::9, 2] = -0.0
    got = ozimmu.ozimmu_zgemm(*(torch.from_numpy(p).to(DEVICE) for p in z), s)
    want = ozimmu.ozimmu_zgemm(*z, s, device="cpu")
    for g, w, part in zip(got, want, ("Re", "Im")):
        assert_bits_equal(g.cpu(), w, f"ozimmu_zgemm {part}")
    log(f"  ozimmu_zgemm {m} x {k} x {n} s={s}: card == CPU bit for bit")

    a = phi_matrix(64, 256, 0.5, seed=600).astype(np.float32)
    b = phi_matrix(256, 64, 0.5, seed=601).astype(np.float32)
    hi, _ = dd_gemm(a.astype(np.float64), b.astype(np.float64))
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    for x in (a, phi_matrix(300, 200, 6.0, seed=602).astype(np.float32)):
        for lose in (4, 16):
            kern = mp.exp_stats(x, lose)
            plain = mp.exp_stats(x, lose, device="cpu")
            assert [float(v) for v in kern] == [float(v) for v in plain]
    errs = {}
    for mode in mp.Mode:
        c = mp.mp_gemm(a, b, mode)
        assert c.dtype == torch.float32 and c.is_cuda, (mode, c.dtype)
        c = c.cpu().numpy().astype(np.float64)
        cpu = mp.mp_gemm(a, b, mode, device="cpu").numpy()
        assert np.all(np.abs(c - cpu) <= 1e-6 * scale), mode
        errs[mode] = float(np.median(np.abs(c - hi) / np.abs(hi)))
    mp_bands(errs)
    az = (a + 1j * (a * 0.7 + 0.1)).astype(np.complex64)
    bz = (b + 0.5j * b).astype(np.complex64)
    cz = mp.mp_cgemm(az, bz)
    assert cz.dtype == torch.complex64 and cz.is_cuda
    refz = az.astype(np.complex128) @ bz.astype(np.complex128)
    zerr = float(np.median(np.abs(cz.cpu().numpy() - refz) / np.abs(refz)))
    assert zerr < 1e-5, zerr
    log("  mp_gemm (64 x 256 x 64, tests/test_mpgemm.py's data) median "
        "relerr against the dd oracle, float32 out: "
        + ", ".join(f"{mode.name} {e:.3e}" for mode, e in errs.items())
        + f"; mp_cgemm (complex64 out) {zerr:.3e}: inside the ladder bands")


def scale_band_check(rows):
    """tests/test_scale_bands.py's rule on accuracy_check rows at the
    reference scale (accuracy_sweep.band_checks): raises on a failed
    check."""
    checks = accuracy_sweep.band_checks(rows)
    # every band's L present: a check each, a monotone step between each two
    assert len(checks) == 2 * (2 * len(REF_FAST) - 1), checks
    failed = [what for what, ok in checks if not ok]
    assert not failed, failed


def phase_harness_accuracy():
    """Phase 4h: the reference's accuracy protocol on the card through
    harness.accuracy_check (d, m = n = 1024, k = 8192, phi 0.5, both modes
    at test_scale_bands.py's L), each row inside that file's band rule; a
    256 x 1024 x 256 accuracy_check at L = 8, 14, 20 in both modes whose
    OS2 rows equal the CPU run's (the same bits); a saved case replayed on
    the card and on the CPU to the same C."""
    t0 = time.perf_counter()
    rows, _ = harness.accuracy_check(
        "d", sizes=(SCALE_K,), phis=(0.5,), moduli=sorted(REF_FAST),
        fastmodes=(True, False), m=SCALE_M, write_csv=False)
    bands = {"OS2-fast": REF_FAST, "OS2-accu": REF_ACCU}
    for row in rows:
        tag, _, L = row["func"].rpartition("-")
        band = bands[tag][int(L)] if tag in bands else None
        log(f"  accuracy_check d {SCALE_M} x {SCALE_K} x {SCALE_M} "
            f"{row['func']}: max {row['max_relerr']!r}, median "
            f"{row['med_relerr']!r}"
            + (f" (GH200 band {band})" if band else ""))
    scale_band_check(rows)
    log(f"  reference-scale rows inside test_scale_bands.py's rule "
        f"({time.perf_counter() - t0:.1f} s with the dd oracle)")
    kw = dict(sizes=(PARITY_K,), phis=(0.5,), moduli=PARITY_LS,
              fastmodes=(True, False), m=PARITY_M, write_csv=False)
    card, _ = harness.accuracy_check("d", **kw)
    cpu, _ = harness.accuracy_check("d", device="cpu", **kw)
    assert [r["func"] for r in card] == [r["func"] for r in cpu]
    for r, c in zip(card, cpu):
        if r["func"].startswith("OS2"):
            assert (r["max_relerr"], r["med_relerr"]) == (
                c["max_relerr"], c["med_relerr"]), (r, c)
    log(f"  accuracy_check d {PARITY_M} x {PARITY_K} x {PARITY_M}, L "
        f"{PARITY_LS}, both modes: every OS2 row's relerrs equal the CPU "
        f"run's (DGEMM: card {card[0]['max_relerr']!r}, CPU "
        f"{cpu[0]['max_relerr']!r})")
    a, b = operands(300, 500, 200, 51, True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.npz")
        replay.save_case(path, a.cpu().numpy(), b.cpu().numpy(), seed=51)
        for fast in (True, False):
            c_card, mx, med = replay.replay(path, 14, fast)
            c_cpu, mx2, med2 = replay.replay(path, 14, fast, device="cpu")
            assert np.array_equal(c_card.view(np.int64), c_cpu.view(np.int64))
            assert (mx, med) == (mx2, med2), (mx, med, mx2, med2)
    log(f"  replay of a saved 300 x 500 x 200 case (zeros, -0.0, "
        f"subnormals), fast and accurate: card == CPU bit for bit, relerr "
        f"max {mx!r}, median {med!r}")


def log_time_rows(rows, what, card):
    """One line a row, with the SM clock and power draw nvidia-smi read
    while that row's timed calls ran (and the watt loop's clock)."""
    log(f"  {what} ({card}):")
    for row in rows:
        phases = ""
        if np.isfinite(row.get("t_scale", np.nan)):
            phases = (", phases " + " / ".join(
                f"{row[key] * 1e3:.3f}" for key in
                ("t_scale", "t_int8gemm", "t_mod", "t_invscale")) + " ms")
        watts = (f"; the watt loop: {row['watt']:.1f} W mean, "
                 f"{row['gflops_per_watt']:.2f} GFLOP/s per W, SM clock "
                 f"median {row['watt_sm_mhz']:.0f} MHz"
                 if "watt" in row else "")
        unit = "TOPS" if row["func"] == "INT8-GEMM" else "TFLOP/s"
        log(f"    {row['func']} {row['m']}^3: {row['seconds'] * 1e3:.3f} ms, "
            f"{row['tflops']:.2f} {unit}{phases}; SM clock median "
            f"{row['sm_mhz']:.0f} MHz, power draw median "
            f"{row['power_draw_w']:.1f} W while it was timed{watts}")


def osi_parts_ms(x, y, s):
    """ms of OS-I's slicing, of its int8 products alone (torch._int_mm over
    each diagonal group, nothing accumulated) and of the whole call."""
    k = x.shape[1]
    split_ms, (a8, _, b8t, _) = timed(
        lambda: ozimmu._slices(x, y, s, True), 3)
    prod_ms, _ = timed(
        lambda: [p for _, p in ozimmu._diagonal_products(a8, b8t, s, k)], 3)
    del a8, b8t
    whole_ms, _ = timed(lambda: ozimmu.ozimmu_gemm(x, y, s), 3)
    return split_ms, prod_ms, whole_ms


def phase_harness_times(fast_ms, card):
    """Phase 5h: harness.time_check at 8192 (d: 14 moduli, fast and
    accurate, OS1-EF-8/9; f: 8 moduli with BF16X3-SCALING), one
    time_check_complex size and one watt_check row, each row printed with
    the SM clock and power draw sampled while its own timed calls ran; the
    OS2-fast-14 row
    within 10% of phase 5's fast call (the same call by two protocols);
    OS-I's time split into its slicing, its int8 products and the rest."""
    out = {}
    rows_d, _ = harness.time_check(
        "d", sizes=(N,), num_moduli=(L_MAIN,), fastmodes=(True, False),
        iters=HARNESS_ITERS, write_csv=False)
    log_time_rows(rows_d, f"time_check d {N}^3", card)
    rows_f, _ = harness.time_check(
        "f", sizes=(N,), num_moduli=(L_F32,), iters=HARNESS_ITERS,
        write_csv=False)
    log_time_rows(rows_f, f"time_check f {N}^3", card)
    rows_c, _ = harness.time_check_complex(
        sizes=(N,), num_moduli=(L_F32,), iters=HARNESS_ITERS,
        write_csv=False)
    log_time_rows(rows_c, f"time_check_complex {N}^3 complex64", card)
    (fast,) = [r for r in rows_d if r["func"] == f"OS2-fast-{L_MAIN}"]
    ratio = fast["seconds"] * 1e3 / fast_ms
    log(f"  OS2-fast-{L_MAIN} by the harness's protocol "
        f"{fast['seconds'] * 1e3:.3f} ms against phase 5's fast call "
        f"{fast_ms:.3f} ms: ratio {ratio:.3f}")
    assert abs(ratio - 1) <= TIME_AGREE, ratio
    for row in rows_d + rows_f + rows_c:
        assert row["seconds"] > 0 and np.isfinite(row["tflops"]), row
    watt_rows, _ = harness.watt_check(rows=[dict(fast)])
    (w,) = watt_rows
    assert np.isfinite(w["watt"]) and w["watt"] > 0, w
    log_time_rows(watt_rows, f"watt_check, a loop of at least "
                  f"{harness.WATT_SECONDS:.0f} s, the instant power draw every "
                  f"{harness.WATT_INTERVAL_MS} ms", card)
    x = torch.from_numpy(phi_matrix(N, N, 0.5, seed=123456)).to(DEVICE)
    y = torch.from_numpy(phi_matrix(N, N, 0.5, seed=123457)).to(DEVICE)
    for s in (8, 9):
        split_ms, prod_ms, whole_ms = osi_parts_ms(x, y, s)
        rest = whole_ms - split_ms - prod_ms
        out[s] = (split_ms, prod_ms, whole_ms)
        log(f"  OS1-EF-{s} {N}^3 in parts: slicing {split_ms:.3f} ms, int8 "
            f"products (torch._int_mm, {s * (s + 1) // 2} slice pairs) "
            f"{prod_ms:.3f} ms, limb scatter + carry + rounding "
            f"{rest:.3f} ms, whole {whole_ms:.3f} ms: the rest is "
            f"{rest / whole_ms:.3f} of it ({card})")
    del x, y
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    log(f"[1/5] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log("card (name, power limit):")
    log(card)

    t0 = time.perf_counter()
    build.lib()
    log(f"[2/5] kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s from {len(build.sources())} "
        "sources")

    for src in ("matmul_mod.cu", "matmul_rider.cu", "encode.cu",
                "reconstruct.cu", *NO_SPILL_SOURCES):
        ptxas = [line.strip() for line in
                 build.PTXAS_REPORT.get(src, "").splitlines()
                 if "entry function" in line or "Used" in line
                 or "spill" in line]
        assert ptxas, f"no ptxas report of {src}"
        for line in ptxas:
            log(f"  ptxas {src}: {line}")
    for src in NO_SPILL_SOURCES:
        spills = build.spill_bytes(src)
        assert spills and not any(spills), f"{src} spills: {spills}"
        log(f"  ptxas {src}: 0 spill bytes in all "
            f"{len(spills) // 2} functions")
    errs = dict.fromkeys(KERNELS, 0.0)
    t0 = time.perf_counter()
    phase_kernels(errs)
    phase_mma_kernels(errs)
    phase_wgmma_kernels(errs)
    phase_reconstruct_wgmma(errs)
    phase_crt_wgmma(errs)
    phase_magmax_wgmma(errs)
    phase_rounding(errs)
    phase_accurate_kernels(errs)
    phase_log2()
    phase_complex_kernels(errs)
    phase_complex_edge(errs)
    phase_variant_kernels(errs)
    phase_fused_stats_edges(errs)
    phase_pipelined_edges(errs)
    phase_schedule_kernels(errs)
    phase_pipeline_kernels(errs)
    phase_f32_kernels(errs)
    phase_rounding_f32(errs)
    phase_c64_kernels(errs)
    phase_rider_f32_kernels(errs)
    phase_rider_edges(errs)
    phase_golden()
    phase_probe_kernels(errs)
    phase_baselines()
    log(f"[3/5] every kernel == its plain version "
        f"({time.perf_counter() - t0:.1f} s)")

    launches = {}
    t0 = time.perf_counter()
    a, b, rel_fast, rel_accu, refs, oracle = phase_slice(launches)
    phases_4i_4d(a, b, refs, launches, card)
    A, B, rels = phase_complex(launches)
    phase_complex_peaks(A, B)
    variant_rels = phase_variants(a, b, refs, oracle, A, launches)
    schedule_rels = phase_schedules(a, b, refs, oracle, launches)
    pipe_rels, b_wide, peak_wide = phase_pipeline(a, b, refs, oracle,
                                                  launches)
    fast_digest = digest(refs[True])
    del refs
    a32, b32, f32_rels = phase_f32(a, b, launches)
    A64, B64, c64_rels = phase_complex64(A, a32, b32, launches)
    rcalls, _ = phase_pipeline_f32(a, b, a32, b32, b_wide, launches)
    bcalls, btimes = phase_batched_timed(a, b, a32, A64, B64)
    phase_probes(launches)
    phase_harness_accuracy()
    log(f"[4/5] main path checked ({time.perf_counter() - t0:.1f} s)")

    times, total, total_accu, library = phase_times(a, b, errs)
    for name, (ms, pms) in times.items():
        earlier = (f"; before the tensor-core redesign {EARLIER_MS[name]} ms "
                   "(PERF.md)" if name in EARLIER_MS else "")
        log(f"  {name}: kernel {ms:.3f} ms, plain {pms:.3f} ms{earlier} "
            f"({N}^2 operands, {L_MAIN} moduli; {card})")
    for name, loops in mma_loop_sass().items():
        log(f"  {name} ({MMA_SASS[name]}) SASS loops, outermost first: "
            + "; ".join(
                f"{n} instructions ("
                + ", ".join(f"{cls} {k}" for cls, k in by.items()) + ")"
                for n, by in loops))
    for mode, ms, rel in (("fast", total, rel_fast),
                          ("accurate", total_accu, rel_accu)):
        tflops = 2 * N ** 3 / (ms * 1e-3) / 1e12
        log(f"  gemm {N}^3 {L_MAIN} moduli f64 {mode}: {ms:.3f} ms, "
            f"{tflops:.2f} TFLOP/s, gate relerr {rel!r} ({card})")
    bounds_main = kernel_bounds(a, b, L_MAIN)
    ctimes, calls, by_place = phase_complex_times(A, B, errs)
    ms, _ = ctimes["recenter_add_int8"]
    log(f"  Karatsuba sum slices (plain tensor ops, A + B): {ms:.3f} ms "
        f"({N}^2 operands, {L_MAIN} moduli; {card})")
    for step, what in (("fast_stats", "Re and Im of A rows and B columns"),
                       ("complex magnitudes", "emax x4, mag7 x4 at shift 4 "
                        "and the sums, A and B"),
                       ("4-dot", "matmul_complex_mod"),
                       ("Karatsuba", "matmul_complex_mod")):
        ms, pms = ctimes[step]
        log(f"  {step} ({what}): kernel {ms:.3f} ms, plain {pms:.3f} ms "
            f"({N}^2 operands, {L_MAIN} moduli; {card})")
    log(f"  complex {N}^3 calls, {COMPLEX_ROUNDS} rounds in rotated order, "
        "2 calls per timing:")
    for (strat, fastmode), mss in calls.items():
        ms = float(np.median(mss))
        elem = 2 * N ** 3 / (ms * 1e-3) / 1e12
        real = 8 * N ** 3 / (ms * 1e-3) / 1e12
        log(f"  gemm complex128 {N}^3 {L_MAIN} moduli {strat.name} "
            f"{'fast' if fastmode else 'accurate'}: median {ms:.3f} ms "
            f"(rounds {', '.join(f'{t:.3f}' for t in mss)}), "
            f"{elem:.2f} TFLOP/s (2mnk/t), {real:.2f} real TFLOP/s (8mnk/t), "
            f"gate relerr {rels[(strat, fastmode)]!r} ({card})")
    log("  median ms by place in the round (1st..5th): "
        + ", ".join(f"{float(np.median(v)):.3f}" for v in by_place.values()))
    times["matmul_complex_mod"] = ctimes["4-dot"]
    clib = ctimes["library"]
    library["matmul_complex_mod"] = clib["4-dot " + LIBRARY]
    for form, n_mm in (("4-dot", 4), ("Karatsuba", 3)):
        log(f"  matmul_complex_mod {form}: median {clib[form]:.3f} ms beside "
            f"{LIBRARY} ({n_mm} x {L_MAIN} torch._int_mm) "
            f"{clib[form + ' ' + LIBRARY]:.3f} ms in one rotation: ratio "
            f"{clib[form] / clib[form + ' ' + LIBRARY]:.3f} ({card})")
    vtimes, vcalls = phase_variant_times(a, b, errs)
    for name, (by_label, pms, clock) in vtimes.items():
        meds = {label: float(np.median(v)) for label, v in by_label.items()}
        times[name] = (meds[name], pms)
        log(f"  {name}: " + "; ".join(
            f"{label} median {ms:.3f} ms (rounds "
            f"{', '.join(f'{t:.3f}' for t in by_label[label])})"
            for label, ms in meds.items())
            + f"; plain {pms:.3f} ms ({N}^2 operands, {L_MAIN} moduli; "
            f"{clock}; {card})")
    for name, pair in (("fast_encode_fused", "fast_sft + encode_slices"),
                       ("mag7_fused", "emax + mag7")):
        for line in fused_half_lines(vtimes[name], name, pair, a, b):
            log(line + f" ({card})")
    mag_by, _, mag_clock = vtimes["magmax_matmul_scratch"]
    mag_lib = float(np.median(mag_by[LIBRARY]))
    for name in ("magmax_matmul", "magmax_matmul_scratch"):
        ms = float(np.median(mag_by[name]))
        log(f"  {name} (wgmma tile): median {ms:.3f} ms beside {LIBRARY} (x "
            f"1 torch._int_mm) {mag_lib:.3f} ms in one rotation: ratio "
            f"{ms / mag_lib:.3f}; bound {bounds_main[name][0]:.3f} ms "
            f"({bounds_main[name][1]}), share {bounds_main[name][0] / ms:.3f}"
            f"; {mag_clock} ({card})")
    log(f"  variant calls at {N}^3, {VARIANT_ROUNDS} rounds in rotated "
        "order, 2 calls per timing:")
    for name, mss in vcalls.items():
        ms = float(np.median(mss))
        tflops = 2 * N ** 3 / (ms * 1e-3) / 1e12
        rel = variant_rels.get(name, rel_fast if name.startswith("fast")
                               else rel_accu)
        log(f"  gemm {N}^3 {L_MAIN} moduli f64 {name}: median {ms:.3f} ms "
            f"(rounds {', '.join(f'{t:.3f}' for t in mss)}), "
            f"{tflops:.2f} TFLOP/s, gate relerr {rel!r} ({card})")
    library["matmul_mod_u8_pipelined"] = float(np.median(
        vtimes["matmul_mod_u8_pipelined"][0][LIBRARY]))
    library["magmax_matmul_scratch"] = library["magmax_matmul"] = float(
        np.median(vtimes["magmax_matmul_scratch"][0][LIBRARY]))
    bounds = bounds_main
    skerns, splain, scalls, sclock = phase_schedule_times(a, b, errs)
    library["matmul_crt"] = library["matmul_reconstruct"] = float(
        np.median(skerns[LIBRARY]))
    for label, mss in skerns.items():
        line = (f"  {label}: median {float(np.median(mss)):.3f} ms (rounds "
                f"{', '.join(f'{t:.3f}' for t in mss)})")
        if label in splain:
            ms, by = bounds[label]
            line += f"; plain {splain[label]:.3f} ms; bound {ms:.3f} ms ({by})"
        log(line + f" ({N}^2 operands, {L_MAIN} moduli; {card})")
    for name in SCHEDULE_KERNELS:
        times[name] = (float(np.median(skerns[name])), splain[name])
    crt_ms = times["matmul_crt"][0]
    rec_ms = times["matmul_reconstruct"][0]
    log(f"  matmul_crt (wgmma tile): median {crt_ms:.3f} ms beside {LIBRARY} "
        f"(x {L_MAIN} torch._int_mm) {library['matmul_crt']:.3f} ms, ratio "
        f"{crt_ms / library['matmul_crt']:.3f}; beside matmul_reconstruct "
        f"{rec_ms:.3f} ms, ratio {crt_ms / rec_ms:.3f}; share of the bound "
        f"{bounds['matmul_crt'][0] / crt_ms:.3f}; all in one rotation; "
        f"{sclock} ({card})")
    log(f"  schedule calls at {N}^3, {SCHEDULE_ROUNDS} rounds in rotated "
        "order, 2 calls per timing:")
    for name, mss in scalls.items():
        ms = float(np.median(mss))
        tflops = 2 * N ** 3 / (ms * 1e-3) / 1e12
        rel = schedule_rels.get(name, rel_fast if name.startswith("fast")
                                else rel_accu)
        log(f"  gemm {N}^3 {L_MAIN} moduli f64 {name}: median {ms:.3f} ms "
            f"(rounds {', '.join(f'{t:.3f}' for t in mss)}), "
            f"{tflops:.2f} TFLOP/s, gate relerr {rel!r} ({card})")
    pkerns, pplain, pcalls = phase_pipeline_times(a, b, b_wide, errs)
    for label, mss in pkerns.items():
        line = (f"  {label}: median {float(np.median(mss)):.3f} ms (rounds "
                f"{', '.join(f'{t:.3f}' for t in mss)})")
        if label in pplain:
            ms, by = bounds[label]
            line += f"; plain {pplain[label]:.3f} ms; bound {ms:.3f} ms ({by})"
        log(line + f" ({N}^2 operands, panels of {PANEL_M} rows, {L_MAIN} "
            f"moduli; {card})")
    for name in PIPELINE_KERNELS:
        times[name] = (float(np.median(pkerns[name])), pplain[name])
    library["matmul_rider_step"] = library["matmul_bsplit_pair"] = float(
        np.median(pkerns[LIBRARY + ", one panel"]))
    for name, what in (("matmul_rider_step",
                        "matmul_mod_u8 + reconstruct + encode_slices, one "
                        "panel"),
                       ("matmul_bsplit_pair",
                        "matmul_mod_u8 panel 0 + encode_slices of B's right "
                        "half and of A panel 1")):
        ms = times[name][0]
        log(f"  {name}: median {ms:.3f} ms beside {LIBRARY} (x {L_MAIN} "
            f"torch._int_mm, one panel) {library[name]:.3f} ms, ratio "
            f"{ms / library[name]:.3f}; beside {what} "
            f"{float(np.median(pkerns[what])):.3f} ms, ratio "
            f"{ms / float(np.median(pkerns[what])):.3f} ({card})")
    fkerns, fcalls = phase_f32_times(a, b, a32, b32, errs)
    bounds.update(kernel_bounds_f32(a32, b32, L_F32))
    for key, (ms, ms64, pms) in fkerns.items():
        times[key] = (ms, pms)
        log(f"  {key}: median {ms:.3f} ms beside its f64 form {ms64:.3f} ms "
            f"(rotated rounds); plain {pms:.3f} ms; bound "
            f"{bounds[key][0]:.3f} ms ({bounds[key][1]}) ({N}^2 operands, "
            f"{L_F32} moduli; {card})")
    log(f"  f32 and f64 calls at {N}^3, {F32_ROUNDS} rounds in rotated "
        f"order, 2 calls per timing ({card}):")
    for name, mss in fcalls.items():
        ms = float(np.median(mss))
        gate_note = ""
        mode = {"f32 fast-8": "fast", "f32 accurate-8": "accurate"}.get(name)
        if mode:
            rel = f32_rels[f"f32 x f32 -> f32 {mode}, {L_F32} moduli"]
            gate_note = (f", gate relerr max {rel[0]!r} median {rel[1]!r}; "
                         "the reference library's GH200 figures are "
                         "OS2-fast-8 126.96, OS2-accu-8 107.55 TFLOP/s "
                         "(BASELINE.md, not this card's)")
        log(f"  {name} {N}^3: median {ms:.3f} ms (rounds "
            f"{', '.join(f'{t:.3f}' for t in mss)}), "
            f"{2 * N ** 3 / (ms * 1e-3) / 1e12:.2f} TFLOP/s (2mnk/t)"
            f"{gate_note} ({card})")
    with ClockSampler() as clock:
        by, _ = timed_rounds({
            "fast": lambda: gt.gemm(a, b, num_moduli=L_MAIN, device=DEVICE),
            "accurate": lambda: gt.gemm(a, b, num_moduli=L_MAIN,
                                        fastmode=False, device=DEVICE),
            "f32 fast-8": lambda: gt.gemm(a32, b32, num_moduli=L_F32,
                                          device=DEVICE)}, MAIN_ROUNDS, 2)
    log(f"  the main calls at {N}^3 in one rotation, {MAIN_ROUNDS} rounds, 2 "
        f"calls per timing ({clock.summary()}; {card}):")
    for name, mss in by.items():
        ms = float(np.median(mss))
        parent = (f"; before magmax's wgmma tile {EARLIER_ACCURATE_MS} ms "
                  f"(PERF.md), ratio {ms / EARLIER_ACCURATE_MS:.3f}"
                  if name == "accurate" else "")
        log(f"  gemm {N}^3 {name}: median {ms:.3f} ms (rounds "
            f"{', '.join(f'{t:.3f}' for t in mss)}), "
            f"{2 * N ** 3 / (ms * 1e-3) / 1e12:.2f} TFLOP/s{parent}")
    ckerns, ccalls = phase_complex64_times(A, A64, B64, a, b, a32, b32,
                                           errs)
    bounds.update(kernel_bounds_c64(L_F32))
    library["matmul_reconstruct[f32]"] = \
        ckerns["matmul_reconstruct[f32]"][1][LIBRARY]
    for key, (ms, meds, pms) in ckerns.items():
        times[key] = (ms, pms)
        log(f"  {key}: " + "; ".join(f"{label} median {v:.3f} ms"
                                     for label, v in meds.items())
            + f" (rotated rounds); plain {pms:.3f} ms; bound "
            f"{bounds[key][0]:.3f} ms ({bounds[key][1]}) ({N}^2 operands, "
            f"{L_F32} moduli; {card})")
    for key in ("fast_stats (f64 parts)", "matmul_complex_mod Karatsuba"):
        log(f"  bound of {key} at {N}^2 ({L_MAIN} moduli): "
            f"{bounds[key][0]:.3f} ms ({bounds[key][1]})")
    log(f"  complex64 calls at {N}^3, {L_F32} moduli, {F32_ROUNDS} rounds in "
        f"rotated order, 2 calls per timing ({card}):")
    for name, mss in ccalls.items():
        ms = float(np.median(mss))
        rel = c64_rels.get(f"complex64 {name}")
        log(f"  {name} {N}^3: median {ms:.3f} ms (rounds "
            f"{', '.join(f'{t:.3f}' for t in mss)}), "
            f"{2 * N ** 3 / (ms * 1e-3) / 1e12:.2f} TFLOP/s (2mnk/t), "
            f"{8 * N ** 3 / (ms * 1e-3) / 1e12:.2f} real TFLOP/s (8mnk/t)"
            + (f", gate relerr max {rel[0]!r} median {rel[1]!r}" if rel
               else "") + f" ({card})")
    del A64, B64
    log(f"  pipelined and column-panel calls, {PIPELINE_ROUNDS} rounds in "
        "rotated order, 2 calls per timing:")
    for name, mss in pcalls.items():
        ms = float(np.median(mss))
        wide = name.startswith(("n_panel", str(N_WIDE)))
        flop = 2 * N * N * (N_WIDE if wide else N)
        rel = pipe_rels.get(name, rel_fast if name.startswith("fast")
                            else rel_accu)
        # each schedule's ratio to the one-shot call of its mode and shape
        base = (f"{N_WIDE} columns one-shot" if wide
                else f"{name.split()[0]} default")
        ratio = ("" if base == name else
                 f", ratio {ms / float(np.median(pcalls[base])):.3f} to "
                 f"{base}")
        log(f"  gemm {N} x {N} x {N_WIDE if wide else N} {L_MAIN} moduli "
            f"f64 {name}: median {ms:.3f} ms (rounds "
            f"{', '.join(f'{t:.3f}' for t in mss)}), "
            f"{flop / (ms * 1e-3) / 1e12:.2f} TFLOP/s{ratio}, gate relerr "
            f"{rel!r}{f'; one-shot peak {peak_wide} bytes' if wide else ''} "
            f"({card})")
    rkerns, rcall_ms = phase_pipeline_f32_times(a, b, a32, b32, rcalls, errs)
    bounds.update(kernel_bounds_riders({key: v[3]
                                        for key, v in rkerns.items()}))
    for key, (ms, ms64, pms, L, lib_ms) in rkerns.items():
        times[key] = (ms, pms)
        lib_note = ""
        if lib_ms is not None:
            library[key] = lib_ms
            lib_note = (f"; {LIBRARY} (x {L} torch._int_mm, one panel) "
                        f"{lib_ms:.3f} ms, ratio {ms / lib_ms:.3f}")
        log(f"  {key}: median {ms:.3f} ms beside its f64 form {ms64:.3f} ms "
            f"on the same panel (rotated rounds){lib_note}; plain {pms:.3f} "
            f"ms; bound {bounds[key][0]:.3f} ms ({bounds[key][1]}) ({N}^2 "
            f"operands, panels of {PANEL_M} rows, {L} moduli; {card})")
    log(f"  f32, mixed and f32-output pipelined calls, {PIPELINE_ROUNDS} "
        f"rounds in rotated order, 2 calls per timing ({card}):")
    for name, mss in rcall_ms.items():
        wide = "n_panel" in name
        flop = 2 * N * N * (N_WIDE if wide else N)
        ms = float(np.median(mss))
        log(f"  {name}{'' if wide else f' {N}^3'}: median {ms:.3f} ms "
            f"(rounds {', '.join(f'{t:.3f}' for t in mss)}), "
            f"{flop / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    batched, phases = phase_batched_timed_times(bcalls, btimes)
    for name, (per, single) in batched.items():
        log(f"  {name}, {N}^3 each: median {per:.3f} ms per element beside "
            f"{single:.3f} ms per single call (rotated rounds; {card})")
    for name, (t, fused) in phases.items():
        log(f"  gemm_timed {name} {N}^3 (iters=5): encode {t[0] * 1e3:.3f}, "
            f"int8 GEMMs {t[1] * 1e3:.3f}, mod {t[2] * 1e3:.4f}, reconstruct "
            f"{t[3] * 1e3:.3f}, sum {sum(t) * 1e3:.3f} ms beside the fused "
            f"call's median {fused:.3f} ms ({card})")
    del a32, b32, b_wide, A, B, bcalls, btimes, rcalls
    torch.cuda.empty_cache()
    ptimes, pbounds, plib = phase_probe_times(errs)
    times.update(ptimes)
    bounds.update(pbounds)
    library.update(plib)
    phase_harness_times(total, card)
    slower = sorted((times[name][0] / lib_ms, name, times[name][0], lib_ms)
                    for name, lib_ms in library.items()
                    if name in times and times[name][0] > lib_ms)
    log("  kernels slower than a library call computing their products: "
        + ("; ".join(f"{name} {ms:.3f} ms, {ratio:.3f} x {lib_ms:.3f} ms"
                     for ratio, name, ms, lib_ms in reversed(slower))
           or "none"))
    log("[5/5] times taken")
    t0 = time.perf_counter()
    phase_drivers(fast_digest, card)
    log(f"[6] the drivers on the card ({time.perf_counter() - t0:.1f} s)")
    log(f"wall time of the run: {time.perf_counter() - t_start:.1f} s")
    log("seconds by phase function: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in sorted(
            PHASE_SECONDS.items(), key=lambda kv: -kv[1])))

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                "library_ms": library.get(name)}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# Phase 6: the drivers on the card (accuracy_sweep's d protocol cut to
# two k and two phi; the card against the CPU's plain path at these
# (k, phi, L, fastmode) points; scale_bench's 16384^3 at 3 iterations)
DRIVER_KS, DRIVER_PHIS = (1024, 8192), (0.5, 4.0)
DRIVER_CPU_POINTS = [(8192, 4.0, 14, True), (8192, 4.0, 14, False),
                     (1024, 0.5, 2, True), (1024, 0.5, 20, True)]
SCALE_ARGS = ("16384", "4096", "14", "3")


def held_to_cpu(a, b, L, fastmode):
    """gemm on the card and on the CPU (the plain versions) on numpy a, b:
    bit-equal, or their shifts differ only at a floor boundary and the
    CPU's plain path on the card's shifts gives the card's bits. Returns
    how many shifts differed."""
    card = gt.gemm(a, b, num_moduli=L, fastmode=fastmode)
    cpu = gt.gemm(a, b, num_moduli=L, fastmode=fastmode, device="cpu")
    if torch.equal(bits64(card.cpu()), bits64(cpu)):
        return 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    da, db = ta.to(DEVICE), tb.to(DEVICE)
    if fastmode:
        ks = (hk.fast_sft(da, L, 1).cpu(), hk.fast_sft(db, L, 0).cpu())
        ps = (hk.fast_sft(ta, L, 1), hk.fast_sft(tb, L, 0))
        for kern, plain, x, axis in zip(ks, ps, (ta, tb), (1, 0)):
            check_sft(kern, plain, x, axis, L)
    else:
        ks = tuple(s.cpu() for s in tg.accurate_sfts(da, db, L))
        ps = tg.accurate_sfts(ta, tb, L)
        ea, eb = hk.emax_plain(ta, 1), hk.emax_plain(tb, 0)
        smax = hm.magmax_plain(hk.mag7_plain(ta, ea, 1),
                               hk.mag7_plain(tb, eb, 0))
        for kern, plain, s in zip(ks, ps, smax):
            diff = kern != plain
            if bool(diff.any()):
                assert int((kern.long() - plain.long()).abs().max()) <= 1
                frac = enc.accurate_sft_floor_frac(s, L)
                assert float(frac[diff].max()) < SHIFT_RULE_FRAC, \
                    "accurate shift differs away from a floor boundary"
    held, _, _ = plain_gemm(ta, tb, L, ks)
    assert_bits_equal(card.cpu(), held, f"card vs CPU plain path, L={L}, "
                      f"{'fast' if fastmode else 'accurate'}")
    return sum(int((k != p).sum()) for k, p in zip(ks, ps))


def phase_driver_accuracy(tmp):
    """Phase 6a: accuracy_sweep d on the card, its band checks, and the
    card's outputs against the CPU's plain path."""
    out = accuracy_sweep.main(
        ["d", "--sizes", ",".join(map(str, DRIVER_KS)), "--phis",
         ",".join(map(str, DRIVER_PHIS)), "--outdir", tmp])
    rows = out["rows"]
    assert len(rows) == len(DRIVER_KS) * len(DRIVER_PHIS) * (1 + 2 * 19)
    assert out["bands"] and all(ok for _, ok in out["bands"]), out["bands"]
    for row in rows:
        assert np.isfinite(row["max_relerr"]), row
    log(f"  6a: accuracy_sweep d, m = {SCALE_M}, k {DRIVER_KS}, phi "
        f"{DRIVER_PHIS}, L 2..20, both modes: {len(rows)} rows; "
        f"{len(out['bands'])} band checks at k {SCALE_K}, phi 0.5 hold "
        "(tests/test_scale_bands.py's rule)")
    for k, phi, L, fastmode in DRIVER_CPU_POINTS:
        a = phi_matrix(SCALE_M, k, phi, 123456)
        b = phi_matrix(k, SCALE_M, phi, 123457)
        moved = held_to_cpu(a, b, L, fastmode)
        log(f"  6a: card == CPU plain path, {SCALE_M} x {k} x {SCALE_M}, phi "
            f"{phi}, L {L}, {'fast' if fastmode else 'accurate'}: bits equal"
            + (f" on the card's shifts ({moved} at a floor boundary)"
               if moved else ""))


def phase_driver_time_sweep(tmp, card):
    """Phase 6b: time_sweep 1024,4096 d."""
    rows, _ = time_sweep.main(["1024,4096", "d", "--outdir", tmp])["d"]
    assert len(rows) == 2 * 7, [r["func"] for r in rows]
    for row in rows:
        assert row["seconds"] > 0 and np.isfinite(row["tflops"]), row
    log_time_rows(rows, "6b: time_sweep 1024,4096 d", card)


def phase_driver_scale(tmp, card):
    """Phase 6c: scale_bench at 16384^3, panels of 4096 columns."""
    out = scale_bench.main([*SCALE_ARGS, "--outdir", tmp])
    assert out["bits_equal"]
    for name in ("panel", "one_shot"):
        r = out[name]
        assert r["tile_max_relerr"] < 1e-8 and r["peak_bytes"] > 0, r
        log(f"  6c: scale_bench {r['m']}^3 {r['func']}: "
            f"{r['seconds'] * 1e3:.3f} ms, {r['tflops']:.2f} TFLOP/s, peak "
            f"{r['peak_bytes']} bytes, tile relerr {r['tile_max_relerr']!r}; "
            f"SM clock median {r['sm_mhz']:.0f} MHz, power draw median "
            f"{r['power_draw_w']:.1f} W ({card})")
    log(f"  6c: the n_panel={SCALE_ARGS[1]} call == the one-shot call, bit "
        "for bit; peak ratio panel / one-shot "
        f"{out['panel']['peak_bytes'] / out['one_shot']['peak_bytes']:.3f}")


def phase_driver_profile_phases(fast_digest, card):
    """Phase 6d: profile_phases 8192 14, its output against phase 4's."""
    out = profile_phases.main([str(N), str(L_MAIN)])
    assert digest(out["out"]) == fast_digest, \
        "profile_phases vs phase 4's call"
    log(f"  6d: profile_phases {N} {L_MAIN}: kernels' sum "
        f"{out['sum_ms']:.3f} ms ({out['tflops']:.2f} TFLOP/s effective); "
        f"output == phase 4's fast call (digest {fast_digest[:16]}) "
        f"({card})")


def phase_driver_profile_one_call(tmp, card):
    """Phase 6e: profile_one_call --iters 3 with its trace."""
    out = profile_one_call.main(["--iters", "3", "--trace-dir", tmp])
    size = os.path.getsize(out["trace"])
    assert size > 0, out["trace"]
    log(f"  6e: profile_one_call: trace {os.path.basename(out['trace'])} "
        f"written, {size} bytes; {out['ms']:.3f} ms per call by CUDA events "
        f"({card})")
    if out["device_us"] > 0:
        log(f"  6e: key_averages() shows {out['device_us'] / 1e3:.3f} ms of "
            "CUDA device time over the profiled calls")
    else:
        log("  6e: finding: key_averages() shows no CUDA device time on "
            "this host (CUPTI gave the profiler no kernel records)")


def phase_drivers(fast_digest, card):
    """Phase 6: the drivers on the card, each part's wall time printed."""
    marks = [("start", time.perf_counter())]
    with tempfile.TemporaryDirectory() as tmp:
        phase_driver_accuracy(tmp)
        marks.append(("6a", time.perf_counter()))
        phase_driver_time_sweep(tmp, card)
        marks.append(("6b", time.perf_counter()))
        torch.cuda.empty_cache()
        phase_driver_scale(tmp, card)
        marks.append(("6c", time.perf_counter()))
        torch.cuda.empty_cache()
        phase_driver_profile_phases(fast_digest, card)
        marks.append(("6d", time.perf_counter()))
        phase_driver_profile_one_call(tmp, card)
        marks.append(("6e", time.perf_counter()))
    torch.cuda.empty_cache()
    log("  phase 6's parts, wall s: " + ", ".join(
        f"{label} {t - t_prev:.1f}" for (_, t_prev), (label, t)
        in zip(marks, marks[1:])))


def drivers_main():
    """`python3 chip_smoke.py drivers`: build the kernels and run phase 6
    alone, on phase 4's fast call at N^3 (no result line)."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    build.lib()
    a = torch.from_numpy(phi_matrix(N, N, 0.5, seed=0)).to(DEVICE)
    fast_digest = digest(gt.gemm(a, a.t().contiguous(), num_moduli=L_MAIN))
    del a
    torch.cuda.empty_cache()
    phase_drivers(fast_digest, card)
    log(f"wall time of the run: {time.perf_counter() - t_start:.1f} s")


def halves_main():
    """`python3 chip_smoke.py halves`: build the kernels and print only
    the halves lines of the statistics kernels at the main path's shapes:
    fast_sft and its statistics mode, f64 and f32, each half beside emax
    (phases 5, 5c, 5f, 5x), and fast_encode_fused's halves (phase 5v);
    no result line. For before-and-after runs in one call, each tree's
    chip_smoke.py in turn."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    log(card_line())
    build.lib()
    re64 = torch.from_numpy(phi_matrix(N, N, 0.5, seed=0)).to(DEVICE)
    im64 = torch.from_numpy(phi_matrix(N, N, 0.5, seed=1)).to(DEVICE)
    parts = {"f64": (re64, im64), "f32": (re64.float(), im64.float())}
    for word, (re_, im_) in parts.items():
        a, b = re_, re_.t().contiguous()
        L = L_MAIN if word == "f64" else L_F32
        for line in sft_half_lines(
                "fast_sft", lambda x, ax, L=L: hk.fast_sft(x, L, ax), (a,),
                (b,)):
            log(line)
        for line in sft_half_lines("fast_stats", hk.fast_stats, (re_, im_),
                                   (b, im_.t().contiguous())):
            log(line)
        if word == "f64":
            with ClockSampler() as clock:
                by_name, _ = timed_rounds(fused_encode_calls(a, b, L),
                                          VARIANT_ROUNDS, 5)
            for line in fused_half_lines((by_name, None, clock.summary()),
                                         "fast_encode_fused",
                                         "fast_sft + encode_slices", a, b):
                log(line + f" ({card_line()})")
        del a, b


# wall seconds of each phase function's calls (summed), printed after the
# run's wall time so that a growing script shows where its time goes
PHASE_SECONDS = collections.Counter()


def _clocked(fn):
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            PHASE_SECONDS[fn.__name__] += time.perf_counter() - t0
    return run


for _name, _fn in list(globals().items()):
    if _name.startswith("phase") and callable(_fn):
        globals()[_name] = _clocked(_fn)


if __name__ == "__main__":
    if sys.argv[1:] == ["halves"]:
        halves_main()
    elif sys.argv[1:] == ["sharded-child"]:
        sharded_child()
    elif sys.argv[1:] == ["gloo-child"]:
        gloo_child()
    elif sys.argv[1:] == ["sharded"]:
        sharded_main()
    elif sys.argv[1:] == ["drivers"]:
        drivers_main()
    else:
        main()
