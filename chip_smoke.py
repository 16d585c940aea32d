#!/usr/bin/env python3
"""Smoke run of nart_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns PARENT_TREE   # phase 22's cells, in turns
    python3 chip_smoke.py --witness   # macbeth's leaves: X3, plain, float64
    python3 chip_smoke.py --vol-witness   # volume_blob's: V2, plain, float64

Kernel times are device times: device_ms captures many calls of a
function into one CUDA graph and divides the replay's CUDA-event time by
the calls (median of a few replays, with min-max), so no host work sits
between the launches, as in the graphed machines.  Beside each kernel's,
call_ms's reading of one call between two events, the host's checks,
allocation and launch included, is logged as "per call, host included":
what an eager caller, a per-round loop, pays.

Phases (any failure raises and exits non-zero):
  1. device: require CUDA; print the card's name and nvidia-smi's
     "name, power.limit" line;
  2. build: compile the CUDA kernels from nart_tpu_torch/csrc into
     build/nart_tpu_torch, one nvcc a source, all started together (timed):
     cluster_hit.cu, small_lut.cu, large_lut.cu, bvh_walk.cu, bsdf.cu and
     vol_step.cu; beside them bvh_walk.cu, bsdf.cu and vol_step.cu once
     more with -Xptxas -v, whose registers, stack frames and spills are
     logged (bsdf.cu's with each kernel's design: the redesign's and the
     first design's; vol_step.cu's V1 and V2's eight instantiations, one a
     step count), and the host core
     core.cpp with g++
     (the .geo/.vol parsers and the LBVH build of native.py, which the
     card's entry points take);
  3. kernels against their plain PyTorch versions on the card: (a) the
     macbeth scene's clusters with 65,536 camera rays and 131,072
     random-direction rays from the hit points (25% with t_max = 0);
     (b) a random 40,000-triangle soup (the >= 32k cluster policy) with
     65,536 rays.  Triangle ids must agree on >= 99.99% of rays, t/u/v to
     rtol 1e-4 / atol 1e-5 where they agree, and any-hit must equal
     closest-hit validity exactly.  The two counter kernels' five counters
     must equal their plain versions' on every ray, the closest-hit walk's
     t the closest-hit kernel's and the any-hit walk's occlusion the
     any-hit kernel's.  Each kernel's and plain version's device ms
     (device_ms; the counter walks' plain versions, which read the card
     from the host, over a few eager calls: stream_ms), each kernel's ms
     per call, and its bound from its own walk's counters on the very rays
     that were timed (see bound);
  4. golden parity: macbeth at 96x96, 8 spp, through the kernels, against
     tests/golden/macbeth_96x96_8spp.exr (read with the port's PIZ
     reader) with test_macbeth_golden's criteria;
  5. forward main path: render_scene_file on macbeth.json at its own
     1280x720 with spp cut from 256 to 8 (to fit the smoke's time): one
     warm run (it captures the session's k-round CUDA graph), one timed
     run with launch counters reset just before it: K1 and K2 launched
     once in every round the card ran (the rounds past the end of the last
     replay, fewer than k, included), one capture for both runs; the
     look-up kernels' forwards launched (the small tables' and the env
     map's), their backwards never; the BSDF kernels X1 (the scatter) and
     the sample+eval launch (strategy A's sample with B's eval, X2's
     redesign) once each in every round the card ran, X2's first design
     and X3 never;
     EXR written to a temporary directory and checked finite with a nonzero
     mean; then the counter tool's entry point (kernel_stats.main) on the
     same scene (both walks), its launches counted the same way;
  6. training path at full width: radiance_weighted_loss_and_grad on
     macbeth 1280x720, one chunk of 4 spp, cot = 1 on RGB, its replay
     machine kept: one warm run (it measures the rounds and captures the
     forward's and the backward's graphs) and one timed run.  The loss
     must equal the forward work queue's sum(la[..., :3]) (rtol 1e-4),
     every gradient leaf must be finite, the albedo, texture and env-map
     gradients nonzero, and the closest-hit and any-hit kernels launched
     once in every forward round the card ran (the live rounds plus fewer
     than k past the end) and never in the backward (its graph captured no
     launch); the look-up forward (every table) in the forward's graph,
     it and both backwards (small and large tables) in the backward's
     round graph; X1 and the sample+eval launch once each a forward round
     (X2's first design never), in the backward's round graph the same
     and X3 three times.  The timed call once more under
     torch.profiler: the top device operations and the shares of
     indexing_backward_kernel*, of the look-up kernels, of the sorts and
     of the memsets.  Then the forward queue alone, twice on one kept
     machine (the first call captures its graph);
  7. gradients through the kernels against the same call on the CPU
     (plain versions), simple_scene at 32x32, 2 spp: every leaf to rtol
     1e-3 / atol 1e-5 (float32 sums in another order, atomics in the
     gathers' backward), K1 launched once in every round the measuring
     and the replay's forwards ran, and one central finite difference to
     5%;
  8. the "regen" and "spp" machines at full width: macbeth 1280x720 @ 4
     spp in "regen" (path.trace_regen) and "spp" (path.trace_lockstep),
     volume_blob 1280x720 @ 2 spp in "spp" (volume.trace_lockstep), each
     rendered through the session's kept machines (twice: the first render
     captures) and on the per-round loop (per_round=True): the films, the
     per-pixel RNG states and the stats the same bits, one capture a
     machine, K1 and K2 launched once and X1 and the sample+eval launch
     once each in every round the card ran (none in the volume; there V1
     once in every round, V2 never); logged for both routes:
     wall s, device ms (busy share) under torch.profiler, rounds run,
     peak MiB, capture s.  The "regen"
     film equals the "spp" film bit for bit, and both image means are
     within 3% of the "balanced" image's;
  9. volume golden: tests/golden/volume_blob.json at its own 96x96, 32 spp
     against volume_blob_96x96_32spp.exr with test_volume_golden's
     criteria (mean rel < 0.02, >= 95% of 16x16 blocks within 0.05), V1
     launched, V2 not.  The
     scene file names blob.vol by an absolute path and a missing volume
     only warns, so the phases render a copy that names this checkout's
     and assert that the medium was loaded;
 10. volume forward at full width: volume_blob at 1280x720 with spp cut
     from 32 to 8: one warm run, one timed run (rounds, segment starts,
     Mrays/s, peak memory; the static machine graphed), EXR finite with a
     nonzero mean, no traversal kernel launched, V1 once in every round
     the card ran and V2 never; the card's busy share
     under torch.profiler over a window of the static machine's rounds on
     the per-round loop;
 11. volume fwd+bwd at full width: radiance_weighted_loss_and_grad on
     volume_blob 1280x720, one chunk of 4 spp, cot = 1 on RGB, timed after
     a warm call on the same kept machine: the loss equals the forward's
     sum(la[..., :3]) (rtol 1e-4), the medium's gradients are finite and
     nonzero, no traversal kernel launched, V1 once a round in the
     forward's graph and V1 and V2 once each in the backward's round
     graph; the busy share over a window of the per-round replay's
     backward rounds;
 12. volume gradients on the card against the CPU: medium_scene at 32x32,
     2 spp: every leaf to rtol 1e-3 / atol 1e-5;
 13. (a) sharding in one process: macbeth at 1280x720, 2 spp, the virtual
     ranks of Layout(4, 1) and Layout(2, 2) (sharding.render_shard) summed
     against the one-process film (atol/rtol 1e-6), each rank's seconds and
     rounds and the rounds' balance over the row ranks logged; macbeth
     "regen" at 320x180, 2 spp, Layout(2, 2), the same check, the strips of
     one row count replaying one kept machine of the session (one capture
     a shape), and a second run of its shards bit-equal to the first, with
     no capture; volume_blob at 1280x720,
     2 spp, Layout(4, 1), the same check (V1 launched);
 14. (b) two ranks sharing the card under gloo (NCCL refuses two ranks on
     one GPU), spawned as `chip_smoke.py --rank R PORT DIR`:
     render_sharded of macbeth at 2 spp against phase 13's one-process film
     (1e-6), radiance_weighted_loss_and_grad_sharded of one 1-spp chunk at
     1280x720 against the one-process call (loss rtol 1e-5, gradient rtol
     1e-3 / atol 1e-5);
 15. (c) the CLI as a world of one under NCCL (--coordinator
     127.0.0.1:PORT --numProcesses 1 --processId 0 -s 2 --timing) on
     macbeth: its EXR equals RenderSession.write_exr's bit for bit; its
     --timing lines are logged;
 16. (d) checkpoint and resume: macbeth 1280x720, 4 spp "balanced",
     checkpoint_every=2, resumed in a new session from the first save, and
     "regen" at 128x72, 2 spp, every 1 (both on the graphed machines): the
     films equal the uninterrupted ones bit for bit; save and load seconds
     and the file size logged;
 17. (e) B1, the LBVH walk's kernel (csrc/bvh_walk.cu), on three ray sets
     (kernel_variants.ray_sets, LBVH trees): 65,536 macbeth camera rays,
     131,072 rays from their hit points (25% with t_max = 0) and 65,536
     rays through the random 40,000-triangle soup (25% with t_max = 0).
     Against the plain walk (bvh.intersect_bvh_plain; on the soup a
     sixteenth of the rays): triangle ids on >= 99.99% of rays, t/u/v to
     rtol 1e-4 / atol 1e-5, the any-hit entry the closest hit's validity
     exactly, bit-equality reported (and against the plain walk on the
     CPU, 8,192 camera rays).  Against the reference kernel
     (nart_bvh_hit_ref, the walk's first design), both entries on every
     set in turns (reference, new, new, reference): every output the
     reference's bits, each turn's device ms.  The bound of each set from
     the plain walk's own counts (the soup's: a sixteenth's, times 16),
     the share each kernel reaches, and the warp efficiency of the first
     design's walk (the plain walk's pops a ray over the mean of each
     32-ray warp's largest); the plain walk's device ms (stream_ms).  Then
     accel="bvh" against the cluster kernels, both graphed: macbeth at
     1280x720, 1 spp, one capture each, B1 launched twice in every round
     the card ran (closest hit and occlusion) and K1-K4 never, the images
     by test_golden's _compare criteria (tight and golden), the wall
     times side by side, the "bvh" render's device ms (torch.profiler);
     the same "bvh" render with NART_SKIP_SHADOW (path._DEBUG_SKIP_SHADOW:
     B1 once a round run), its wall and device ms beside the unset
     render's; and a "bvh" fwd+bwd (macbeth 320x180 @ 1) on a kept replay
     machine against the per-round replay by phase 22's criteria, B1
     twice a forward round run and never in the backward;
 18. the bench as a user runs it: `python -m nart_tpu_torch.bench` in a
     subprocess at NART_BENCH_SIZE=128, NART_BENCH_SPP=4, once in each
     mode (fwd, fwdbwd): its last line parses with the five keys and a
     finite positive value; the launches it reports (its "# ... launches"
     lines, over its timed runs) are the kernels' launches_bench;
 19. the cornell golden through the kernels (tests/golden/cornell.json with
     tests/fixtures/macbeth's meshes): 64x64, 8 spp, 6 bounces against
     cornell_64x64_8spp.exr with test_cornell_golden's criteria (mean rel
     < 0.02, >= 90% of blocks within 0.1), and 128x128, 64 spp against
     cornell_128x128_64spp.exr with the _64spp criteria (0.015, 0.05,
     95%);
 20. one stream synchronisation per k rounds: the graphed
     path.trace_balanced, after a call that captured its machine's graph,
     under torch.cuda.set_sync_debug_mode("warn") with warnings "always",
     on macbeth (1280x720, 1 spp; an environment light) and on
     testing.distant_scene (128x128, 1 spp; a disk and a distant light),
     and the graphed volume.trace_vol_static on volume_blob (1280x720, 1
     spp): from the first replay on, exactly ceil(rounds / k) reads of the
     runner's alive flag and the end's two reads (rays, rounds), nothing
     else; the set-up's are logged; the same for the "regen" machine
     (macbeth 1280x720, a chunk of 2 spp) and the "spp" machines (macbeth
     and volume_blob 1280x720, one sample), whose end reads rays alone;
     then radiance_weighted_loss_and_grad
     (fwd+bwd) on kept replay machines, macbeth and volume_blob at
     1280x720, 1 spp, the scene on the card: one flag read before the
     first replay, ceil(rounds / k) after it, the end's one read, nothing
     else (the backward's graph replays read nothing);
 21. graphed rounds: simple_glass (the bench's scene) 512x512 @ 16 spp,
     macbeth 1280x720 @ 4 spp and volume_blob 1280x720 @ 4 spp rendered
     through the session's k-round CUDA graph (twice: the first render
     captures) and on the per-round loop (RenderSession(per_round=True)):
     the films the same bits, equal rays and rounds, one capture, K1/K2
     launched once per round run, X1 and the sample+eval launch once
     each; logged: each
     route's wall s, rounds run and ms a round, peak MiB, capture +
     instantiate s, the card's busy share of the graphed forward under
     torch.profiler (which traces the kernels of a replayed graph one by
     one) and its kernels and copies a round; V1 once a round run in the
     volume cell; macbeth's graphed render
     again with the BSDF calls on their plain versions (bsdf_ops'
     sample_plain and sample_eval_plain, bxdf.py op by op): the same film
     bits,
     its kernels and copies a round, the "before" beside the kernels'
     "after"; volume_blob's graphed render again with the flight steps on
     their plain version (vol_ops.flight_steps_plain): the same film bits,
     its kernels and copies a round and device ms beside V1's;
     volume_blob 96x96 @ 32 spp in
     8 chunks of 4: one capture for all, the per-round loop's film; k = 4,
     8 and 16 on macbeth: one session each, their renders in turns, the
     median of 3 each after a warm one.
 22. graphed replay: radiance_weighted_loss_and_grad (fwd+bwd) of macbeth
     1280x720 @ 4 spp, the bench's simple_glass 512x512 @ 16 spp (one
     chunk) and volume_blob 1280x720 @ 4 spp on kept replay machines (a
     warm call that measures the rounds and captures the forward's k-round
     graph and the backward's round graph, then a timed call) against the
     per-round replay (per_round=True) in the same process: the loss to
     rtol 1e-6, every gradient leaf to rtol 1e-5 / atol 1e-7, equal rays
     and rounds, K1/K2 launched once a forward round run on the graphed
     route and once a round on the per-round one (none on the volume;
     there V1 once a forward round and V1 and V2 once each in the
     backward's round graph, V2 once a round on the per-round replay);
     the large-table look-ups (S2) launched on both routes of macbeth and
     volume_blob and not on simple_glass, indexing_backward_kernel*
     launched 0 times in the graphed call's profile; logged: each route's
     wall s and rate, rounds run and live, capture s, peak and held MiB,
     the card's busy share of the graphed call, its top device operations
     with the shares of indexing_backward_kernel*, of the look-up kernels,
     of the sorts and of the memsets;
 23. small-table look-ups (csrc/small_lut.cu) against their plain versions
     on the card: N in {65,536, 131,072} lanes, tables of n in {1, 3, 4,
     16, 64} rows of 1 or 3 values, indices uniform, all on one row, and
     the mesh ids of 65,536 macbeth camera rays' hits.  The forward kernel
     gives the plain gather's bits, and, reading 16 tables of 1 to 8
     values in one launch (nart_lut_gather_many), the bits of one launch a
     table; the backward kernel (nart_lut_gather_bwd_many, all of a
     look-up's small tables in one launch) gives the bits of the
     two-launch route (nart_lut_gather_bwd, one table a call) table by
     table, is within rtol 1e-5 / atol 1e-6 of a float64 index_add_ of
     the same cotangents (positive ones; for signed ones, whose sums
     cancel, within atol plus rtol times the float64 sum of their
     magnitudes), and for integer
     cotangents in [-8, 8] (float32 sums exact in any order) gives the
     int64 index_add_'s bits; the same bits on a second launch and from a
     CUDA graph's replay: one table at a time in every case above, the
     rows of 1 and of 3 together, a 16-table mix of 1 to 64 rows of 1 to
     4 values, make_bsdf's five trainable per-mesh tables at macbeth's
     mesh ids and a light's le and intensity on one row at 131,072 lanes.
     Logged at three shapes (macbeth's mesh ids, the bench's one light
     row at 131,072 lanes, 64 rows): the device ms of each kernel (and its
     ms per call), of the two-launch route, of the plain versions
     (table[idx]; index_put_(accumulate=True), whose indexing_backward
     kernel is the plain backward), of F.embedding, embedding_dense_backward
     and zeros + index_add_ (the library yardsticks, timed only), and the
     bound; then the many-table forward at make_bsdf's six per-mesh tables
     and area_pack_sample's ten light fields: one launch against one
     launch a table, the plain gathers and F.embedding a table; then the
     many-table backward at the 16-table mix, make_bsdf's five and the
     light's two: one launch against, a table at a time, the two-launch
     route, the plain backward, embedding_dense_backward and zeros +
     index_add_, with the graph nodes a call (one kernel node, else it
     fails) and the bound;
 24. large-table look-ups (the forward of csrc/small_lut.cu, the backward
     of csrc/large_lut.cu) against their plain versions on the card at the
     main path's shapes: macbeth's env map (65,536 lanes, 8,192 rows of 3)
     and tex_data (65,536 lanes, 9,047,075 rows of 3), volume_blob's
     density cells (32,768 lanes, 29,791 rows of 8); rows uniform, all on
     one row, long runs (half the lanes on one row, a quarter on another)
     and masked (half the lanes -1, clamped to row 0).  The forward gives
     the plain gather's bits; the backward's radix sort leaves the order
     of torch.sort(stable=True) and of select.radix_order_plain; the
     backward gives the bits of the sorted route (torch.sort, then the same
     segmented sum: select.lut_gather_large_bwd_sorted_cuda), is within
     atol 1e-6 plus rtol 1e-5 times the float64 sum of the cotangents'
     magnitudes of a float64 index_add_, gives the int64 index_add_'s bits
     for integer cotangents in [-8, 8], and the same bits on a second
     launch and from a CUDA graph's replay.  Logged at each shape (uniform,
     and one row): the device ms of each kernel (and ms per call), of PR
     10's route, of the plain versions, of F.embedding,
     embedding_dense_backward and zeros + index_add_ (timed only), the
     bound, and the graph nodes a backward call makes (the nodes of a
     CUDA graph that captures one call: the memset and one launch a radix
     pass, at most 5); then both backward kernels, the
     small-table one (S1's two-launch route: the many-table kernel takes
     at most 64 rows) and the large-table one (S2), timed side by side
     on 65,536 uniform lanes over tables of 3 to 65,536 rows of 3 and on
     the bench's one light row (131,072 lanes): the measured ground for
     select.AUTO_LUT_ROWS, the row count up to which the small-table
     backward is taken;
 25. a large mesh from file to film: a displaced torus of 512 x 1,024
     quads (1,048,576 triangles, normals and uvs, from a seed) written as a
     .geo into a temporary directory, with a scene JSON of macbeth's
     camera, env light and session, the torus (diffuse) and a glass sphere
     in its hole.  (a) the .geo loaded by the C++ core and by numpy: v, n
     and uv the same bits, both times; (b) the scene's LBVH by the core
     and by numpy: node_lo, node_hi, order and tri_v the same bits, both times;
     (c) the cluster build's time, under the large-mesh policy (clusters
     of 64, median split, 256 superclusters); (d) graphed renders at
     1280x720 @ 1 spp through render_scene_file on the card, accel
     "cluster" (K1/K2 once a round run) and "bvh" (B1 twice): wall, device
     ms (torch.profiler), rounds, peak MiB, launches; (e) K1's and B1's
     hits on the 921,600 pixel-centre camera rays (tri on >= 99.99%, t/u/v
     rtol 1e-4 / atol 1e-5) and the two films by macbeth's golden criteria
     against each other; (f) the CLI (`python -m nart_tpu_torch.cli`'s
     main, in this process) on the scene at 1280x720 @ 1 with --timing:
     its phases' seconds.  The "bvh" render is run twice, the capture and
     the counted, profiled one that is also timed (its wall traced; the
     "cluster" render's is untraced).  Host times beside the host's CPU
     (/proc/cpuinfo);
 26. scaling evidence: `nart_tpu_torch.scaling_evidence` at its defaults
     (simple_glass 256x256 @ 64 spp) with 4 and 8 ranks run one after
     another on the card: per-rank rounds, drain-tail rounds, rays and
     device ms, the balance and the drain fraction; the ranks' rays sum to
     a one-process render's;
 27. the BSDF kernels (csrc/bsdf.cu: X1 nart_bsdf_sample, the sample+eval
     launch nart_bsdf_sample_eval (X2's redesign), X2's first design
     nart_bsdf_eval, X3 nart_bsdf_f_bwd) against their plain versions on
     the card: 65,536 lanes of each of tests/test_torch_shading.py's LOBES
     kinds (from a seed) and the two BSDF calls of a mid-trace round
     of macbeth 1280x720 and of simple_glass 512x512 (per-round renders
     of 1 spp: of their first 8 rounds, the one with the most live lanes
     past their first bounce; strategy A's sample with strategy B's eval,
     the scatter's sample): X1's, X2's and the sample+eval launch's
     outputs the plain version's bits on every lane, X1's also the bits of
     its first design (nart_bsdf_sample_ref), the sample+eval launch's
     nine also those of X1 followed by X2 (at the LOBES sets' eval
     directions and at the rounds' strategy B directions); X3 (both
     modes, random cotangents) within
     rtol 1e-5 / atol 1e-6 of the float64 VJP of the plain version with wi
     held fixed (bsdf_ops.sample_at_bwd_plain, eval_bwd_plain), which must
     be finite on every lane, on every lane but those whose float64
     forward takes another branch (counted); X3's first design
     (nart_bsdf_f_bwd_ref) read beside it (its distance from the float64
     VJP, the share of its values X3's bits); the plain float32 VJP
     measured against the same float64 VJP, not held to it.
     At macbeth's mid-trace calls (65,536 lanes): each kernel's device ms
     and ms per call, its plain version's device ms (the plain VJP's over
     eager calls), the bound (the larger of the bytes over 3.35 TB/s and
     BSDF_OPS's counted operations over the peak rates; library none;
     the bytes what each lane's lobe codes read, bsdf_bytes, beside every
     input tensor once); X1 and X3 against their first designs, and the
     sample+eval launch against X1 then X2 (at 65,536 lanes and at the
     same lanes four times over, 262,144), in turns (reference, new, new,
     reference), device ms each.
 28. the volume's flight-step kernels (csrc/vol_step.cu: V1 nart_vol_steps,
     a round's k flight steps, and V2 nart_vol_steps_bwd, their backward)
     against their plain versions on the card: volume_blob 1280x720 @ 4's
     static-machine states (32,768 lanes) at its first round and at round
     VOL_MID_ROUND of a per-round render, and testing.vol_lane_set's edge
     set at 32,768 lanes (every branch of a step, the null event at p_null
     = 0, null events near the majorant).  For k = 1 and 4: V1's every
     output (the state, died, esc, the segment starts) the plain steps'
     bits and its first design's (nart_vol_steps_ref) on every lane, the
     starts also added into an accumulator; V2's every output its first
     design's (nart_vol_steps_bwd_ref) bits on every lane, and within
     rtol 1e-5 / atol 1e-6 of the float64 VJP of the plain steps
     (vol_ops.flight_steps_vjp_reference) on every lane whose float64
     forward chose the float32 events (the others counted), finite
     everywhere; the plain float32 VJP's distance from it logged.  At the
     mid-render round, k = 4: V1's (with the rays' accumulator, one graph
     node a call), V2's, the plain steps' and V2's torch twin's
     (vol_ops.flight_steps_vjp_plain) device ms, the bound (bytes: each
     per-lane input and output once and a 32-byte cell row a sampling
     lane-step; library none); V1 and V2 against their first designs in
     turns (reference, new, new, reference), the node floor (an empty
     kernel of V1's grid, a one-element fill) by the same timer, the
     graph nodes of a call; the redesign's sine and cosine against sinf
     and cosf on every float in [-2 pi, 2 pi].  Phase 2 fails where the
     shipped V1 or V2 has a stack frame or spills.
With --turns PARENT_TREE (a checkout of the parent commit, e.g. unpacked
with git archive into the git-ignored out/): phase 22's three cells, each
tree in a fresh process (`--turn TREE OUT`, which imports TREE's
nart_tpu_torch), in turns P, C, C, P: the graphed forward film and the
graphed fwd+bwd's loss, leaves, rays and rounds against the first P
turn's (the films, loss, rays and rounds bit for bit, the leaves to rtol
1e-5 / atol 1e-7), with each turn's wall s and device ms (torch.profiler).
With --witness: macbeth's fwd+bwd of phase 22 with the BSDF backward by X3,
by the plain float32 VJP and by the float64 VJP (leaf_witness): on each
leaf value where X3 and the plain VJP differ past that tolerance, which
lies nearer the float64 one.  With --vol-witness: the same for
volume_blob's fwd+bwd and the flight steps' backward (V2, float32
autograd of the plain steps, the float64 VJP; vol_leaf_witness).
The line before the last is the kernels' JSON record (`launches`: a
traversal kernel's and X1's and the sample+eval launch's in phase 5's
forward, a look-up kernel's and X3's in phase 6's fwd+bwd, B1's in phase
17's graphed "bvh" render; each must be > 0; the BSDF kernels'
forward_kernels_a_round: phase 21's macbeth count with the BSDF calls'
plain versions and with the kernels; X1's and X3's reference_ms and
turns_ms: their first designs' device ms, in phase 27's turns; the
sample+eval launch's: X1 then X2's, and at 262,144 lanes (_x4), and
first_design_ms: X2's first design alone;
launches_modes: phase 8's graphed "regen" and "spp" renders,
launches_sharded: phases 13-15, launches_bench: phase 18,
launches_large_mesh: phase 25's counted renders, every kernel's the
cluster one's but B1's, the bvh one's; V1's `launches` phase 10's
volume forward, V2's phase 11's volume fwd+bwd, launches_volume both,
their forward_kernels_a_round phase 21's volume_blob count with the
flight steps' plain version and with V1, their reference_ms, turns_ms,
graph_nodes, node_floor_ms, fill_ms and ptxas phase 28's and phase 2's,
V1's trig_mismatches phase 28's); the
last line is {"ok": true, "device": {...}}.  Needs the repository
checkout (it imports nart_tpu_torch from beside this file); imports nothing
of JAX.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MACBETH_DIR = os.path.join(HERE, "tests", "fixtures", "macbeth")
MACBETH = os.path.join(MACBETH_DIR, "macbeth.json")
GOLDEN = os.path.join(HERE, "tests", "golden", "macbeth_96x96_8spp.exr")
VOLUME = os.path.join(HERE, "tests", "golden", "volume_blob.json")
VOLUME_GOLDEN = os.path.join(HERE, "tests", "golden",
                             "volume_blob_96x96_32spp.exr")
CORNELL = os.path.join(HERE, "tests", "golden", "cornell.json")
SOURCE = "nart_tpu_torch/csrc/cluster_hit.cu"
LUT_SOURCE = "nart_tpu_torch/csrc/small_lut.cu"
LARGE_SOURCE = "nart_tpu_torch/csrc/large_lut.cu"
BVH_SOURCE = "nart_tpu_torch/csrc/bvh_walk.cu"
BSDF_SOURCE = "nart_tpu_torch/csrc/bsdf.cu"
VOL_SOURCE = "nart_tpu_torch/csrc/vol_step.cu"
CORE_SOURCE = "nart_tpu_torch/csrc/core.cpp"  # host code: no kernel
DEVICE = "cuda"  # every phase runs on the card
LARGE_SITES = ("nart_tpu/materials.py:60", "nart_tpu/lights.py:73",
               "nart_tpu/media.py:81")
REPLACES = {"closest_hit": "nart_tpu/pallas_accel.py:605",  # _kernel
            "any_hit": "nart_tpu/pallas_accel.py:773",  # _kernel_any
            "closest_hit_stats": "tools/kernel_stats.py:27",  # _kernel_stats
            # the same counters, on _kernel_any's walk
            "any_hit_stats": "tools/kernel_stats.py:27",
            # no Pallas kernel: the one-hot look-up small_lut (and
            # materials.mesh_luts, nart_tpu/materials.py:96), forward and
            # its transpose
            # the forward also stands for XLA's gather behind the plain
            # gathers of the large tables (the texture table, the env map
            # and light textures above 64 texels, the density cells)
            "lut_gather": ", ".join(("nart_tpu/select.py:59",) + LARGE_SITES),
            "lut_gather_bwd": "nart_tpu/select.py:59",
            # no Pallas kernel: XLA's scatter-add, the transpose of those
            # plain gathers
            "lut_gather_large_bwd": ", ".join(LARGE_SITES),
            # no Pallas kernel: the "bvh" kind's walk, XLA's while_loop
            "bvh_hit": "nart_tpu/accel.py:171",
            # no Pallas kernel: the BSDF lobe mixture, which XLA fuses:
            # bsdf_sample_f (with _lobe_sample :566, _vndf_sample :212),
            # bsdf_f with bsdf_pdf, and XLA's autodiff of their f
            "bsdf_sample": "nart_tpu/bxdf.py:618",
            # X2's redesign: X1's sample and bsdf_f with bsdf_pdf (X2's
            # first design, nart_bsdf_eval, is now a reference) in one launch
            "bsdf_sample_eval": "nart_tpu/bxdf.py:618, nart_tpu/bxdf.py:594, "
                                "nart_tpu/bxdf.py:602",
            "bsdf_f_bwd": "nart_tpu/bxdf.py:618, nart_tpu/bxdf.py:594",
            # no Pallas kernel: the volume's flight step, _make_vol_step's
            # step (:59-163), which XLA fuses with the NART_VOL_FUSE steps
            # of a round, and XLA's autodiff of it
            "vol_steps": "nart_tpu/integrators/volume.py:59",
            "vol_steps_bwd": "nart_tpu/integrators/volume.py:59"}
KERNELS = tuple(REPLACES)
TRAVERSAL = KERNELS[:4]  # the kernels of cluster_hit.cu
LARGE = ("lut_gather_large_bwd",)  # the kernel of large_lut.cu
# the kernels of bsdf.cu a path launches
BSDF = ("bsdf_sample", "bsdf_sample_eval", "bsdf_f_bwd")
# X1's, X2's and X3's first designs (no path launches them; X2's,
# nart_bsdf_eval, is eval_f_pdf's kernel for other callers)
BSDF_REF = ("bsdf_sample_reference", "bsdf_eval", "bsdf_f_bwd_reference")
# the kernels of vol_step.cu: V1 (a round's flight steps), V2 (their
# backward)
VOL = ("vol_steps", "vol_steps_bwd")
SOURCES = {k: SOURCE if k in TRAVERSAL else LARGE_SOURCE if k in LARGE
           else BVH_SOURCE if k == "bvh_hit" else BSDF_SOURCE if k in BSDF
           else VOL_SOURCE if k in VOL else LUT_SOURCE for k in KERNELS}
# the profiler's names of the look-up kernels, and of PyTorch's backward of
# a gather (the plain version's)
LUT_NAMES = ("lut_gather_many_kernel", "lut_bwd_many_kernel",
             "lut_partial_kernel", "lut_final_kernel")
LARGE_NAMES = ("lut_sort_kernel", "lut_seg_kernel", "lut_carry_kernel")
BSDF_NAMES = ("bsdf_sample_kernel", "bsdf_sample_eval_kernel",
              "bsdf_eval_kernel", "bsdf_f_bwd_kernel")
# torch.sort's kernels (the path round's ray sort, and S2's order of lanes)
SORT_NAMES = ("RadixSort", "radixSort", "sortKeyValue", "SegmentedSort",
              "bitonicSort")
INDEXING_BACKWARD = "indexing_backward"
TRI_AGREE = 0.9999
RTOL, ATOL = 1e-4, 1e-5
# phase 25's torus: quads around the tube, around the ring; its seed
LARGE_QUADS = (512, 1024)
LARGE_SEED = 15
LARGE_RENDER = (1280, 720, 1)  # its renders' width, height, spp
# published peaks of one H100 SXM: HBM bytes/s, float32 FLOP/s outside the
# tensor cores
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
# float operations of cluster_hit.cu, counted from the source: slab() does
# 6 subtractions, 6 multiplies, 12 min/max and 1 compare; tri_test() does
# 76 when it runs to the end: 60 for the edge functions (21 to translate
# and shear the corners, 9 for each of the three, 12 for the sign and zero
# checks), 14 for the plane equation and the t-window (two 3-term dot
# products, one subtraction, one division, two compares), 2 for esum.  The
# bound charges a triangle the 14: the least that rejects it, whichever
# part a kernel runs first (cluster_hit.cu runs the edge functions first)
SLAB_OPS, TRI_OPS_MIN, TRI_OPS_FULL = 25, 14, 76


def log(msg):
    print(msg, flush=True)


def call_ms(fn, reps, warmup=2):
    """Per call, host included: the median milliseconds of fn() over reps
    single calls, each between two CUDA events (a call whose device work
    is shorter than its host work reads the host: what an eager caller,
    such as a per-round loop, pays)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _replay_ms(run, launches, replays):
    """{"ms", "min", "max"}: the median, min and max over `replays` runs of
    run() between two CUDA events, over `launches`."""
    import torch

    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return {"ms": statistics.median(times), "min": min(times),
            "max": max(times), "launches": launches}


def device_ms(fn, launches=100, replays=5):
    """Device time of a call of fn: two warm calls on a side stream, then
    `launches` calls captured into one CUDA graph and the graph replayed
    (once to warm, then `replays` times between CUDA events): replay ms
    over launches, no host work between the launches.  Returns {"ms" (the
    median), "min", "max", "launches", "method": "graph"}.  fn must not
    read the card from the host (a capture refuses that)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = _replay_ms(graph.replay, launches, replays)
    del graph
    return dict(out, method="graph")


def stream_ms(fn, launches=3, replays=3):
    """device_ms for a call that reads the card from the host (and so
    cannot be captured): `launches` eager calls between two CUDA events, a
    call long enough that the host's share is small.  "method": "stream"."""
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(launches):
            fn()

    return dict(_replay_ms(run, launches, replays), method="stream")


def launches_for(per_call_ms, target_ms=20.0, most=100):
    """Calls to capture into one timed graph: about target_ms of work, 3 to
    `most` calls."""
    return max(3, min(most, int(target_ms / max(per_call_ms, 1e-3))))


def kernel_ms(fn, reps):
    """A call's readings: its device ms (device_ms over about 20 ms of
    calls) and, per call with the host included (call_ms), ms_per_call."""
    per_call = call_ms(fn, reps)
    t = device_ms(fn, launches_for(per_call))
    return dict(t, ms_per_call=per_call)


def fmt(t):
    """A device reading for the log: median [min-max] ms, per call."""
    s = f"{t['ms']:.4f} [{t['min']:.4f}-{t['max']:.4f}] ms"
    if "ms_per_call" in t:
        s += f" (per call, host included: {t['ms_per_call']:.4f})"
    return s


def random_rays(n, rng, center, spread):
    o = (center + rng.normal(size=(n, 3)) * spread).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def compare_closest(name, hk, hp):
    """Kernel hit record vs plain: returns (agree fraction, max abs err)."""
    import torch

    agree = hk.tri == hp.tri
    frac = float(agree.float().mean())
    both = agree & (hp.tri >= 0)
    err = 0.0
    for k in ("t", "u", "v"):
        a, b = getattr(hk, k)[both], getattr(hp, k)[both]
        if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
            bad = (~torch.isclose(a, b, rtol=RTOL, atol=ATOL)).sum()
            raise AssertionError(f"{name}: {k} differs on {int(bad)} rays")
        if a.numel():
            err = max(err, float((a - b).abs().max()))
    if frac < TRI_AGREE:
        raise AssertionError(f"{name}: tri agrees on only {frac:.6f}")
    return frac, err


def compare_stats(name, acc, rays, hit_kernel, any_hit=False):
    """Counter kernel vs plain on `rays`, for the closest-hit walk
    (hit_kernel: the closest-hit kernel's Hit) or the any-hit walk
    (hit_kernel: the any-hit kernel's occlusion): returns (the kernel's
    stats, max abs err of its t or occlusion)."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, kernel_stats

    sk = kernel_stats.traversal_stats(*rays, acc, any_hit=any_hit)
    plain = ca.any_hit_stats_plain if any_hit else ca.closest_hit_stats_plain
    sp = plain(*rays, acc)
    # `together` too: it is the size of the group that tested the cluster,
    # which follows from the walk alone
    for k in ("visited", "slabs", "tested", "together", "sc_tests"):
        bad = int((getattr(sk, k) != getattr(sp, k)).sum())
        if bad:
            raise AssertionError(f"{name}: counter {k} differs on {bad} rays")
    if any_hit:
        if not torch.equal(sk.occluded, hit_kernel):
            raise AssertionError(f"{name}: stats occlusion != any-hit kernel's")
        agree = float((sk.occluded == sp.occluded).float().mean())
        if agree < TRI_AGREE:
            raise AssertionError(f"{name}: occlusion vs plain {agree:.6f}")
        err = float((sk.occluded != sp.occluded).any())
    else:
        if not torch.equal(sk.t, hit_kernel.t):
            raise AssertionError(f"{name}: stats t != closest-hit kernel's t")
        both = torch.isfinite(sk.t) & torch.isfinite(sp.t)
        if not torch.equal(torch.isfinite(sk.t), torch.isfinite(sp.t)):
            raise AssertionError(f"{name}: stats hit set differs from plain")
        err = (float((sk.t[both] - sp.t[both]).abs().max()) if both.any()
               else 0.0)
        if err > ATOL:
            raise AssertionError(f"{name}: stats t off by {err}")
    s = kernel_stats.summarize(sk)
    log(f"    counters {name}: supercluster tests {s['sc_tests']:.3f}, "
        f"visited {s['visited_sc']:.3f}, slab tests "
        f"{s['slab_tests']:.3f}, clusters tested {s['tri_tests']:.3f} per "
        f"ray; rays together on a cluster {s['lanes_per_test']:.2f}/32; all "
        "five counters equal plain on every ray")
    return sk, err


def bound(acc, n_rays, out_bytes_per_ray, stats):
    """Least time the card could take (ms) and what sets it.

    Bytes: each ray read once (o, d, t_min, t_max: 32 B), each output
    written once, the accel arrays once.  Operations: the counters of the
    kernel's own walk on these very rays (`stats`; a ray that never joins
    the walk counts nothing) times the arithmetic of one slab test and of
    the least part of a triangle test that can reject a triangle
    (TRI_OPS_MIN; the kernel's own order pays 60 before it rejects, and a
    hit costs TRI_OPS_FULL, neither of which is counted, so the bound errs
    low).  Slab tests: the supercluster tests the ray made (an
    any-hit ray makes none behind the supercluster that occludes it), and
    the member tests where sc_size > 1 (where it is 1 a member's box is its
    supercluster's and the kernel tests it once).  Triangles: every row of
    each cluster the ray tested; but of the cluster that occludes an
    any-hit ray only the row that does: the query may stop at its first
    hit, whichever row it meets first."""
    accel_bytes = sum(x.numel() * x.element_size() for x in
                      (acc.planes, acc.aabb, acc.sc_aabb, acc.morder,
                       acc.order))
    nbytes = n_rays * (32 + out_bytes_per_ray) + accel_bytes
    slabs = int(stats.sc_tests.sum())
    if acc.sc_size > 1:
        slabs += int(stats.slabs.sum())
    ended = int(stats.occluded.sum()) if hasattr(stats, "occluded") else 0
    tris = (int(stats.tested.sum()) - ended) * acc.csize + ended
    ops = SLAB_OPS * slabs + TRI_OPS_MIN * tris
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def camera_rays(sc, n, rng, device):
    """(o, d, t_min, t_max) of n rays through random pixels of the scene's
    camera at 1280x720 (t in [0, inf))."""
    import torch

    from nart_tpu_torch import camera

    px = torch.from_numpy(rng.integers(0, 1280, n))
    py = torch.from_numpy(rng.integers(0, 720, n))
    jit = torch.from_numpy(rng.random((n, 2), dtype=np.float32))
    o, d = camera.cast_rays(sc.cam_to_world, sc.fov, 1280, 720, px, py, jit)
    return (o.to(device), d.to(device), torch.zeros(n, device=device),
            torch.full((n,), float("inf"), device=device))


def kernel_checks(device, sizes):
    """Phase 3.  Returns the per-kernel records at the main-path shapes
    (the macbeth rays)."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, kernel_stats, scene

    rng = np.random.default_rng(0)
    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    acc = ca.build_clusters(sc.tri_v.numpy()).to(device)
    log(f"macbeth: {sc.n_tris} triangles, {acc.n_clusters} clusters of "
        f"{acc.csize}, {acc.n_sc} superclusters")

    # (a1) camera rays through random pixels of the 1280x720 view
    n = sizes["camera_rays"]
    cam = camera_rays(sc, n, rng, device)
    o, d = cam[:2]
    hk = ca.intersect_clusters(*cam, acc)
    hp = ca.closest_hit_plain(*cam, acc)
    frac, err_c = compare_closest("closest-hit camera", hk, hp)
    log(f"(a) closest-hit, {n} camera rays: tri agree {frac:.6f}, "
        f"hits {int((hp.tri >= 0).sum())}, max abs err {err_c:.3g}")
    st_cam, err_s = compare_stats("camera rays", acc, cam, hk)

    # (a2) random-direction rays from the camera rays' hit points
    m = sizes["shadow_rays"]
    hit_idx = torch.nonzero(hp.tri >= 0)[:, 0]
    pick = hit_idx[torch.from_numpy(rng.integers(0, len(hit_idx), m)).to(device)]
    p = o[pick] + d[pick] * hp.t[pick, None]
    d2 = torch.from_numpy(random_rays(m, rng, 0.0, 1.0)[1]).to(device)
    v = sc.tri_v.to(device)[hp.tri[pick]]
    gn = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    side = torch.where((gn * d2).sum(-1) > 0, 1.0, -1.0)
    gn = gn / gn.norm(dim=-1, keepdim=True)
    o2 = (p + gn * (1e-3 * side)[:, None]).contiguous()
    t2 = torch.from_numpy(np.where(
        rng.random(m) < 0.25, 0.0,
        np.where(rng.random(m) < 0.5, np.inf, rng.exponential(3.0, m)),
    ).astype(np.float32)).to(device)
    sh = (o2, d2, torch.zeros(m, device=device), t2)
    hk2 = ca.intersect_clusters(*sh, acc)
    hp2 = ca.closest_hit_plain(*sh, acc)
    frac2, err_c2 = compare_closest("closest-hit secondary", hk2, hp2)
    occ_k = ca.intersect_clusters_any(*sh, acc)
    occ_p = ca.any_hit_plain(*sh, acc)
    if not torch.equal(occ_k, hk2.tri >= 0):
        raise AssertionError("any-hit != closest-hit validity on "
                             f"{int((occ_k != (hk2.tri >= 0)).sum())} rays")
    occ_agree = float((occ_k == occ_p).float().mean())
    if occ_agree < TRI_AGREE:
        raise AssertionError(f"any-hit vs plain agrees on {occ_agree:.6f}")
    err_a = float((occ_k.float() - occ_p.float()).abs().max())
    log(f"(a) {m} rays from hit points (25% t_max=0): tri agree "
        f"{frac2:.6f}, occluded {int(occ_k.sum())}, any-hit vs plain "
        f"{occ_agree:.6f}, any-hit == closest-hit validity: exact")
    _, err_s2 = compare_stats("secondary rays", acc, sh, hk2)
    _, err_a1 = compare_stats(
        "camera rays, any-hit walk", acc, cam,
        ca.intersect_clusters_any(*cam, acc), any_hit=True)
    st_any, err_a2 = compare_stats("secondary rays, any-hit walk", acc, sh,
                                   occ_k, any_hit=True)

    # (b) random 40k-triangle soup: the >= 32k policy
    nt = sizes["soup_tris"]
    tri = (rng.normal(size=(nt, 3, 3)) * 0.3
           + rng.normal(size=(nt, 1, 3)) * 8.0).astype(np.float32)
    acc_b = ca.build_clusters(tri).to(device)
    nb = sizes["soup_rays"]
    ob, db = random_rays(nb, rng, 0.0, 10.0)
    rb = (torch.from_numpy(ob).to(device), torch.from_numpy(db).to(device),
          torch.zeros(nb, device=device),
          torch.from_numpy(np.where(rng.random(nb) < 0.25, 0.0, np.inf)
                           .astype(np.float32)).to(device))
    hkb = ca.intersect_clusters(*rb, acc_b)
    hpb = ca.closest_hit_plain(*rb, acc_b)
    fracb, _ = compare_closest("closest-hit soup", hkb, hpb)
    occb = ca.intersect_clusters_any(*rb, acc_b)
    if not torch.equal(occb, hkb.tri >= 0):
        raise AssertionError("soup: any-hit != closest-hit validity")
    log(f"(b) soup {nt} triangles (csize {acc_b.csize}, {acc_b.n_clusters} "
        f"clusters, sc_size {acc_b.sc_size}), {nb} rays: tri agree "
        f"{fracb:.6f}, hits {int((hpb.tri >= 0).sum())}, any-hit exact")
    _, err_sb = compare_stats("soup", acc_b, rb, hkb)
    _, err_ab = compare_stats("soup, any-hit walk", acc_b, rb, occb,
                              any_hit=True)

    # times at the main-path shapes: each kernel's device ms (many launches
    # in one graph) and its ms per call with the host included; the plain
    # versions (tens to hundreds of ms a call) one call a graph, but the
    # counter walks', which read the card from the host (a capture refuses
    # that), a few eager calls between two events
    reps = sizes["reps"]
    t_k1 = kernel_ms(lambda: ca.intersect_clusters(*cam, acc), reps)
    t_p1 = device_ms(lambda: ca.closest_hit_plain(*cam, acc), 1, 3)
    t_k2 = kernel_ms(lambda: ca.intersect_clusters_any(*sh, acc), reps)
    t_p2 = device_ms(lambda: ca.any_hit_plain(*sh, acc), 1, 3)
    t_kb = kernel_ms(lambda: ca.intersect_clusters(*rb, acc_b), reps)
    t_pb = device_ms(lambda: ca.closest_hit_plain(*rb, acc_b), 1, 3)
    t_k3 = kernel_ms(lambda: kernel_stats.traversal_stats(*cam, acc), reps)
    t_p3 = stream_ms(lambda: ca.closest_hit_stats_plain(*cam, acc))
    t_k4 = kernel_ms(lambda: kernel_stats.traversal_stats(*sh, acc,
                                                          any_hit=True),
                     reps)
    t_p4 = stream_ms(lambda: ca.any_hit_stats_plain(*sh, acc))
    # the closest-hit kernel once more, after the counter kernel ran: the
    # template must not have changed it
    t_k1b = kernel_ms(lambda: ca.intersect_clusters(*cam, acc), reps)
    log(f"time closest-hit {n} camera rays: kernel {fmt(t_k1)}, plain "
        f"{fmt(t_p1)}")
    log(f"time any-hit {m} secondary rays: kernel {fmt(t_k2)}, plain "
        f"{fmt(t_p2)}")
    log(f"time closest-hit soup {nb} rays: kernel {fmt(t_kb)}, plain "
        f"{fmt(t_pb)}")
    log(f"time counter kernel {n} camera rays: kernel {fmt(t_k3)}, plain "
        f"{fmt(t_p3)}; closest-hit again {fmt(t_k1b)}")
    log(f"time any-hit counter kernel {m} secondary rays: kernel "
        f"{fmt(t_k4)}, plain {fmt(t_p4)}")

    def rec(t, t_plain):
        return dict(ms=t["ms"], ms_min=t["min"], ms_max=t["max"],
                    ms_per_call=t["ms_per_call"], plain_ms=t_plain["ms"])

    records = {
        "closest_hit": dict(max_abs_err=max(err_c, err_c2), **rec(t_k1, t_p1),
                            **bound(acc, n, 20, st_cam)),
        "any_hit": dict(max_abs_err=err_a, **rec(t_k2, t_p2),
                        **bound(acc, m, 1, st_any)),
        "closest_hit_stats": dict(max_abs_err=max(err_s, err_s2, err_sb),
                                  **rec(t_k3, t_p3),
                                  **bound(acc, n, 24, st_cam)),
        "any_hit_stats": dict(max_abs_err=max(err_a1, err_a2, err_ab),
                              **rec(t_k4, t_p4),
                              **bound(acc, m, 21, st_any)),
    }
    for k, r in records.items():
        r["library_ms"] = None  # no PyTorch call intersects rays with a scene
        log(f"bound {k}: {r['bound_ms']:.6f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes; {r['operations']} operations): the kernel "
            "reaches "
            f"{100.0 * r['bound_ms'] / r['ms']:.3f}% of it")
    return records


def block_compare(ours, ref, mean_tol, block_tol, block_frac,
                  label="golden"):
    """tests/test_golden.py _compare: image mean and 16x16 block means."""
    r, o = ref[..., :3], ours[..., :3]
    mean_rel = abs(o.mean() - r.mean()) / max(r.mean(), 1e-6)
    h, w = r.shape[:2]
    rb = r[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    ob = o[: h - h % 16, : w - w % 16].reshape(h // 16, 16, w // 16, 16, 3)
    rel = np.abs(ob.mean((1, 3, 4)) - rb.mean((1, 3, 4))) / np.maximum(
        rb.mean((1, 3, 4)), 0.05)
    frac = float((rel < block_tol).mean())
    log(f"{label}: mean rel {mean_rel:.5f} (< {mean_tol}), blocks within "
        f"{block_tol}: {frac:.3f} (>= {block_frac}), worst {rel.max():.4f}")
    if not (mean_rel < mean_tol and frac >= block_frac):
        raise AssertionError(f"{label} comparison failed")


def golden_check(device, size):
    """Phase 4."""
    from nart_tpu_torch import cuda_build, exr, render, scene

    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    params = render.resolve_params(
        {}, dict(image_width=size[0], image_height=size[1], spp=size[2]))
    before = dict(cuda_build.launch_counts)
    sess = render.RenderSession(sc, params, device)
    ours = sess.image().cpu().numpy()
    grew = {k: cuda_build.launch_counts[k] - before[k] for k in before}
    log(f"golden render {size[0]}x{size[1]} {size[2]} spp: {sess.stats}, "
        f"launches {grew}")
    if min(grew["closest_hit"], grew["any_hit"]) <= 0:
        raise AssertionError(f"kernels not launched by the render: {grew}")
    ref = exr.read(GOLDEN)
    if ref.shape != ours.shape:
        raise AssertionError(f"golden shape {ref.shape} vs {ours.shape}")
    block_compare(ours, ref, 0.03, 0.12, 0.95)


def main_path(overrides):
    """Phase 5: returns the launch counts of the timed run."""
    import torch

    from nart_tpu_torch import cuda_build, exr, film, render
    from nart_tpu_torch import rounds as rounds_mod

    params, sess = next(render.render_scene_file(MACBETH, overrides))
    log(f"main path: macbeth.json {params.image_width}x{params.image_height}"
        f" at {params.spp} spp (the scene's own session has 256 spp; cut to "
        f"{params.spp} for the smoke's time), filterWidth "
        f"{params.filter_width}, rougheningFactor {params.roughening_factor}")
    t0 = time.perf_counter()
    sess.render()
    torch.cuda.synchronize()
    log(f"warm run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    before = machine_totals(sess.machines)
    t0 = time.perf_counter()
    buf = sess.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_build.launch_counts)
    after = machine_totals(sess.machines)
    ran = after["rounds_run"] - before["rounds_run"]
    rays, rounds = sess.stats["rays"], sess.stats["rounds"]
    log(f"timed run {dt:.4f} s, {rounds} rounds, {rays} rays (algorithmic), "
        f"{rays / dt / 1e6:.4f} Mrays/s, launches {counts}; "
        f"{after['replays'] - before['replays']} replays of the session's "
        f"one graph ({after}), {ran} rounds run on the card")
    # the traversal kernels run once in every round the card runs, the
    # rounds past the end of the last replay (< k) included
    if not (counts["closest_hit"] == counts["any_hit"] == ran
            and rounds <= ran < rounds + rounds_mod.ROUNDS_PER_CHECK
            and after["captures"] == 1):
        raise AssertionError(f"launches {counts}, {ran} rounds run, "
                             f"{rounds} rounds, {after}")
    check_bsdf_launches("forward path", counts, ran)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
        "MiB")
    img = film.finalize(buf, params.image_width, params.image_height,
                        sess.filter_bounds)
    with tempfile.TemporaryDirectory() as tmp:
        path = sess.write_exr(os.path.join(tmp, "macbeth"), img=img)
        back = exr.read(path)
    mean = float(img[..., :3].mean())
    if not (bool(torch.isfinite(img).all()) and mean > 0.0):
        raise AssertionError(f"image not finite with nonzero mean ({mean})")
    if back.shape != tuple(img.shape):
        raise AssertionError("EXR round trip changed the shape")
    log(f"image {tuple(img.shape)} finite, mean {mean:.6f}; EXR written")
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"a kernel was not launched: {counts}")
    # the look-ups: the forward kernel in every round (the per-mesh tables,
    # the env map), the backward ones never (no gradient)
    if (counts["lut_gather"] <= 0
            or counts["lut_gather_bwd"] or counts["lut_gather_large_bwd"]):
        raise AssertionError(f"the forward's look-up launches: {counts}")
    return counts


def stats_path():
    """Phase 5, the counter tool's entry point on the card: returns its
    launch counts."""
    import torch

    from nart_tpu_torch import cuda_build, kernel_stats

    cuda_build.reset_launch_counts()
    out = kernel_stats.main([MACBETH, "--asset-root", MACBETH_DIR])
    torch.cuda.synchronize()
    counts = dict(cuda_build.launch_counts)
    if min(counts["closest_hit_stats"], counts["any_hit_stats"]) <= 0:
        raise AssertionError(f"a counter kernel was not launched: {counts}")
    for label, s in out.items():
        if not (0 < s["tri_tests"] <= s["slab_tests"]
                and 1.0 <= s["lanes_per_test"] <= 32.0):
            raise AssertionError(f"kernel_stats {label}: {s}")
    return counts


def _image_samples(params, device):
    """The session's Latin-square image samples: (spp, W*H, 2)."""
    from nart_tpu_torch import render

    w, h = params.image_width, params.image_height
    return render.image_samples(
        w, h, w + 2 * int(np.ceil(params.filter_width)), params.spp, device)


def _rgb_cot(samples):
    import torch

    cot = torch.ones(samples.shape[:2] + (4,), device=samples.device)
    cot[..., 3] = 0.0
    return cot


def _leaves(theta):
    """[(name, tensor)] of a parameter dict, the medium's dict included."""
    out = []
    for k in sorted(theta):
        if isinstance(theta[k], dict):
            out += [(f"{k}.{s}", v) for s, v in sorted(theta[k].items())]
            continue
        vals = theta[k] if isinstance(theta[k], list) else [theta[k]]
        out += [(f"{k}[{i}]", v) for i, v in enumerate(vals) if v is not None]
    return out


def machine_totals(machines):
    """Sums over kept work-queue machines (RenderSession.machines, or the
    dict passed as trace_balanced's machines): graphs captured, capture
    seconds (warm-up round excluded), replays, and rounds the card ran,
    live and past the end."""
    runners = [m.runner for m in machines.values()]
    return {"captures": sum(r.captures for r in runners),
            "capture_s": round(sum(r.capture_s for r in runners), 4),
            "replays": sum(r.replays for r in runners),
            "rounds_run": sum(r.rounds_run for r in runners)}


def replay_runner(machines):
    """The runner of the one replay machine kept in machines."""
    (machine,) = [m for k, m in machines.items()
                  if k[0].endswith("_replay")]
    return machine.runner


def check_replay_launches(label, counts, rounds, ran, runner):
    """A graphed fwd+bwd call's traversal launches: K1 and K2 once in every
    round its forward ran on the card (the live rounds plus fewer than k
    past the end, credited per replay), never in its backward (its graph
    captured none); the small tables' look-ups in both."""
    if not (counts["closest_hit"] == counts["any_hit"] == ran
            and rounds <= ran < rounds + runner.k
            and runner.back_graph is not None
            and not any(runner.back_launches.get(k, 0) for k in TRAVERSAL)):
        raise AssertionError(
            f"{label}: launches {counts}, {ran} forward rounds run for "
            f"{rounds} live, backward graph {runner.back_launches}: K1 and "
            "K2 launch once a forward round run and never in the backward")
    # the small tables' look-ups: the forward kernel in the forward's
    # rounds, both kernels in the backward's round graph (the small-table
    # backward's two-launch reference never)
    # the BSDF kernels: X1 (the scatter) and the sample+eval launch
    # (strategy A and B) once each a forward round run; the backward's
    # round graph (which re-runs the round) the same and X3 three times (the
    # scatter's sample, A's sample, B's eval); the first designs, X2's
    # among them, never
    fwd, back = runner.launches, runner.back_launches
    if not (counts["bsdf_sample"] == counts["bsdf_sample_eval"] > 0
            and fwd.get("bsdf_sample", 0) == runner.k
            and fwd.get("bsdf_sample_eval", 0) == runner.k
            and not fwd.get("bsdf_f_bwd", 0)
            and back.get("bsdf_sample", 0) == 1
            and back.get("bsdf_sample_eval", 0) == 1
            and back.get("bsdf_f_bwd", 0) == 3 and counts["bsdf_f_bwd"] > 0
            and not any(counts[k] or fwd.get(k, 0) or back.get(k, 0)
                        for k in BSDF_REF)):
        raise AssertionError(
            f"{label}: BSDF launches {counts}, per forward replay {fwd}, "
            f"per backward round {back}")
    if not (fwd.get("lut_gather", 0) > 0 and not fwd.get("lut_gather_bwd", 0)
            and back.get("lut_gather", 0) > 0
            and back.get("lut_gather_bwd", 0) > 0
            and counts["lut_gather_bwd"] > 0
            and not counts["lut_gather_bwd_reference"]):
        raise AssertionError(
            f"{label}: look-up launches {counts}, per forward replay {fwd}, "
            f"per backward round {back}")


def check_large_launches(label, counts, runner, large):
    """A graphed fwd+bwd call's large-table backward (S2): where the scene
    has a large float table (large), launched in the backward's round graph
    and never in the forward's replays, so the call's backward launched it;
    where it has none, never."""
    fwd, back = runner.launches, runner.back_launches
    if large:
        ok = (not fwd.get("lut_gather_large_bwd", 0)
              and back.get("lut_gather_large_bwd", 0) > 0
              and counts["lut_gather_large_bwd"] > 0)
    else:
        ok = not any(counts[k] for k in LARGE)
    if not ok:
        raise AssertionError(
            f"{label}: large-table look-up launches {counts}, per forward "
            f"replay {fwd}, per backward round {back}")


def device_busy(label, fn, wall_s, top=5):
    """Run fn once under torch.profiler (the card's activity only) and log
    the card's busy time -- the sum of its kernels' and copies' device time
    -- as a share of wall_s, the wall time of the same call untraced (None:
    of this traced call's own wall); the host dispatching the round's small
    operations takes the rest.  Kernels
    replayed from a CUDA graph are traced one by one, as launched ones are.
    The profiler's raw events are summed by name (key_averages takes ~50
    us an event, minutes for a forward's million kernels).  Returns (the
    number of kernels and copies, the busy share, the launches of
    indexing_backward_kernel*, the busy ms)."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    what = "untraced" if wall_s is not None else "traced"
    wall_s = traced_s if wall_s is None else wall_s
    by_name = {}  # name -> [device ns, count]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0, 0])
            acc[0] += e.duration_ns()
            acc[1] += 1
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6
    count = sum(n for _, n in by_name.values())
    if not busy_ms > 0.0:
        raise AssertionError(f"{label}: the profiler saw no device time")
    log(f"device busy, {label}: {busy_ms:.3f} ms in {count} kernels and "
        f"copies = {100.0 * busy_ms / (1e3 * wall_s):.2f}% of the {what} "
        f"{wall_s:.4f} s")
    ranked = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    # the heaviest, and the traversal and look-up kernels wherever they rank
    ours = ("walk_kernel",) + LUT_NAMES + LARGE_NAMES + BSDF_NAMES
    for name, (ns, n) in ranked[:top] + [
            kv for kv in ranked[top:] if any(k in kv[0] for k in ours)]:
        log(f"    {name[:60]:60s} {ns / 1e6:10.3f} ms x{n}")
    # the gathers' backward: PyTorch's (the plain version's) and the look-up
    # kernels' (the small tables', the large tables' and their sorts)
    launches = {}
    for what, keys in (("indexing_backward_kernel*", (INDEXING_BACKWARD,)),
                       ("look-up kernels (small_lut.cu)", LUT_NAMES),
                       ("look-up kernels (large_lut.cu)", LARGE_NAMES),
                       ("BSDF kernels (bsdf.cu)", BSDF_NAMES),
                       ("sorts (the ray sort's and S2's)", SORT_NAMES),
                       ("memsets", ("Memset",))):
        hits = [v for name, v in by_name.items()
                if any(k in name for k in keys)]
        ms = sum(ns for ns, _ in hits) / 1e6
        launches[what] = sum(n for _, n in hits)
        log(f"    {what}: {ms:.3f} ms in {launches[what]} launches "
            f"= {100.0 * ms / busy_ms:.2f}% of the device time")
    return (count, busy_ms / (1e3 * wall_s),
            launches["indexing_backward_kernel*"], busy_ms)


def training_path(spp):
    """Phase 6: returns the launch counts of the timed run."""
    import torch

    from nart_tpu_torch import (
        cluster_accel as ca,
        cuda_build,
        grad,
        render,
        scene,
    )
    from nart_tpu_torch.integrators import path

    # the camera's placeholder medium is a trainable leaf the path
    # integrator never reads: its gradient is zero
    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    params = render.load_sessions(MACBETH, {"spp": spp})[0]
    w, h = params.image_width, params.image_height
    acc = ca.build_accel(sc.tri_v.numpy(), params.accel)
    samples = _image_samples(params, DEVICE)
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    log(f"training path: macbeth.json {w}x{h}, one chunk of {spp} spp, "
        "cot = 1 on RGB")
    machines = {}  # the replay machine, kept as a training loop keeps it

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = grad.radiance_weighted_loss_and_grad(
            sc, theta, acc, samples, cot, params, w, h, machines=machines)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, dt = run()
    log(f"warm run {dt:.3f} s (it measures the rounds and captures)")
    runner = replay_runner(machines)
    ran = runner.rounds_run
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    (loss, grads, rays, rounds), dt = run()
    counts = dict(cuda_build.launch_counts)
    ran = runner.rounds_run - ran
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"timed run fwd+bwd {dt:.4f} s, {rounds} rounds ({ran} run by the "
        f"card), {rays} rays (one forward's, algorithmic), "
        f"{rays / dt / 1e6:.4f} Mrays/s fwd+bwd, launches {counts}, peak "
        f"device memory {peak:.1f} MiB")
    check_replay_launches("training path", counts, rounds, ran, runner)
    check_large_launches("training path", counts, runner, True)
    # where the device time goes, the gathers' backward among it
    device_busy("macbeth fwd+bwd, graphed", run, dt)

    # the forward alone, as a session runs it: its machine kept, the
    # k-round graph captured by the first call and replayed by the next
    machines = {}

    sc_d, acc_d = sc.to(DEVICE), acc.to(DEVICE)

    def forward():
        return path.trace_balanced(sc_d, acc_d, samples, params, w, h,
                                   machines=machines)

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        la, rays_f, rounds_f = forward()
        want = float(la[..., :3].sum())
        torch.cuda.synchronize()
        dt_f = time.perf_counter() - t0
        log(f"forward work queue alone {dt_f:.4f} s ({rounds_f} rounds, "
            f"{machine_totals(machines)})")
    log(f"fwd+bwd / graphed fwd = {dt / dt_f:.3f}; loss {float(loss):.6f} "
        f"vs sum(la rgb) {want:.6f}")
    if not (np.isfinite(float(loss))
            and abs(float(loss) - want) <= 1e-4 * abs(want)):
        raise AssertionError(f"loss {float(loss)} != forward sum {want}")
    if (rays_f, rounds_f) != (rays, rounds):
        raise AssertionError("replay and forward disagree on rays or rounds")
    for k, g in _leaves(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient leaf {k} is not finite")
    sums = {k: float(g.abs().sum()) for k, g in _leaves(grads)}
    log("gradient |sum| per leaf: " + ", ".join(
        f"{k} {v:.6g}" for k, v in sums.items()))
    env = [k for k, v in _leaves(theta) if k.startswith("light_le_tex")]
    for k in ["rho_d_const[0]", "tex_data[0]"] + env:
        if not sums[k] > 0.0:
            raise AssertionError(f"gradient leaf {k} is all zero")
    if not env:
        raise AssertionError("macbeth has no env-map texture leaf")
    return counts


def card_against_cpu():
    """Phase 7."""
    import torch

    from nart_tpu_torch import (
        cluster_accel as ca,
        cuda_build,
        grad,
        render,
        testing,
    )
    from nart_tpu_torch.integrators import path

    sc = testing.simple_scene(("lambert",))
    params = render.RenderParams(image_width=32, image_height=32, spp=2)
    acc = ca.build_clusters(sc.tri_v.numpy())
    samples = _image_samples(params, "cpu")
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    # 256 work slots for 2,048 items: a dozen rounds with respawns
    args = (sc, theta, acc, samples, cot, params, 32, 32, 0, 256)
    before = dict(cuda_build.launch_counts)
    machines = {}
    loss_k, grads_k, rays_k, rounds_k = grad.radiance_weighted_loss_and_grad(
        *args, machines=machines)
    # the forwards (the measuring one's and the replay's) launch K1 once in
    # every round they run
    ran = machine_totals(machines)["rounds_run"]
    if (cuda_build.launch_counts["closest_hit"] - before["closest_hit"] != ran
            or ran < 2 * rounds_k):
        raise AssertionError("the card's gradient did not go through the "
                             "closest-hit kernel once per round run")
    loss_c, grads_c, rays_c, rounds_c = grad.radiance_weighted_loss_and_grad(
        *args, device="cpu")
    if (rays_k, rounds_k) != (rays_c, rounds_c):
        raise AssertionError("card and CPU traced different paths")
    worst = 0.0
    for (k, gk), (_, gc) in zip(_leaves(grads_k), _leaves(grads_c)):
        gk = gk.cpu()
        if not torch.allclose(gk, gc, rtol=1e-3, atol=1e-5):
            raise AssertionError(
                f"gradient leaf {k}: card {gk.flatten()[:4]} vs CPU "
                f"{gc.flatten()[:4]}")
        worst = max(worst, float((gk - gc).abs().max()))

    def fwd(delta):
        rho = theta["rho_d_const"].clone()
        rho[0, 0] += delta
        scn = grad.put_params(sc, dict(theta, rho_d_const=rho)).to(DEVICE)
        la, _, _ = path.trace_balanced(scn, acc.to(DEVICE),
                                       samples.to(DEVICE), params, 32, 32,
                                       n_lanes=256)
        return float(la[..., :3].double().sum())

    eps = 1e-2
    g_fd = (fwd(eps) - fwd(-eps)) / (2 * eps)
    g_ad = float(grads_k["rho_d_const"][0, 0])
    log(f"card vs CPU gradients: loss {float(loss_k):.6f} vs "
        f"{float(loss_c):.6f}, {rounds_k} rounds, every leaf within rtol "
        f"1e-3 / atol 1e-5 (max abs diff {worst:.3g}); d/d rho_d[0,0]: "
        f"replay {g_ad:.6f}, finite difference {g_fd:.6f}")
    if not abs(g_ad - g_fd) <= 0.05 * max(abs(g_fd), 1e-3):
        raise AssertionError(f"replay {g_ad} vs finite difference {g_fd}")


def _mode_cell(label, make, calls, traversal):
    """One cell of phase 8: make(per_round) -> a session of the mode.  The
    graphed session renders twice (the first render captures its
    machines' graphs) and the per-round loop once, each once more under
    the profiler; the films, the per-pixel RNG states and the stats must
    be the same bits, with one capture a machine (a chunk shape), and the
    traversal kernels (traversal: a path cell) launched once in every
    round the card ran, or never (the volume).  calls: the machine calls
    of a render (the rounds past the end, fewer than k, are a call's).
    Returns the graphed route's film and its timed render's launches."""
    import torch

    from nart_tpu_torch import cuda_build, rounds

    def timed(sess):
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        before = machine_totals(sess.machines)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = sess.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = machine_totals(sess.machines)
        return film, {
            "wall_s": wall, "stats": dict(sess.stats), "state": sess.state,
            "launches": dict(cuda_build.launch_counts),
            "rounds_run": after["rounds_run"] - before["rounds_run"],
            "replays": after["replays"] - before["replays"],
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}

    out = {}
    for name, per_round in (("graphed", False), ("per-round loop", True)):
        sess = make(per_round)
        first = timed(sess)[1]["wall_s"] if not per_round else None
        film, r = timed(sess)
        totals = machine_totals(sess.machines)
        r.update(film=film, first_wall_s=first, machines=len(sess.machines),
                 captures=totals["captures"], capture_s=totals["capture_s"])
        _, r["busy"], _, r["device_ms"] = device_busy(
            f"{label}, {name}", sess.render, r["wall_s"])
        out[name] = r
        del sess
    g, e = out["graphed"], out["per-round loop"]
    for name, r in out.items():
        log(f"    {label}, {name}: {r['wall_s']:.4f} s, device "
            f"{r['device_ms']:.3f} ms (busy {100 * r['busy']:.2f}%), "
            f"{r['stats']}, {r['rounds_run']} rounds run "
            f"({1e3 * r['wall_s'] / r['rounds_run']:.3f} ms each), "
            f"{r['replays']} replays, peak {r['peak_mib']:.1f} MiB, "
            f"{r['captures']} captures ({r['capture_s']:.4f} s), launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
    log(f"    {label}: first graphed render {g['first_wall_s']:.4f} s; "
        f"per-round / graphed wall {e['wall_s'] / g['wall_s']:.3f}x, "
        f"device {e['device_ms'] / g['device_ms']:.3f}x")
    if not (torch.equal(g["film"], e["film"])
            and torch.equal(g["state"], e["state"])
            and g["stats"] == e["stats"]):
        raise AssertionError(f"{label}: the graphed film, states or stats "
                             f"differ from the per-round loop's ({g['stats']}"
                             f" / {e['stats']})")
    if not (g["captures"] == g["machines"] >= 1 and e["captures"] == 0):
        raise AssertionError(f"{label}: {g['captures']} captures for "
                             f"{g['machines']} machines")
    k = rounds.ROUNDS_PER_CHECK
    if not e["rounds_run"] <= g["rounds_run"] < e["rounds_run"] + k * calls:
        raise AssertionError(f"{label}: rounds run {g['rounds_run']} / "
                             f"{e['rounds_run']} in {calls} calls")
    for name, r in out.items():
        if traversal:
            want = {r["rounds_run"]}
            if {r["launches"][k] for k in KERNELS[:2]} != want:
                raise AssertionError(f"{label}, {name}: launches "
                                     f"{r['launches']}, {want} rounds run")
            check_bsdf_launches(f"{label}, {name}", r["launches"],
                                r["rounds_run"])
        else:
            _no_traversal(f"{label}, {name}", r["launches"])
            check_vol_launches(f"{label}, {name}", r["launches"],
                               r["rounds_run"])
    return g["film"], g["launches"]


def modes_path(spp, spp_volume):
    """Phase 8: the "regen" and "spp" machines at full width, each against
    its per-round loop (_mode_cell): macbeth 1280x720 in "regen" and "spp"
    at spp samples, volume_blob "spp" at spp_volume; the "regen" film must
    be the "spp" film's bits, both image means within 3% of the "balanced"
    image's.  Returns the launches of the graphed "spp" and "regen"
    renders, summed."""
    import torch

    from nart_tpu_torch import film, render, scene

    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    films, counts = {}, dict.fromkeys(KERNELS, 0)
    for mode in ("regen", "spp"):
        (params,) = render.load_sessions(MACBETH, {"spp": spp,
                                                   "wavefront": mode})[:1]
        calls = params.spp if mode == "spp" else -(
            -params.spp // render.chunk_size(params))
        films[mode], launches = _mode_cell(
            f"macbeth {params.image_width}x{params.image_height} {mode} @ "
            f"{spp} spp",
            lambda per_round: render.RenderSession(sc, params, DEVICE,
                                                   per_round),
            calls, True)
        for k in KERNELS:
            counts[k] += launches[k]
        if min(launches[k] for k in KERNELS[:2] + ("lut_gather",)) <= 0:
            raise AssertionError(f"{mode}: K1, K2 and the look-up kernel "
                                 "not all launched")
    if not torch.equal(films["regen"], films["spp"]):
        worst = float((films["regen"] - films["spp"]).abs().max())
        raise AssertionError(f"regen film != spp film (max diff {worst})")
    log("    the regen film equals the spp film bit for bit")
    (params,) = render.load_sessions(MACBETH, {"spp": spp})[:1]
    sess = render.RenderSession(sc, params, DEVICE)
    films["balanced"] = sess.render()
    means = {m: float(film.finalize(f, params.image_width,
                                    params.image_height,
                                    sess.filter_bounds)[..., :3].mean())
             for m, f in films.items()}
    log(f"    image means {means}")
    for mode in ("spp", "regen"):
        rel = abs(means[mode] - means["balanced"]) / means["balanced"]
        if not rel < 0.03:
            raise AssertionError(f"{mode} mean {means[mode]} vs balanced "
                                 f"{means['balanced']}: {rel:.4f} apart")
    overrides = {"image_width": 1280, "image_height": 720,
                 "spp": spp_volume, "wavefront": "spp"}
    _, launches = _mode_cell(
        f"volume_blob 1280x720 spp @ {spp_volume} spp",
        lambda per_round: volume_session(overrides, per_round)[1],
        spp_volume, False)
    for k in VOL:
        counts[k] += launches[k]
    return counts


def volume_session(overrides=None, per_round=False):
    """volume_blob.json's session, its blob.vol read from this checkout
    (bench_configs.load_scene_doc)."""
    from nart_tpu_torch import render
    from nart_tpu_torch.bench_configs import load_scene_doc

    scene = load_scene_doc(VOLUME, os.path.dirname(VOLUME))
    if scene.medium is None:
        raise AssertionError("blob.vol was not loaded: no medium")
    (params,) = render.load_sessions(VOLUME, overrides)
    return params, render.RenderSession(scene, params, DEVICE, per_round)


def _no_traversal(label, counts):
    """The volume's paths: no traversal kernel, no BSDF kernel."""
    if any(counts.get(k, 0) for k in TRAVERSAL + BSDF + BSDF_REF):
        raise AssertionError(f"{label} launched a traversal or BSDF kernel: "
                             f"{counts}")


def check_vol_launches(label, counts, forward, backward=0):
    """A volume path's flight-step kernels: V1 once in each of the
    `forward` rounds the card ran (None: at least once) and once more in
    each of the `backward` rounds a replay's backward re-ran, V2 once in
    each of those."""
    v1, v2 = counts["vol_steps"], counts["vol_steps_bwd"]
    ok = (v1 > 0 if forward is None else v1 == forward + backward)
    if not (ok and v2 == backward):
        raise AssertionError(f"{label}: V1 launched {v1}, V2 {v2} times for "
                             f"{forward} forward and {backward} backward "
                             "rounds")


def check_vol_replay(label, counts, runner):
    """A graphed volume fwd+bwd's flight-step kernels: V1 once a round in
    the forward's k-round graph, V1 and V2 once each in the backward's
    round graph, both launched in the call."""
    fwd, back = runner.launches, runner.back_launches
    if not (fwd.get("vol_steps", 0) == runner.k
            and not fwd.get("vol_steps_bwd", 0)
            and back.get("vol_steps", 0) == 1
            and back.get("vol_steps_bwd", 0) == 1
            and counts["vol_steps"] > 0 and counts["vol_steps_bwd"] > 0):
        raise AssertionError(f"{label}: V1/V2 launches {counts}, per forward "
                             f"replay {fwd}, per backward round {back}")


def check_bsdf_launches(label, counts, rounds_run):
    """A path forward's BSDF kernels: X1 (the scatter) and the sample+eval
    launch (strategy A's sample, strategy B's eval) once each in every
    round the card ran, X3 and the first designs (X2's among them)
    never."""
    want = {"bsdf_sample": rounds_run, "bsdf_sample_eval": rounds_run,
            "bsdf_eval": 0, "bsdf_f_bwd": 0, "bsdf_sample_reference": 0,
            "bsdf_f_bwd_reference": 0}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: BSDF launches {counts}, want {want}")


def volume_golden():
    """Phase 9."""
    from nart_tpu_torch import cuda_build, exr

    params, sess = volume_session()
    cuda_build.reset_launch_counts()
    ours = sess.image().cpu().numpy()
    _no_traversal("the volume golden", cuda_build.launch_counts)
    check_vol_launches("the volume golden", cuda_build.launch_counts, None)
    log(f"volume golden render {params.image_width}x{params.image_height} "
        f"{params.spp} spp: {sess.stats}")
    ref = exr.read(VOLUME_GOLDEN)
    if ref.shape != ours.shape:
        raise AssertionError(f"golden shape {ref.shape} vs {ours.shape}")
    block_compare(ours, ref, 0.02, 0.05, 0.95, label="volume golden")


def window_busy(label, run, count):
    """device_busy over a window of `count` rounds: run() re-runs them from
    a kept carry, once untraced and once under the profiler.  Profiling a
    whole volume run (hundreds of thousands of small kernels) takes
    minutes; the window's rounds are the same work as the others'."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels, _, _, _ = device_busy(label, run, wall)
    log(f"    {kernels / count:.0f} kernels and copies a round, "
        f"{1e3 * wall / count:.3f} ms a round untraced")


def volume_forward(spp, window):
    """Phase 10: returns the launch counts of the timed run."""
    import torch

    from nart_tpu_torch import cuda_build, exr, film, render
    from nart_tpu_torch.integrators import volume

    params, sess = volume_session(
        {"image_width": 1280, "image_height": 720, "spp": spp})
    log(f"volume forward: volume_blob.json {params.image_width}x"
        f"{params.image_height} at {params.spp} spp (the scene's own session "
        f"has 32 spp; cut to {params.spp} for the smoke's time)")
    t0 = time.perf_counter()
    sess.render()
    torch.cuda.synchronize()
    log(f"warm run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    ran = machine_totals(sess.machines)["rounds_run"]
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    buf = sess.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_build.launch_counts)
    ran = machine_totals(sess.machines)["rounds_run"] - ran
    rays, rounds = sess.stats["rays"], sess.stats["rounds"]
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"timed run {dt:.4f} s, {rounds} rounds "
        f"({1e3 * dt / rounds:.3f} ms a round), {rays} segment starts, "
        f"{rays / dt / 1e6:.4f} Mrays/s, peak device memory {peak:.1f} MiB, "
        f"launches {counts}; the session's machine {machine_totals(sess.machines)}")
    _no_traversal("the volume forward", counts)
    check_vol_launches("the volume forward", counts, ran)
    log(f"V1 launched once in each of the {ran} rounds the card ran, V2 "
        "never")
    img = film.finalize(buf, params.image_width, params.image_height,
                        sess.filter_bounds)
    with tempfile.TemporaryDirectory() as tmp:
        back = exr.read(sess.write_exr(os.path.join(tmp, "blob"), img=img))
    mean = float(img[..., :3].mean())
    if not (bool(torch.isfinite(img).all()) and mean > 0.0
            and back.shape == tuple(img.shape)):
        raise AssertionError(f"volume image not finite with nonzero mean "
                             f"({mean}) or its EXR changed shape")
    log(f"image {tuple(img.shape)} finite, mean {mean:.6f}; EXR written")

    samples = render.image_samples(sess.render_w, sess.render_h,
                                   sess.total_w, params.spp, DEVICE)
    core, step_round, n = volume._static_machine(
        sess.scene, samples, params, sess.render_w, 0, params.lanes)
    items = samples.shape[0] * samples.shape[1]
    log(f"static machine: {n} lanes, {-(-items // n)} items a lane")
    first, count = window
    for _ in range(first):
        core = step_round(core)[0]

    def run():
        c = core
        for _ in range(count):
            if not bool(c[0].alive.any()):
                break
            c = step_round(c)[0]

    window_busy(f"volume per-round loop, rounds {first}-{first + count - 1}",
                run, count)
    return counts


def volume_training(spp, window):
    """Phase 11: returns the launch counts of the timed fwd+bwd run."""
    import torch

    from nart_tpu_torch import cuda_build, grad, render
    from nart_tpu_torch.integrators import volume

    params, sess = volume_session(
        {"image_width": 1280, "image_height": 720, "spp": spp})
    w, h = params.image_width, params.image_height
    sc = sess.scene
    samples = _image_samples(params, DEVICE)
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    log(f"volume training path: volume_blob.json {w}x{h}, one chunk of {spp}"
        " spp, cot = 1 on RGB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    la, rays_f, rounds_f = volume.trace_vol_static(sc, None, samples, params,
                                                   w, h)
    want = float(la[..., :3].double().sum() + cot[..., 3].double().sum())
    torch.cuda.synchronize()
    dt_f = time.perf_counter() - t0
    machines = {}
    grad.radiance_weighted_loss_and_grad(sc, theta, None, samples, cot,
                                         params, w, h, machines=machines)
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads, rays, rounds = grad.radiance_weighted_loss_and_grad(
        sc, theta, None, samples, cot, params, w, h, machines=machines)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(cuda_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"forward alone {dt_f:.4f} s ({rounds_f} rounds); fwd+bwd (after "
        f"a warm call that captured) {dt:.4f} s, {rounds} rounds, {rays} "
        f"segment starts (one "
        f"forward's), {rays / dt / 1e6:.4f} Mrays/s fwd+bwd, fwd+bwd / fwd "
        f"= {dt / dt_f:.3f}, peak device memory {peak:.1f} MiB, launches "
        f"{counts}; loss {float(loss):.6f} vs forward {want:.6f}")
    _no_traversal("the volume fwd+bwd", counts)
    check_large_launches("the volume fwd+bwd", counts,
                         replay_runner(machines), True)
    check_vol_replay("the volume fwd+bwd", counts, replay_runner(machines))
    if not (np.isfinite(float(loss))
            and abs(float(loss) - want) <= 1e-4 * abs(want)):
        raise AssertionError(f"loss {float(loss)} != forward sum {want}")
    if (rays, rounds) != (rays_f, rounds_f):
        raise AssertionError("replay and forward disagree on rays or rounds")
    for k, g in _leaves(grads):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient leaf {k} is not finite")
    med = {k: float(g.abs().sum()) for k, g in _leaves(grads)
           if k.startswith("medium.")}
    log("medium gradient |sum|: " + ", ".join(
        f"{k} {v:.6g}" for k, v in med.items()))
    if len(med) != 4 or not all(v > 0.0 for v in med.values()):
        raise AssertionError(f"a medium gradient is missing or zero: {med}")

    # the busy share over a window of the per-round replay's backward
    # rounds (phase 22 measures the graphed replay's)
    leaves = grad._as_leaves(theta, DEVICE)
    replay = volume._VolReplay(volume._static_machine,
                               grad.put_params(sc, leaves), samples, cot,
                               params, w, 0, params.lanes)
    replay.forward()
    saved = replay.saved
    g = torch.ones((), device=DEVICE)
    first, count = window

    def run():
        # the backward pass walks the window's rounds, last to first
        replay.saved = saved[first:first + count]
        replay.backward(g)

    window_busy(f"volume replay backward, rounds {first}-{first + count - 1}",
                run, count)
    return counts


def volume_card_against_cpu(size):
    """Phase 12."""
    import torch

    from nart_tpu_torch import grad, render, testing

    w, h, spp = size
    dens = np.linspace(0.3, 1.0, 64, dtype=np.float32).reshape(4, 4, 4)
    sc = testing.medium_scene(0.4, 0.8, (0.5, 0.5, 0.5), density=dens)
    params = render.RenderParams(image_width=w, image_height=h, spp=spp,
                                 bounces=16, integrator="volume")
    samples = _image_samples(params, "cpu")
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    # 256 work slots for 2,048 items: rounds with respawns
    args = (sc, theta, None, samples, cot, params, w, h, 0, 256)
    loss_k, grads_k, rays_k, rounds_k = grad.radiance_weighted_loss_and_grad(
        *args)
    loss_c, grads_c, rays_c, rounds_c = grad.radiance_weighted_loss_and_grad(
        *args, device="cpu")
    worst = 0.0
    for (k, gk), (_, gc) in zip(_leaves(grads_k), _leaves(grads_c)):
        gk = gk.cpu()
        if not torch.allclose(gk, gc, rtol=1e-3, atol=1e-5):
            raise AssertionError(
                f"volume gradient leaf {k}: card {gk.flatten()[:4]} vs CPU "
                f"{gc.flatten()[:4]}")
        worst = max(worst, float((gk - gc).abs().max()))
    log(f"volume card vs CPU gradients: loss {float(loss_k):.6f} vs "
        f"{float(loss_c):.6f}, rounds {rounds_k} / {rounds_c}, segment "
        f"starts {rays_k} / {rays_c}, every leaf within rtol 1e-3 / atol "
        f"1e-5 (max abs diff {worst:.3g}); d/d sigma_a "
        f"{float(grads_k['medium']['sigma_a']):.6f}")


def _shard_rounds(label, stats, layout):
    """Log the per-rank rounds of a layout and the balance over its row
    ranks (a row rank's rounds summed over its sample slabs): mean / max
    (the JAX package's measure) and max / mean."""
    per_row = [sum(stats[r * layout.n_spp + j]["rounds"]
                   for j in range(layout.n_spp)) for r in range(layout.n_row)]
    mean = statistics.mean(per_row)
    log(f"    {label}: rounds per rank {[st['rounds'] for st in stats]}; "
        f"row ranks {per_row}: balance mean/max {mean / max(per_row):.4f}, "
        f"max/mean {max(per_row) / mean:.4f}")


def _close_films(label, got, want):
    import torch

    if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
        bad = ~torch.isclose(got, want, rtol=1e-6, atol=1e-6)
        raise AssertionError(f"{label}: {int(bad.sum())} film values off, "
                             f"max diff {float((got - want).abs().max())}")
    log(f"    {label}: equal to the one-process film within atol/rtol 1e-6 "
        f"(max diff {float((got - want).abs().max()):.3g}, bit-equal "
        f"{bool(torch.equal(got, want))})")


def _virtual_ranks(sess, layout, label):
    """Every rank of a layout in turn (render_shard), the films summed:
    returns (film, per-rank stats)."""
    import torch

    from nart_tpu_torch import sharding

    film = torch.zeros((sess.total_h, sess.total_w, 5), device=DEVICE)
    stats = []
    for r in range(layout.world_size):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f, st = sharding.render_shard(sess, layout, r)
        torch.cuda.synchronize()
        st["seconds"] = time.perf_counter() - t0
        film += f
        stats.append(st)
    log(f"    {label}: seconds per rank "
        f"{[round(st['seconds'], 3) for st in stats]}")
    if any(st["rounds"] for st in stats):  # "spp"/"regen" count no rounds
        _shard_rounds(label, stats, layout)
    return film, stats


def sharded_virtual(spp):
    """Phase 13 (a): returns the launch counts of the sharded renders and
    the one-process macbeth film (phase 14's reference)."""
    import torch

    from nart_tpu_torch import cuda_build, render, sharding

    params, sess = next(render.render_scene_file(MACBETH, {"spp": spp},
                                                  device=DEVICE))
    t0 = time.perf_counter()
    single = sess.render()
    torch.cuda.synchronize()
    log(f"sharded (virtual ranks, one process): macbeth {params.image_width}"
        f"x{params.image_height} {spp} spp; one process {time.perf_counter() - t0:.3f} s, "
        f"{sess.stats}")
    counts = dict.fromkeys(KERNELS, 0)
    for shape in ((4, 1), (2, 2)):
        layout = sharding.Layout(*shape)
        cuda_build.reset_launch_counts()
        film, _ = _virtual_ranks(sess, layout, f"macbeth {layout}")
        for k in KERNELS:
            counts[k] += cuda_build.launch_counts[k]
        _close_films(f"macbeth {layout}", film, single)
    # "regen" shards: whole rows on the per-pixel streams, Layout(2, 2)
    # counting as four row ranks; the strip splats add at distinct rows, so
    # a second run gives the same bits
    _, sess_r = next(render.render_scene_file(
        MACBETH, {"spp": spp, "image_width": 320, "image_height": 180,
                  "wavefront": "regen"}, device=DEVICE))
    single_r = sess_r.render()
    layout = sharding.Layout(2, 2)
    label = f"macbeth 320x180 regen {layout}"
    kept = dict(sess_r.machines)
    cuda_build.reset_launch_counts()
    film_r, _ = _virtual_ranks(sess_r, layout, label)
    for k in KERNELS:
        counts[k] += cuda_build.launch_counts[k]
    _close_films(label, film_r, single_r)
    # the shards' strips of one shape replay one kept machine of the
    # session, captured once (the ranks' row counts: sharding._block)
    rows_of = sharding.Layout(layout.world_size, 1)  # "regen" deals rows
    shapes = {int(sharding._block(rows_of, r, sess_r.render_w,
                                  sess_r.render_h, sess_r.filter_bounds,
                                  sess_r.params.spp)[1].shape[0])
              for r in range(layout.world_size)}
    new = {key: m for key, m in sess_r.machines.items() if key not in kept}
    totals = machine_totals(new)
    log(f"    {label}: strips of {sorted(shapes)} rows, {len(new)} new kept "
        f"machines for the shards: {totals}")
    if len(new) != len(shapes) or totals["captures"] != len(new):
        raise AssertionError(f"{label}: {len(new)} machines, {totals} for "
                             f"strips of {sorted(shapes)} rows")
    again = [sharding.render_shard(sess_r, layout, r)[0]
             for r in range(layout.world_size)]
    if not torch.equal(sum(again), film_r):
        raise AssertionError("a second run of the regen shards differs")
    if machine_totals(sess_r.machines)["captures"] != len(sess_r.machines):
        raise AssertionError("the second run of the regen shards captured")
    log("    macbeth 320x180 regen: a second run of the shards is bit-equal, "
        "on the same machines (no capture)")
    params_v, sess_v = volume_session({"image_width": 1280,
                                       "image_height": 720, "spp": spp})
    single_v = sess_v.render()
    layout = sharding.Layout(4, 1)
    cuda_build.reset_launch_counts()
    film_v, _ = _virtual_ranks(sess_v, layout, f"volume_blob {layout}")
    _no_traversal("the sharded volume", cuda_build.launch_counts)
    check_vol_launches("the sharded volume", cuda_build.launch_counts, None)
    for k in VOL:
        counts[k] += cuda_build.launch_counts[k]
    _close_films(f"volume_blob {layout}", film_v, single_v)
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"the sharded renders launched {counts}")
    return counts, single


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _grad_inputs(spp, device):
    """macbeth at its 1280x720: scene, clusters, params, samples of one
    chunk of spp samples, cot = 1 on RGB, theta."""
    from nart_tpu_torch import cluster_accel as ca, grad, render, scene

    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    params = render.load_sessions(MACBETH, {"spp": spp})[0]
    acc = ca.build_accel(sc.tri_v.numpy(), params.accel)
    samples = _image_samples(params, device)
    return sc, acc, params, samples, _rgb_cot(samples), grad.get_params(sc)


def rank_worker(rank, port, out_dir):
    """One of phase 14's two ranks: gloo on the one card (NCCL refuses two
    ranks on one GPU).  The sharded macbeth film (Layout(2, 1), 2 spp) and
    the sharded gradient of one 1-spp chunk; writes rank<r>.npz."""
    import torch

    sys.path.insert(0, HERE)
    from nart_tpu_torch import cuda_build, grad, render, sharding

    dev = sharding.init_distributed(f"tcp://127.0.0.1:{port}", rank, 2,
                                    backend="gloo", device="cuda:0")
    layout = sharding.Layout(2, 1)
    _, sess = next(render.render_scene_file(MACBETH, {"spp": 2}, device=dev))
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    film, stats = sharding.render_sharded(sess, layout)
    torch.cuda.synchronize()
    t_film = time.perf_counter() - t0
    sc, acc, params, samples, cot, theta = _grad_inputs(1, dev)
    w, h = params.image_width, params.image_height
    t0 = time.perf_counter()
    loss, grads, rays, rounds = sharding.radiance_weighted_loss_and_grad_sharded(
        sc, theta, acc, samples, cot, params, w, h, layout, device=dev)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    flat = torch.cat([g.reshape(-1) for _, g in _leaves(grads)])
    # the two collectives alone, on buffers of the same sizes
    t_reduce = []
    for n in (film.numel(), flat.numel()):
        buf = torch.ones(n, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharding.all_reduce_sum(buf)
        torch.cuda.synchronize()
        t_reduce.append(time.perf_counter() - t0)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             film=film.cpu().numpy() if rank == 0 else np.zeros(0),
             loss=float(loss), grads=flat.cpu().numpy(),
             counts=np.array([cuda_build.launch_counts[k] for k in KERNELS]),
             rounds=np.array([stats["rounds"], rounds]),
             seconds=np.array([t_film, t_grad] + t_reduce),
             sizes=np.array([film.numel(), flat.numel()]))
    torch.distributed.destroy_process_group()


def two_ranks(single):
    """Phase 14 (b): returns the two ranks' launch counts."""
    import torch

    from nart_tpu_torch import grad

    log("two ranks on the one card under gloo (NCCL refuses two ranks on "
        "one GPU): render_sharded of macbeth at 2 spp and "
        "radiance_weighted_loss_and_grad_sharded of one 1-spp chunk, "
        "Layout(2, 1)")
    sc, acc, params, samples, cot, theta = _grad_inputs(1, DEVICE)
    w, h = params.image_width, params.image_height
    loss1, grads1, _, _ = grad.radiance_weighted_loss_and_grad(
        sc, theta, acc, samples, cot, params, w, h)
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--rank", str(r), str(port), tmp])
                 for r in range(2)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise AssertionError(f"the ranks exited with {rcs}")
        out = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(2)]
    for r, o in enumerate(out):
        log(f"    rank {r}: film {o['seconds'][0]:.3f} s ({o['rounds'][0]} "
            f"rounds), gradient {o['seconds'][1]:.3f} s ({o['rounds'][1]} "
            f"rounds), launches {dict(zip(KERNELS, o['counts'].tolist()))}; "
            f"all-reduce under gloo (through host memory) of the film's "
            f"{4 * o['sizes'][0]} bytes {o['seconds'][2]:.4f} s, of the "
            f"gradient's {4 * o['sizes'][1]} bytes {o['seconds'][3]:.4f} s")
    _close_films("two ranks, gloo", torch.from_numpy(out[0]["film"]),
                 single.cpu())
    loss2 = out[0]["loss"]
    if not (out[1]["loss"] == loss2
            and abs(loss2 - float(loss1)) <= 1e-5 * abs(float(loss1))):
        raise AssertionError(f"sharded loss {loss2} / {out[1]['loss']} vs "
                             f"one process {float(loss1)}")
    want = torch.cat([g.reshape(-1) for _, g in _leaves(grads1)]).cpu()
    got = torch.from_numpy(out[0]["grads"])
    if not torch.allclose(got, want, rtol=1e-3, atol=1e-5):
        raise AssertionError("sharded gradient differs from one process's: "
                             f"max diff {float((got - want).abs().max())}")
    log(f"    loss {loss2:.6f} vs one process {float(loss1):.6f} (rtol 1e-5); "
        f"{want.numel()} gradient values within rtol 1e-3 / atol 1e-5 (max "
        f"diff {float((got - want).abs().max()):.3g})")
    counts = {k: int(out[0]["counts"][i] + out[1]["counts"][i])
              for i, k in enumerate(KERNELS)}
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"the ranks launched {counts}")
    return counts


def cli_world_of_one(spp):
    """Phase 15 (c): the CLI as a world of one under NCCL, in this process;
    its EXR against RenderSession.write_exr's.  Returns its launch counts."""
    import contextlib
    import io

    from nart_tpu_torch import cli, cuda_build, exr, render

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli")
        err = io.StringIO()
        cuda_build.reset_launch_counts()
        with contextlib.redirect_stderr(err):
            rc = cli.main([MACBETH, out, "--coordinator",
                           f"127.0.0.1:{_free_port()}", "--numProcesses", "1",
                           "--processId", "0", "-s", str(spp), "--timing"])
        counts = dict(cuda_build.launch_counts)
        for line in err.getvalue().splitlines():
            log(f"    cli {line}")
        if rc != 0:
            raise AssertionError(f"the CLI returned {rc}")
        _, sess = next(render.render_scene_file(MACBETH, {"spp": spp},
                                                 device=DEVICE))
        want = exr.read(sess.write_exr(os.path.join(tmp, "session")))
        got = exr.read(out + ".exr")
    if not np.array_equal(got, want):
        raise AssertionError("the CLI's EXR differs from write_exr's: max "
                             f"diff {np.abs(got - want).max()}")
    log(f"    the CLI's EXR {got.shape} equals RenderSession.write_exr's bit "
        f"for bit; launches {counts}")
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"the CLI launched {counts}")
    return counts


def checkpoint_resume():
    """Phase 16 (d)."""
    import torch

    from nart_tpu_torch import checkpoint, render

    cases = (("balanced", {"spp": 4}, 2),
             ("regen", {"spp": 2, "image_width": 128, "image_height": 72,
                        "wavefront": "regen"}, 1))
    for label, overrides, every in cases:
        params, sess = next(render.render_scene_file(MACBETH, overrides,
                                                      device=DEVICE))
        full = sess.render()
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck.npz")
            # after the render the file holds its first save: no save is
            # made at the last sample
            render.RenderSession(sess.scene, params, DEVICE).render(
                checkpoint_path=ck, checkpoint_every=every)
            t0 = time.perf_counter()
            film, state, done = checkpoint.load(ck, params)
            t_load = time.perf_counter() - t0
            t0 = time.perf_counter()
            checkpoint.save(os.path.join(tmp, "again.npz"), film, state, done,
                            params)
            t_save = time.perf_counter() - t0
            size = os.path.getsize(ck)
            resumed = render.RenderSession(sess.scene, params, DEVICE).render(
                checkpoint_path=ck, resume=True)
        if done != every or not torch.equal(resumed, full):
            raise AssertionError(f"{label}: resumed from {done} spp, film "
                                 "differs from the uninterrupted one")
        # both on the graphed route: the session's machines captured
        if machine_totals(sess.machines)["captures"] < 1:
            raise AssertionError(f"{label}: the render captured no graph")
        log(f"checkpoint {label}: macbeth {params.image_width}x"
            f"{params.image_height} {params.spp} spp, saved at {done}: "
            f"{size} bytes, save {t_save:.3f} s, load {t_load:.3f} s; the "
            "resumed film equals the uninterrupted one bit for bit")


def ptxas_report(source):
    """nvcc's -Xptxas -v report of a kernel source (a build of its own in
    a temporary directory, beside cuda_build's): each kernel's registers,
    stack frame and spills."""
    from nart_tpu_torch import cuda_build

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", os.path.join(tmp, "report.so"), os.path.join(HERE, source)],
            capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v failed on {source}:\n"
                           f"{proc.stderr}")
    return proc.stderr


def _once_ms(fn):
    """(fn()'s result, its milliseconds between two CUDA events): one call
    of a function that reads the card from the host (the plain walk)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def bvh_bound(tree, n_rays, counts):
    """B1's least time (ms) and what sets it, as bound() reckons the
    cluster kernels': each ray read once (o, d, t_min, t_max: 32 B) and its
    Hit written once (t, u, v, tri: 20 B), the tree once (node boxes,
    triangles, order); operations: the plain walk's own work on these rays
    (bvh.intersect_bvh_plain's counts: a slab test a node popped, two a
    inner node passed; leaf_size triangles a leaf passed, each charged
    TRI_OPS_MIN, the least that rejects one)."""
    tree_bytes = sum(x.numel() * x.element_size() for x in
                     (tree.node_lo, tree.node_hi, tree.tri_v, tree.order))
    nbytes = n_rays * (32 + 20) + tree_bytes
    ops = (SLAB_OPS * (counts["nodes"] + 2 * counts["inner"])
           + TRI_OPS_MIN * tree.leaf_size * counts["leaves"])
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def warp_efficiency(ray_nodes):
    """The nodes each ray pops (the plain walk's order, one pop a step of
    B1's first design) summed, over the steps its warp takes (32 times
    the largest pop count of its 32 consecutive rays): the mean share of a
    warp's lanes with a node to pop."""
    import torch

    x = ray_nodes.double()
    w = torch.nn.functional.pad(x, (0, (-len(x)) % 32)).view(-1, 32)
    return float(x.sum() / (32.0 * w.amax(1).sum()))


def _bvh_against_plain(label, rays, tree):
    """B1's closest hit and occlusion against the plain walk (timed once
    between events, counting its work): returns (agreement, max abs err,
    bit-equal, the plain walk's ms, its counts)."""
    import torch

    from nart_tpu_torch import bvh

    hk = bvh.intersect_bvh(*rays, tree)
    occ = bvh.occluded_bvh(*rays, tree)
    counts = {}
    hp, plain_ms = _once_ms(
        lambda: bvh.intersect_bvh_plain(*rays, tree, counts=counts))
    frac, err = compare_closest(f"B1 {label}", hk, hp)
    if not torch.equal(occ, hk.tri >= 0):
        raise AssertionError(f"B1 {label}: the any-hit walk != the closest "
                             "hit's validity")
    equal = all(torch.equal(a, b) for a, b in zip(hk, hp))
    log(f"(e) B1 {label}, {rays[0].shape[0]} rays: tri agree {frac:.6f}, "
        f"hits {int((hp.tri >= 0).sum())}, max abs err {err:.3g}, bit-equal "
        f"{equal}; occlusion == closest-hit validity: exact; the plain walk "
        f"{plain_ms:.3f} ms (one call, host included); its work "
        f"{ {k: v for k, v in counts.items() if k != 'ray_nodes'} }, warp "
        f"efficiency {warp_efficiency(counts['ray_nodes']):.4f}")
    return frac, err, equal, plain_ms, counts


def bvh_turns(sets):
    """B1's closest-hit and any-hit entries against the reference kernel
    (nart_bvh_hit_ref, the walk's first design) on every ray set, in turns
    (reference, new, new, reference): every output of every call the
    reference's bits, each turn's device ms (device_ms).  Returns
    {set: {entry: {"reference": [ms, ms], "new": [ms, ms]}}}."""
    import torch

    from nart_tpu_torch.kernel_variants import bvh_cases

    calls = bvh_cases(sets)  # "entry set": call(reference=...)
    want = {key: call(reference=True) for key, call in calls.items()}
    per_call = {key: _once_ms(call)[1] for key, call in calls.items()}
    out = {}
    for turn in ("reference", "new", "new", "reference"):
        ref = turn == "reference"
        for label in sets:
            for entry in ("closest-hit", "any-hit"):
                key = f"{entry} {label}"
                got = calls[key](reference=ref)
                if not all(torch.equal(a, b) for a, b in zip(got, want[key])):
                    raise AssertionError(f"B1 {key}: the {turn} kernel's "
                                         "outputs differ from the "
                                         "reference's bits")
                t = device_ms(lambda c=calls[key]: c(reference=ref),
                              launches_for(per_call[key]))
                out.setdefault(label, {}).setdefault(entry, {}).setdefault(
                    turn, []).append(t["ms"])
    for label, entries in out.items():
        for entry, t in entries.items():
            log(f"turns B1 {label} {entry}: reference {t['reference'][0]:.4f}"
                f", new {t['new'][0]:.4f}, new {t['new'][1]:.4f}, reference "
                f"{t['reference'][1]:.4f} ms; reference / new "
                f"{sum(t['reference']) / sum(t['new']):.3f}x; every output "
                "the reference's bits")
    return out


def _bvh_render(kind, size, skip_shadow=False):
    """A graphed macbeth render of accel `kind` (the session's first
    render captures): (image, wall s of the timed render, rounds run,
    launches, the session)."""
    import torch

    from nart_tpu_torch import cuda_build, render
    from nart_tpu_torch.integrators import path

    w, h, spp = size
    path._DEBUG_SKIP_SHADOW = skip_shadow  # read when a machine is made
    try:
        params, sess = next(render.render_scene_file(
            MACBETH, dict(image_width=w, image_height=h, spp=spp,
                          accel=kind), device=DEVICE))
        sess.render()  # captures the session's graph
    finally:
        path._DEBUG_SKIP_SHADOW = False
    cuda_build.reset_launch_counts()
    before = machine_totals(sess.machines)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = sess.image()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = machine_totals(sess.machines)
    ran = after["rounds_run"] - before["rounds_run"]
    launches = dict(cuda_build.launch_counts)
    label = kind + (" NART_SKIP_SHADOW" if skip_shadow else "")
    log(f"accel {label}: macbeth {w}x{h} {spp} spp graphed in {wall:.4f} s, "
        f"{sess.stats}, {ran} rounds run, {after}, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    want = ({"bvh_hit": (1 if skip_shadow else 2) * ran} if kind == "bvh"
            else {"closest_hit": ran, "any_hit": ran})
    if (after["captures"] != 1
            or any(launches[k] != v for k, v in want.items())
            or (kind == "bvh" and any(launches[k] for k in TRAVERSAL))):
        raise AssertionError(f"accel {label}: launches {launches}, {ran} "
                             f"rounds run, {after}")
    return img.cpu().numpy(), wall, ran, launches, sess


def bvh_accel(size):
    """Phase 17 (e): B1 (csrc/bvh_walk.cu) on three ray sets
    (kernel_variants.ray_sets, bvh trees: 65,536 macbeth camera rays,
    131,072 rays from their hit points, a quarter with t_max = 0, and
    65,536 rays through the 40,000-triangle soup) against the plain walk
    and, in turns, against the reference kernel; its device ms, bounds and
    the warp efficiency of its first design's walk; then the graphed "bvh"
    render beside the cluster one, and with NART_SKIP_SHADOW.  Returns
    (B1's record, the bvh render's launches)."""
    import torch

    from nart_tpu_torch import bvh, kernel_variants

    sets = kernel_variants.ray_sets(torch.device(DEVICE),
                                    np.random.default_rng(0), "bvh")
    for label, (rays, tree) in sets.items():
        log(f"(e) {label}: {rays[0].shape[0]} rays, LBVH of {tree.n_leaves} "
            f"leaves of {tree.leaf_size}, depth {tree.depth}")
    cam, tree = sets["camera"]
    n = cam[0].shape[0]
    _, err, equal, _, counts = _bvh_against_plain("camera rays", cam, tree)
    # and on the CPU: B1 rounds every operation on its own, the plain
    # walk's torch.linalg.cross rounds its products' difference once
    # (fused) on either device, so t may differ in its last bits there
    few = tuple(x[:8192] for x in cam)
    hk = bvh.intersect_bvh(*few, tree)
    hc = bvh.intersect_bvh_plain(*(x.cpu() for x in few), tree.to("cpu"))
    equal_cpu = all(torch.equal(a.cpu(), b) for a, b in zip(hk, hc))
    log(f"(e) B1 against the plain walk on the CPU, {few[0].shape[0]} of the "
        f"camera rays: bit-equal {equal_cpu}")
    sh, _ = sets["hit points"]
    _, err_h, _, _, counts_h = _bvh_against_plain("hit-point rays", sh, tree)
    soup, tree_b = sets["soup"]
    # the plain walk takes its slowest ray's thousands of node visits, a
    # host read each, on the soup: a sixteenth of the rays against it
    part = tuple(x[:soup[0].shape[0] // 16] for x in soup)
    _, err_b, _, plain_b, counts_b = _bvh_against_plain(
        f"soup (depth {tree_b.depth}), a sixteenth", part, tree_b)

    turns = bvh_turns(sets)
    t_k = kernel_ms(lambda: bvh.intersect_bvh(*cam, tree), SIZES["reps"])
    t_p = stream_ms(lambda: bvh.intersect_bvh_plain(*cam, tree), 1, 3)

    def mean(x):
        return sum(x) / len(x)

    bounds = {"camera": bvh_bound(tree, n, counts),
              "hit points": bvh_bound(tree, sh[0].shape[0], counts_h),
              # the soup's work counted on a sixteenth of its rays, times 16
              "soup": bvh_bound(tree_b, soup[0].shape[0], {
                  k: 16 * counts_b[k] for k in ("nodes", "inner", "leaves")})}
    shares = {}
    for label, b in bounds.items():
        t = turns[label]["closest-hit"]
        shares[label] = {"new": b["bound_ms"] / mean(t["new"]),
                         "reference": b["bound_ms"] / mean(t["reference"])}
        log(f"bound bvh_hit {label}: {b['bound_ms']:.6f} ms by "
            f"{b['bound_by']} ({b['bytes']} bytes; {b['operations']} "
            f"operations): closest-hit reaches {100 * shares[label]['new']:.3f}"
            f"% of it (the reference {100 * shares[label]['reference']:.3f}%)")
    eff = {"camera": warp_efficiency(counts["ray_nodes"]),
           "hit points": warp_efficiency(counts_h["ray_nodes"]),
           "soup (a sixteenth)": warp_efficiency(counts_b["ray_nodes"])}
    log(f"time B1 closest-hit {n} macbeth camera rays: kernel {fmt(t_k)}, "
        f"plain {fmt(t_p)}; the plain walk {plain_b:.3f} ms on "
        f"{part[0].shape[0]} soup rays; warp efficiency {eff}")
    rec = dict(max_abs_err=max(err, err_h, err_b), bit_equal=equal,
               bit_equal_cpu=equal_cpu, bit_equal_reference=True,
               ms=t_k["ms"], ms_min=t_k["min"], ms_max=t_k["max"],
               ms_per_call=t_k["ms_per_call"], plain_ms=t_p["ms"],
               library_ms=None,
               any_hit_ms=mean(turns["camera"]["any-hit"]["new"]),
               reference_ms=mean(turns["camera"]["closest-hit"]["reference"]),
               turns=turns, bound_shares=shares, warp_efficiency=eff,
               **bounds["camera"])

    imgs, secs = {}, {}
    for kind in ("cluster", "bvh"):
        imgs[kind], secs[kind], ran, launches, sess = _bvh_render(kind, size)
        if kind == "bvh":
            counts_bvh = launches
            _, _, _, busy_ms = device_busy("bvh render", sess.render,
                                           secs[kind])
        del sess
    if not np.isfinite(imgs["bvh"]).all():
        raise AssertionError("the bvh image is not finite")
    block_compare(imgs["bvh"], imgs["cluster"], 1e-3, 0.01, 0.95,
                  label="bvh vs cluster (tight)")
    block_compare(imgs["bvh"], imgs["cluster"], 0.03, 0.12, 0.95,
                  label="bvh vs cluster (golden)")
    log(f"bvh / cluster wall time, both graphed: "
        f"{secs['bvh'] / secs['cluster']:.3f}x")
    # the occlusion walk's share of a "bvh" round: the same render with
    # every shadow ray unoccluded (B1 launched once a round run)
    _, wall_skip, ran_skip, _, sess = _bvh_render("bvh", size,
                                                  skip_shadow=True)
    _, _, _, busy_skip = device_busy("bvh render, NART_SKIP_SHADOW",
                                     sess.render, wall_skip)
    del sess
    log(f"bvh render with NART_SKIP_SHADOW / without: wall {wall_skip:.4f} / "
        f"{secs['bvh']:.4f} s, device {busy_skip:.3f} / {busy_ms:.3f} ms, "
        f"{ran_skip} rounds run")
    rec["skip_shadow"] = {"wall_s": wall_skip, "device_ms": busy_skip,
                          "unset_wall_s": secs["bvh"],
                          "unset_device_ms": busy_ms}
    bvh_replay()
    return rec, counts_bvh


def bvh_replay():
    """Phase 17 (e): a "bvh" fwd+bwd (grad.radiance_weighted_loss_and_grad,
    macbeth 320x180 @ 1 spp, cot = 1 on RGB) on a kept replay machine,
    whose forward now captures with B1, against the per-round replay:
    phase 22's criteria (loss rtol 1e-6, every leaf rtol 1e-5 / atol
    1e-7, equal rays and rounds); B1 launched twice in every forward round
    the card ran and never in the backward, K1-K4 never."""
    import dataclasses

    import torch

    from nart_tpu_torch import bvh, cuda_build, grad, render, scene

    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    params = dataclasses.replace(
        render.load_sessions(MACBETH, {"spp": 1})[0], image_width=320,
        image_height=180, accel="bvh")
    tree = bvh.build_bvh(sc.tri_v.numpy())
    samples = _image_samples(params, DEVICE)
    cot = _rgb_cot(samples)
    theta = grad.get_params(sc)
    out = {}
    for per_round in (False, True):
        machines = {}
        call = lambda: grad.radiance_weighted_loss_and_grad(  # noqa: E731
            sc, theta, tree, samples, cot, params, 320, 180,
            machines=machines, per_round=per_round)
        if not per_round:
            call()  # measures the rounds, captures both graphs
            runner = replay_runner(machines)
            ran0 = runner.rounds_run
        cuda_build.reset_launch_counts()
        loss, grads, rays, rounds = call()
        torch.cuda.synchronize()
        out[per_round] = (float(loss), _leaves(grads), rays, rounds,
                          dict(cuda_build.launch_counts))
    (loss_g, leaves_g, *stats_g, counts_g) = out[False]
    (loss_e, leaves_e, *stats_e, counts_e) = out[True]
    ran = runner.rounds_run - ran0
    log(f"(e) bvh fwd+bwd macbeth 320x180 @ 1 spp: loss {loss_g:.6f} graphed "
        f"/ {loss_e:.6f} per-round, rays and rounds {stats_g} / {stats_e}, "
        f"{ran} forward rounds run, launches graphed "
        f"{ {k: v for k, v in counts_g.items() if v} }, per-round "
        f"{ {k: v for k, v in counts_e.items() if v} }, backward graph "
        f"{runner.back_launches}")
    if not (abs(loss_g - loss_e) <= 1e-6 * abs(loss_e) and stats_g == stats_e
            and all(torch.allclose(a, b, rtol=1e-5, atol=1e-7)
                    for (_, a), (_, b) in zip(leaves_g, leaves_e))):
        raise AssertionError("the bvh fwd+bwd's graphed replay differs from "
                             "the per-round replay")
    if (counts_g["bvh_hit"] != 2 * ran or runner.back_launches.get("bvh_hit")
            or runner.back_graph is None
            or any(counts_g[k] + counts_e[k] for k in TRAVERSAL)):
        raise AssertionError(f"the bvh fwd+bwd's launches: {counts_g}, {ran} "
                             f"forward rounds run, {runner.back_launches}")


def bench_subprocess(size, spp):
    """Phase 18: `python -m nart_tpu_torch.bench` in each mode; returns the
    launches its timed runs reported, summed over both."""
    counts = dict.fromkeys(KERNELS, 0)
    for mode in ("fwd", "fwdbwd"):
        env = dict(os.environ, NART_BENCH_SIZE=str(size),
                   NART_BENCH_SPP=str(spp), NART_BENCH_MODE=mode)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "nart_tpu_torch.bench"], cwd=HERE,
            env=env, capture_output=True, text=True, timeout=600)
        for line in proc.stderr.splitlines():
            log(f"    bench {mode} {line}")
        if proc.returncode:
            raise AssertionError(f"bench {mode} exited {proc.returncode}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"    bench {mode} ({time.perf_counter() - t0:.1f} s with its "
            f"start): {json.dumps(last)}")
        keys = {"metric", "value", "unit", "vs_baseline", "device"}
        if set(last) != keys:
            raise AssertionError(f"bench {mode}: keys {sorted(last)}")
        if not (math.isfinite(last["value"]) and last["value"] > 0.0):
            raise AssertionError(f"bench {mode}: value {last['value']}")
        for line in proc.stderr.splitlines():
            if " launches: " in line:
                grew = json.loads(line.split(" launches: ", 1)[1])
                for k in KERNELS:
                    counts[k] += grew[k]
    if min(counts["closest_hit"], counts["any_hit"]) <= 0:
        raise AssertionError(f"the bench launched {counts}")
    return counts


def cornell_golden():
    """Phase 19: returns the launches of the two renders."""
    from nart_tpu_torch import cuda_build, exr, render, scene

    sc = scene.load_scene(CORNELL, asset_root=MACBETH_DIR)
    counts = dict.fromkeys(KERNELS, 0)
    for (w, h, spp), golden, tols in (
            ((64, 64, 8), "cornell_64x64_8spp.exr", (0.02, 0.1, 0.9)),
            ((128, 128, 64), "cornell_128x128_64spp.exr",
             (0.015, 0.05, 0.95))):
        params = render.resolve_params(
            {}, dict(image_width=w, image_height=h, spp=spp, bounces=6))
        sess = render.RenderSession(sc, params, DEVICE)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        ours = sess.image().cpu().numpy()
        grew = {k: cuda_build.launch_counts[k] for k in KERNELS}
        log(f"cornell {w}x{h} {spp} spp in {time.perf_counter() - t0:.3f} s: "
            f"{sess.stats}, launches {grew}")
        if min(grew["closest_hit"], grew["any_hit"]) <= 0:
            raise AssertionError(f"kernels not launched by the render: {grew}")
        for k in KERNELS:
            counts[k] += grew[k]
        ref = exr.read(os.path.join(os.path.dirname(CORNELL), golden))
        if ref.shape != ours.shape:
            raise AssertionError(f"golden shape {ref.shape} vs {ours.shape}")
        block_compare(ours, ref, *tols, label=f"cornell golden {w}x{h} {spp} "
                      "spp")
    return counts


def _line_of(fn, text):
    """(file name, line) of the first line of fn's source holding text."""
    import inspect

    src, first = inspect.getsourcelines(fn)
    at = first + next(i for i, ln in enumerate(src) if text in ln)
    return os.path.basename(inspect.getsourcefile(fn)), at


def _sync_checked(label, trace, end_reads, n_end=2, strict=False):
    """trace(machines) -> (la, rays, rounds), once to capture the k-round
    graph into a kept machine and once more under the sync debug mode
    (rounds may be a device tensor, read after the mode is off).
    From the first replay on, the machine may synchronise only where the
    host reads the device: the runner's alive flag after each replay
    (ceil(rounds / k) times) and the end's n_end reads (end_reads, the
    (file, line) of that read).  What comes before the first replay (the
    chunk's set-up and the flag read before it) is counted and logged;
    strict: it must be that one flag read and nothing else."""
    import warnings

    import torch

    from nart_tpu_torch import rounds

    machines = {}
    trace(machines)
    torch.cuda.synchronize()
    flag_read = _line_of(rounds.RoundRunner._run_graphed,
                         "while bool(self.flag)")
    real_replay = torch.cuda.CUDAGraph.replay
    started = []

    def replay(graph):
        if not started:
            started.append(len(caught))
        return real_replay(graph)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.CUDAGraph.replay = replay
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, rays, n_rounds = trace(machines)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.CUDAGraph.replay = real_replay
    n_rounds = int(n_rounds)

    def where(ws):
        # the mode's own notice that it is a prototype is no synchronisation
        return [(os.path.basename(w.filename), w.lineno) for w in ws
                if "synchronizing CUDA operation" in str(w.message)]

    if not started:
        raise AssertionError(f"{label}: no graph was replayed")
    before, in_loop = where(caught[:started[0]]), where(caught[started[0]:])
    k = rounds.ROUNDS_PER_CHECK
    n_flag = in_loop.count(flag_read)
    strays = [at for at in in_loop if at not in (flag_read, end_reads)]
    log(f"sync check: {label}, {n_rounds} rounds, {rays} rays, k = {k}: "
        f"{len(before)} synchronising calls before the first replay "
        f"({sorted(set(before))}), {len(in_loop)} from it on: the alive flag "
        f"{n_flag}, the end's reads {in_loop.count(end_reads)}, elsewhere "
        f"{strays}; {machine_totals(machines)}")
    if (strays or n_flag != -(-n_rounds // k) or in_loop.count(end_reads)
            != n_end or (strict and before != [flag_read])):
        raise AssertionError(
            f"{label}: from the first replay on {len(in_loop)} synchronising "
            f"calls, the flag {n_flag}, the end "
            f"{in_loop.count(end_reads)}, elsewhere {strays}, before "
            f"{before}; want ceil({n_rounds} / {k}), {n_end} and none"
            + (", and one flag read before" if strict else ""))


def round_sync_check(spp):
    """Phase 20: the graphed path.trace_balanced under the sync debug mode,
    on macbeth (an environment light) and on a scene with a distant light,
    and the volume's static machine (volume.trace_vol_static) on
    volume_blob; the "regen" machine (path.trace_regen) and the "spp"
    machines (path.trace_lockstep, volume.trace_lockstep) at 1280x720;
    then a path and a volume fwd+bwd call on kept replay machines
    (grad.radiance_weighted_loss_and_grad)."""
    import torch

    from nart_tpu_torch import grad, render, replay, testing
    from nart_tpu_torch.integrators import path, volume

    def path_trace(sess):
        p = sess.params
        samples = render.image_samples(sess.render_w, sess.render_h,
                                       sess.total_w, spp, DEVICE)
        return lambda machines: path.trace_balanced(
            sess.scene, sess.accel, samples, p, sess.render_w,
            sess.render_h, 0, p.lanes, machines=machines)

    path_end = _line_of(path._BalancedForward.__call__, "int(rounds)")
    _, sess = next(render.render_scene_file(MACBETH, {"spp": spp},
                                            device=DEVICE))
    _sync_checked(f"macbeth {sess.render_w}x{sess.render_h} {spp} spp",
                  path_trace(sess), path_end)
    params = render.RenderParams(image_width=128, image_height=128, spp=spp,
                                 bounces=6)
    sess = render.RenderSession(testing.distant_scene(), params, DEVICE)
    _sync_checked(f"distant light 128x128 {spp} spp", path_trace(sess),
                  path_end)
    params, sess = volume_session({"image_width": 1280, "image_height": 720,
                                   "spp": spp})
    samples = render.image_samples(sess.render_w, sess.render_h,
                                   sess.total_w, spp, DEVICE)
    _sync_checked(
        f"volume_blob static machine 1280x720 {spp} spp",
        lambda machines: volume.trace_vol_static(
            sess.scene, None, samples, params, sess.render_w, sess.render_h,
            0, params.lanes, machines=machines),
        _line_of(volume._VolForward.__call__, "int(rounds)"))

    # the "regen" and "spp" machines: the end reads rays alone (the rounds
    # are read from the runner after the check)
    def mode_trace(tracer, sess, spp_chunk):
        p = sess.params
        samples, state = render.pixel_streams(sess.render_w, sess.render_h,
                                              sess.total_w, spp_chunk, DEVICE)
        pix = torch.arange(sess.render_w * sess.render_h, device=DEVICE)

        def trace(machines):
            _, _, rays = tracer(sess.scene, sess.accel, pix % sess.render_w,
                                pix // sess.render_w, samples, state, p,
                                machines=machines)
            (machine,) = machines.values()
            return None, rays, machine.runner.rounds
        return trace

    _, sess = next(render.render_scene_file(
        MACBETH, {"spp": 2, "wavefront": "regen"}, device=DEVICE))
    _sync_checked(f"macbeth regen {sess.render_w}x{sess.render_h}, a chunk "
                  "of 2 spp", mode_trace(path.trace_regen, sess, 2),
                  _line_of(path._RegenForward.__call__, "int(core[0].rays)"),
                  n_end=1)
    _sync_checked(f"macbeth spp {sess.render_w}x{sess.render_h}, one sample",
                  mode_trace(path.trace_lockstep, sess, 1),
                  _line_of(path._LockstepForward.__call__, "int(p.rays)"),
                  n_end=1)
    _, sess_v = volume_session({"image_width": 1280, "image_height": 720,
                                "spp": 1, "wavefront": "spp"})
    _sync_checked(f"volume_blob spp {sess_v.render_w}x{sess_v.render_h}, one "
                  "sample", mode_trace(volume.trace_lockstep, sess_v, 1),
                  _line_of(volume._LockstepForward.__call__,
                           "int(self.rays)"), n_end=1)

    # fwd+bwd: the replay's forward reads its flag, its end reads rays,
    # rounds and the capacity's cut in one transfer, its backward nothing;
    # the scene, samples and cot already on the card
    replay_end = _line_of(replay.ReplayMachine.forward, "end.tolist()")

    def fwdbwd(scn, acc, samples, cot, params, w, h):
        theta = grad.get_params(scn)

        def trace(machines):
            out = grad.radiance_weighted_loss_and_grad(
                scn, theta, acc, samples, cot, params, w, h,
                machines=machines)
            return None, out[2], out[3]
        return trace

    sc, acc, p_mac, samples, cot, _ = _grad_inputs(spp, DEVICE)
    _sync_checked(f"macbeth fwd+bwd 1280x720 {spp} spp",
                  fwdbwd(sc.to(DEVICE), acc.to(DEVICE), samples, cot, p_mac,
                         p_mac.image_width, p_mac.image_height),
                  replay_end, n_end=1, strict=True)
    samples = _image_samples(params, DEVICE)
    _sync_checked(f"volume_blob fwd+bwd 1280x720 {spp} spp",
                  fwdbwd(sess.scene, None, samples, _rgb_cot(samples), params,
                         params.image_width, params.image_height),
                  replay_end, n_end=1, strict=True)


def _graphed_against_per_round(label, make, traversal):
    """One cell of phase 21: make(per_round) -> a session.  The graphed
    session renders twice (the first call captures), the per-round loop
    once; the films must be the same bits, with the same rays and rounds.
    Returns the cell's record."""
    import gc

    import torch

    from nart_tpu_torch import cuda_build, rounds

    def timed(sess):
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        before = machine_totals(sess.machines)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = sess.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = machine_totals(sess.machines)
        return film, {"wall_s": wall, "stats": dict(sess.stats),
                      "launches": {k: cuda_build.launch_counts[k]
                                   for k in KERNELS[:2] + BSDF + BSDF_REF
                                   + VOL},
                      "rounds_run": after["rounds_run"] - before["rounds_run"],
                      "replays": after["replays"] - before["replays"],
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                      "peak_reserved_mib":
                          torch.cuda.max_memory_reserved() / 2**20}

    def cached_mib():
        # what the caching allocator keeps once its free blocks are
        # released: live tensors and graph pools
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved() / 2**20

    base = cached_mib()
    sess = make(False)
    _, first = timed(sess)
    film_g, g = timed(sess)
    g["held_mib"] = cached_mib() - base
    g["first_wall_s"] = first["wall_s"]
    g.update({k: v for k, v in machine_totals(sess.machines).items()
              if k.startswith("capture")})
    g["kernels"], g["busy"], _, g["device_ms"] = device_busy(
        f"{label}, graphed forward", sess.render, g["wall_s"])
    del sess
    base = cached_mib()
    sess = make(True)
    film_e, e = timed(sess)
    e["held_mib"] = cached_mib() - base
    del sess
    rounds_ = g["stats"]["rounds"]
    for name, r in (("graphed", g), ("per-round loop", e)):
        log(f"    {label}, {name}: {r['wall_s']:.4f} s, {r['stats']}, "
            f"{r['rounds_run']} rounds run ({1e3 * r['wall_s'] / r['rounds_run']:.3f}"
            f" ms each), {r['replays']} replays, peak {r['peak_mib']:.1f} MiB "
            f"allocated / {r['peak_reserved_mib']:.1f} MiB reserved, the "
            f"session holding {r['held_mib']:.1f} MiB after it (graph pool, "
            f"buffers, scene), launches {r['launches']}")
    log(f"    {label}: k = {rounds.ROUNDS_PER_CHECK}; first graphed render "
        f"{g['first_wall_s']:.4f} s, of it capture + instantiate "
        f"{g['capture_s']:.4f} s ({g['captures']} capture); per-round / "
        f"graphed wall {e['wall_s'] / g['wall_s']:.3f}x; busy "
        f"{100 * g['busy']:.2f}% of the graphed forward")
    if not torch.equal(film_g, film_e):
        raise AssertionError(f"{label}: the graphed film differs from the "
                             "per-round loop's")
    if g["stats"] != e["stats"] or g["captures"] != 1:
        raise AssertionError(f"{label}: {g['stats']} vs {e['stats']}, "
                             f"{g['captures']} captures")
    want = ((g["rounds_run"], e["rounds_run"]) if traversal else (0, 0))
    for r, n in zip((g, e), want):
        if {r["launches"][k] for k in KERNELS[:2]} != {n}:
            raise AssertionError(f"{label}: launches {r['launches']}, want "
                                 f"{n} each")
        check_bsdf_launches(label, r["launches"], n)
        if not traversal:
            check_vol_launches(label, r["launches"], r["rounds_run"])
    g["kernels_a_round"] = g["kernels"] / g["rounds_run"]
    g["film"] = film_g
    log(f"    {label}: {g['kernels']} kernels and copies over "
        f"{g['rounds_run']} rounds run: {g['kernels_a_round']:.1f} a round "
        "(graphed forward, profiled)")
    if not (e["rounds_run"] == rounds_
            and rounds_ <= g["rounds_run"] < rounds_ + rounds.ROUNDS_PER_CHECK):
        raise AssertionError(f"{label}: rounds run {g['rounds_run']} / "
                             f"{e['rounds_run']}, rounds {rounds_}")
    return {"graphed": g, "per_round": e}


def graphed_rounds():
    """Phase 21: the forward machines as CUDA graphs of k rounds against the
    per-round loop, on the bench's simple_glass 512x512 @ 16 spp, macbeth
    1280x720 @ 4 spp and volume_blob 1280x720 @ 4 spp; one capture for the
    eight chunks of volume_blob 96x96 @ 32 spp in chunks of 4; then k = 4,
    8 and 16 on macbeth (k_sweep)."""
    import torch

    from nart_tpu_torch import bench, render, scene

    name, glass = bench.bench_scene()
    macbeth = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    # 4 spp keeps this phase a small share of the script's run time
    (p_mac,) = render.load_sessions(MACBETH, {"spp": 4})[:1]
    p_glass = render.RenderParams(image_width=512, image_height=512, spp=16,
                                  bounces=10, filter_width=2.0,
                                  roughening_factor=0.2)
    records = {
        f"{name} 512x512 @ 16 spp": _graphed_against_per_round(
            f"{name} 512x512 @ 16 spp",
            lambda per_round: render.RenderSession(glass, p_glass, DEVICE,
                                                   per_round), True),
        "macbeth 1280x720 @ 4 spp": _graphed_against_per_round(
            "macbeth 1280x720 @ 4 spp",
            lambda per_round: render.RenderSession(macbeth, p_mac, DEVICE,
                                                   per_round), True),
        "volume_blob 1280x720 @ 4 spp": _graphed_against_per_round(
            "volume_blob 1280x720 @ 4 spp",
            lambda per_round: volume_session(
                {"image_width": 1280, "image_height": 720, "spp": 4},
                per_round)[1], False),
    }
    # a render of many chunks of one shape replays one capture
    films, totals = [], {}
    for per_round in (False, True):
        params, sess = volume_session({"spp_chunk": 4}, per_round)
        films.append(sess.render())
        totals[per_round] = machine_totals(sess.machines)
    chunks = -(-params.spp // 4)
    log(f"    volume_blob {params.image_width}x{params.image_height} @ "
        f"{params.spp} spp in {chunks} chunks of 4: graphed {totals[False]}, "
        f"per-round loop {totals[True]}; films equal: {torch.equal(*films)}")
    if totals[False]["captures"] != 1 or chunks < 2:
        raise AssertionError("the chunks of one shape did not share one "
                             "capture")
    if not torch.equal(*films):
        raise AssertionError("many chunks: the graphed film differs from "
                             "the per-round loop's")
    mac = records["macbeth 1280x720 @ 4 spp"]["graphed"]
    mac["plain_bsdf"] = plain_bsdf_round(macbeth, p_mac, mac["film"])
    vol = records["volume_blob 1280x720 @ 4 spp"]["graphed"]
    vol["plain_steps"] = plain_vol_round(vol["film"])
    for r in records.values():
        del r["graphed"]["film"]
    k_sweep(macbeth, p_mac)
    return records


def plain_bsdf_round(scene, params, film_kernels):
    """Phase 21's macbeth cell with the path round's BSDF calls on their
    plain versions (bsdf_ops.sample_f and sample_eval_f replaced by
    sample_plain and sample_eval_plain: bxdf.py's functions op by op, the
    route before X1-X3): a graphed render that captures, then one under
    torch.profiler (device_busy, as the cell's).  Its film must be the
    kernels' film_kernels bit for bit.  Returns {"kernels", "rounds_run",
    "kernels_a_round", "device_ms"} of the profiled render."""
    import torch

    from nart_tpu_torch import bsdf_ops, render

    label = "macbeth 1280x720 @ 4 spp, plain BSDF calls"
    real = (bsdf_ops.sample_f, bsdf_ops.sample_eval_f)
    bsdf_ops.sample_f = bsdf_ops.sample_plain
    bsdf_ops.sample_eval_f = bsdf_ops.sample_eval_plain
    try:
        sess = render.RenderSession(scene, params, DEVICE)
        sess.render()
        before = machine_totals(sess.machines)["rounds_run"]
        films = []
        kernels, _, _, dev_ms = device_busy(
            f"{label}, graphed forward",
            lambda: films.append(sess.render()), None)
        rounds_run = machine_totals(sess.machines)["rounds_run"] - before
    finally:
        bsdf_ops.sample_f, bsdf_ops.sample_eval_f = real
    if not torch.equal(films[0], film_kernels):
        raise AssertionError(f"{label}: the film differs from the BSDF "
                             "kernels' film")
    out = {"kernels": kernels, "rounds_run": rounds_run,
           "kernels_a_round": kernels / rounds_run, "device_ms": dev_ms}
    log(f"    {label}: {kernels} kernels and copies over {rounds_run} rounds"
        f" run: {out['kernels_a_round']:.1f} a round (graphed forward, "
        "profiled); the film the BSDF kernels' bits")
    return out


def plain_vol_round(film_kernels):
    """Phase 21's volume_blob cell with the flight steps on their plain
    version (vol_ops.flight_steps replaced by flight_steps_plain: the
    step op by op, the route before V1/V2): a graphed render that
    captures, then one under torch.profiler (device_busy).  Its film must
    be V1's film_kernels bit for bit.  Returns {"kernels", "rounds_run",
    "kernels_a_round", "device_ms"} of the profiled render."""
    import torch

    from nart_tpu_torch import vol_ops

    label = "volume_blob 1280x720 @ 4 spp, plain flight steps"
    real = vol_ops.flight_steps
    vol_ops.flight_steps = vol_ops.flight_steps_plain
    try:
        sess = volume_session({"image_width": 1280, "image_height": 720,
                               "spp": 4})[1]
        sess.render()
        before = machine_totals(sess.machines)["rounds_run"]
        films = []
        kernels, _, _, dev_ms = device_busy(
            f"{label}, graphed forward",
            lambda: films.append(sess.render()), None)
        rounds_run = machine_totals(sess.machines)["rounds_run"] - before
    finally:
        vol_ops.flight_steps = real
    if not torch.equal(films[0], film_kernels):
        raise AssertionError(f"{label}: the film differs from V1's film")
    out = {"kernels": kernels, "rounds_run": rounds_run,
           "kernels_a_round": kernels / rounds_run, "device_ms": dev_ms}
    log(f"    {label}: {kernels} kernels and copies over {rounds_run} rounds"
        f" run: {out['kernels_a_round']:.1f} a round (graphed forward, "
        "profiled); the film V1's bits")
    return out


def k_sweep(scene, params):
    """Phase 21's k = 4, 8, 16 (checks, one host read each, against rounds
    past the end): one session a k, each captured with its k, then their
    renders in turns (4, 8, 16, 16, 8, 4, 4, 8, 16), so that the host's
    drift falls on every k alike."""
    import torch

    from nart_tpu_torch import render, rounds

    default = rounds.ROUNDS_PER_CHECK
    sessions = {}
    try:
        for k in (4, 8, 16):
            rounds.ROUNDS_PER_CHECK = k
            sessions[k] = render.RenderSession(scene, params, DEVICE)
            sessions[k].render()
    finally:
        rounds.ROUNDS_PER_CHECK = default
    walls = {k: [] for k in sessions}
    for order in ((4, 8, 16), (16, 8, 4), (4, 8, 16)):
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sessions[k].render()
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    for k, sess in sessions.items():
        t = machine_totals(sess.machines)
        log(f"    k = {k}: macbeth 1280x720 @ {params.spp} spp, median "
            f"{statistics.median(walls[k]):.4f} s of "
            f"{[round(x, 4) for x in walls[k]]}, {sess.stats['rounds']} "
            f"rounds, capture {t['capture_s']} s, {t['rounds_run']} rounds "
            "run over the 4 renders")
    log(f"    k sweep (median s): "
        f"{ {k: statistics.median(w) for k, w in walls.items()} }; the "
        f"package's k = {default}")


def _replay_cell(label, fn, traversal, large):
    """One cell of phase 22: fn(per_round, machines) -> (loss, grads, rays,
    rounds), one fwd+bwd chunk.  The graphed replay on kept machines (a
    warm call that measures and captures, then a timed call) against the
    per-round replay in the same process: the loss to rtol 1e-6, every
    gradient leaf to rtol 1e-5 / atol 1e-7, equal rays and rounds, K1/K2
    launched once a forward round run (none on the volume), the look-up
    kernels in the path's rounds, the large-table ones (S2) on both routes
    where the scene has a large table (large) and nowhere else, and no
    indexing_backward_kernel* in the graphed call's profile.  Returns the
    cell's record."""
    import gc

    import torch

    from nart_tpu_torch import cuda_build, grad

    def cached_mib():
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved() / 2**20

    def timed(per_round, machines):
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(per_round, machines)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, {"wall_s": wall, "rays": out[2], "rounds": out[3],
                     "launches": dict(cuda_build.launch_counts),
                     "peak_mib": torch.cuda.max_memory_allocated() / 2**20}

    base = cached_mib()
    machines = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(False, machines)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    runner = replay_runner(machines)
    ran, back = runner.rounds_run, runner.back_rounds
    out_g, g = timed(False, machines)
    g.update(first_wall_s=first, rounds_run=runner.rounds_run - ran,
             back_rounds=runner.back_rounds - back,
             captures=runner.captures, capture_s=runner.capture_s,
             replays=runner.replays, held_mib=cached_mib() - base)
    if traversal:
        check_replay_launches(label, g["launches"], g["rounds"],
                              g["rounds_run"], runner)
    check_large_launches(label, g["launches"], runner, large)
    if not traversal:
        check_vol_replay(label, g["launches"], runner)
    (_, g["busy"], g["indexing_backward"],
     g["device_ms"]) = device_busy(f"{label}, graphed fwd+bwd",
                                   lambda: fn(False, machines), g["wall_s"])
    if g["indexing_backward"]:
        raise AssertionError(
            f"{label}: {g['indexing_backward']} launches of PyTorch's "
            "indexing_backward: a table read by a plain gather")
    del machines, runner
    base = cached_mib()
    out_e, e = timed(True, {})
    e["held_mib"] = cached_mib() - base
    a, b = grad.flatten_leaves(out_g[1]), grad.flatten_leaves(out_e[1])
    close = torch.isclose(a, b, rtol=1e-5, atol=1e-7)
    loss_g, loss_e = float(out_g[0]), float(out_e[0])
    g["loss_rel"] = abs(loss_g - loss_e) / abs(loss_e)
    g["grad_max_abs_diff"] = float((a - b).abs().max())
    g["grad_outside"] = int((~close).sum())
    for name, r in (("graphed", g), ("per-round", e)):
        log(f"    {label}, {name}: {r['wall_s']:.4f} s, "
            f"{r['rays'] / r['wall_s'] / 1e6:.4f} M/s fwd+bwd, "
            f"{r['rounds']} rounds, peak {r['peak_mib']:.1f} MiB, held "
            f"{r['held_mib']:.1f} MiB after it, launches {r['launches']}")
    log(f"    {label}: graphed {g['rounds_run']} forward rounds run for "
        f"{g['rounds']} live, {g['back_rounds']} backward rounds, "
        f"{g['replays']} forward replays over both calls, "
        f"{g['captures']} captures ({g['capture_s']:.4f} s; the first call "
        f"{g['first_wall_s']:.4f} s); per-round / graphed wall "
        f"{e['wall_s'] / g['wall_s']:.3f}x; busy {100 * g['busy']:.2f}% of "
        f"the graphed fwd+bwd; loss {loss_g!r} vs {loss_e!r} (rel "
        f"{g['loss_rel']:.3g}), gradient max abs diff "
        f"{g['grad_max_abs_diff']:.3g} of {a.numel()} values, "
        f"{g['grad_outside']} outside rtol 1e-5 / atol 1e-7")
    if not (np.isfinite(loss_g) and g["loss_rel"] <= 1e-6
            and bool(torch.isfinite(a).all()) and not g["grad_outside"]):
        raise AssertionError(f"{label}: the graphed replay differs from the "
                             "per-round replay")
    if (g["rays"], g["rounds"]) != (e["rays"], e["rounds"]):
        raise AssertionError(f"{label}: rays or rounds differ")
    if g["back_rounds"] != g["rounds"] or g["captures"] != 2:
        raise AssertionError(f"{label}: {g['back_rounds']} backward rounds, "
                             f"{g['captures']} captures")
    if traversal:
        if {e["launches"][k] for k in KERNELS[:2]} != {e["rounds"]}:
            raise AssertionError(f"{label}: per-round launches "
                                 f"{e['launches']}")
        # X1 and the sample+eval launch once each a forward round, again
        # where the backward re-runs a round, X3 in the backward only, X2's
        # first design never
        e_l = e["launches"]
        if not (e_l["bsdf_sample"] == e_l["bsdf_sample_eval"] >= e["rounds"]
                and e_l["bsdf_f_bwd"] > 0 and not e_l["bsdf_eval"]):
            raise AssertionError(f"{label}: per-round BSDF launches "
                                 f"{e['launches']}")
    else:
        _no_traversal(label, {**g["launches"], **e["launches"]})
        # V1 once a forward round and V1 and V2 once each a backward round
        # on the per-round replay (the graphed call's: above)
        e_l = e["launches"]
        if not (e_l["vol_steps_bwd"] == e["rounds"]
                and e_l["vol_steps"] >= 2 * e["rounds"]):
            raise AssertionError(f"{label}: per-round V1/V2 launches {e_l} "
                                 f"for {e['rounds']} rounds")
    if (e["launches"]["lut_gather_large_bwd"] > 0) != large:
        raise AssertionError(f"{label}: per-round large-table look-ups "
                             f"{e['launches']}")
    return {"graphed": g, "per_round": e}


def graphed_replay():
    """Phase 22: the graphed replay (fwd+bwd) against the per-round replay
    on macbeth 1280x720 @ 4 spp, the bench's simple_glass 512x512 @ 16 spp
    (one chunk, as the bench runs it) and volume_blob 1280x720 @ 4 spp."""
    from nart_tpu_torch import bench, grad, render

    def call(scn, acc, params, chunk_spp=None):
        w, h = params.image_width, params.image_height
        samples = _image_samples(params, DEVICE)[:chunk_spp]
        cot = _rgb_cot(samples)
        theta = grad.get_params(scn)
        return lambda per_round, machines: grad.radiance_weighted_loss_and_grad(
            scn, theta, acc, samples, cot, params, w, h, machines=machines,
            per_round=per_round)

    sc, acc, p_mac, _, _, _ = _grad_inputs(4, "cpu")
    name, glass = bench.bench_scene()
    p_glass = render.RenderParams(image_width=512, image_height=512, spp=16,
                                  bounces=10, filter_width=2.0,
                                  roughening_factor=0.2)
    sess = render.RenderSession(glass, p_glass, DEVICE)
    p_vol, vol = volume_session({"image_width": 1280, "image_height": 720,
                                 "spp": 4})
    return {
        "macbeth 1280x720 @ 4 spp": _replay_cell(
            "macbeth 1280x720 @ 4 spp",
            call(sc.to(DEVICE), acc.to(DEVICE), p_mac), True, True),
        f"{name} 512x512 @ 16 spp": _replay_cell(
            f"{name} 512x512 @ 16 spp",
            call(sess.scene, sess.accel, p_glass, bench.CHUNK), True, False),
        "volume_blob 1280x720 @ 4 spp": _replay_cell(
            "volume_blob 1280x720 @ 4 spp",
            call(vol.scene, None, p_vol), False, True),
    }


def turn(out_path):
    """One process of the parent-and-change turns (`chip_smoke.py --turn
    TREE OUT`: TREE's nart_tpu_torch is imported; this file's fixtures):
    for each of phase 22's cells, the graphed forward film (a render that
    captures, then a timed one) and the graphed fwd+bwd on a kept machine
    (a warm call that measures and captures, a timed call, the same call
    under torch.profiler: the card's device ms, indexing_backward_kernel*
    launches); the loss, the leaves, the films, rays, rounds, wall s and
    device ms are saved with torch.save to out_path."""
    import torch

    from nart_tpu_torch import bench, grad, render, scene

    name, glass = bench.bench_scene()
    p_glass = render.RenderParams(image_width=512, image_height=512, spp=16,
                                  bounces=10, filter_width=2.0,
                                  roughening_factor=0.2)
    macbeth = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    (p_mac,) = render.load_sessions(MACBETH, {"spp": 4})[:1]
    cells = (
        ("macbeth 1280x720 @ 4 spp",
         lambda: render.RenderSession(macbeth, p_mac, DEVICE), None),
        (f"{name} 512x512 @ 16 spp",
         lambda: render.RenderSession(glass, p_glass, DEVICE), bench.CHUNK),
        ("volume_blob 1280x720 @ 4 spp",
         lambda: volume_session({"image_width": 1280, "image_height": 720,
                                 "spp": 4})[1], None))
    out = {}
    for label, make, chunk_spp in cells:
        sess = make()
        sess.render()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film = sess.render()
        torch.cuda.synchronize()
        fwd_wall = time.perf_counter() - t0
        params = sess.params
        w, h = params.image_width, params.image_height
        samples = _image_samples(params, DEVICE)[:chunk_spp]
        cot = _rgb_cot(samples)
        theta = grad.get_params(sess.scene)
        machines = {}

        def call():
            return grad.radiance_weighted_loss_and_grad(
                sess.scene, theta, sess.accel, samples, cot, params, w, h,
                machines=machines)

        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, rays, rounds = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, busy, indexing, dev_ms = device_busy(f"turn, {label}", call, wall)
        out[label] = dict(
            film=film.cpu(), loss=torch.as_tensor(loss).cpu(),
            leaves=grad.flatten_leaves(grads).cpu(),
            named=[(k, g.detach().reshape(-1).cpu())
                   for k, g in _leaves(grads)],
            rays=int(rays),
            rounds=int(rounds), forward_wall_s=fwd_wall, wall_s=wall,
            device_ms=dev_ms, busy=busy, indexing_backward=indexing)
        del sess, machines
    torch.save(out, out_path)


def turns(parent):
    """Phase 22's cells in the parent's tree (P) and this one (C), in turns
    P, C, C, P, each a fresh process (`turn`): the films, rays, rounds and
    loss the parent's bits, the leaves the parent's bits or within rtol
    1e-5 / atol 1e-7, indexing_backward_kernel* never launched; logged:
    each turn's forward wall s, fwd+bwd wall s and device ms."""
    import torch

    order = [("P", parent), ("C", HERE), ("C", HERE), ("P", parent)]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (tree_label, tree) in enumerate(order):
            out = os.path.join(tmp, f"{i}.pt")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--turn", os.path.abspath(tree), out],
                           check=True)
            log(f"[turn {i + 1} ({tree_label}): "
                f"{time.perf_counter() - t0:.1f} s]")
            runs.append((tree_label, torch.load(out)))
    ref = next(r for lab, r in runs if lab == "P")
    failed = []
    for label in ref:
        for i, (tree_label, r) in enumerate(runs):
            c = r[label]
            a, b = c["leaves"], ref[label]["leaves"]
            same = dict(
                film=torch.equal(c["film"], ref[label]["film"]),
                loss=torch.equal(c["loss"], ref[label]["loss"]),
                rays_rounds=(c["rays"], c["rounds"]) == (
                    ref[label]["rays"], ref[label]["rounds"]),
                leaves=torch.equal(a, b))
            outside = int((~torch.isclose(a, b, rtol=1e-5, atol=1e-7)).sum())
            log(f"    {label}, turn {i + 1} ({tree_label}): forward "
                f"{c['forward_wall_s']:.4f} s; fwd+bwd {c['wall_s']:.4f} s, "
                f"device {c['device_ms']:.3f} ms, busy {100 * c['busy']:.2f}%"
                f", {c['rays']} rays, {c['rounds']} rounds, loss "
                f"{float(c['loss'])!r}; against P1: {same}, leaves max abs "
                f"diff {float((a - b).abs().max()):.3g}, {outside} of "
                f"{a.numel()} outside rtol 1e-5 / atol 1e-7")
            if outside:  # where, leaf by leaf
                for (k, x), (_, y) in zip(c["named"], ref[label]["named"]):
                    bad = ~torch.isclose(x, y, rtol=1e-5, atol=1e-7)
                    if bool(bad.any()):
                        j = int(bad.nonzero()[0, 0])
                        log(f"        {k}: {int(bad.sum())} of {x.numel()} "
                            f"outside, e.g. [{j}] {float(x[j])!r} against "
                            f"P1's {float(y[j])!r}")
            if not (same["film"] and same["loss"] and same["rays_rounds"]
                    and not outside and not c["indexing_backward"]):
                failed.append(f"{label}, turn {i + 1}")
    if failed:  # every cell and turn is logged first
        raise AssertionError(f"the change differs from the parent: "
                             f"{failed}")


def _f64_bsdf_functions():
    """(sample_f, eval_f_pdf, stats) whose forwards are X1 and X2 (the
    plain version's bits) and whose backwards are the float64 VJP of the
    plain version at the same inputs, wi held fixed (bsdf_ops.
    sample_at_bwd_plain with X1's wi and flags, bsdf_ops.eval_bwd_plain),
    rounded to float32 a lane; a non-finite float64 row is zeroed.  Each
    backward call also holds X3 and measures the plain float32 VJP against
    that float64 VJP on its lanes (_x3_against_float64, as phase 27 does);
    stats sums the calls, lanes and the counts it returns."""
    import torch

    from nart_tpu_torch import bsdf_ops, bxdf

    stats = {"calls": 0, "lanes": 0, "x3_within": 0, "x3_worst": 0.0,
             "other_branch": 0, "non_finite": 0, "plain32_outside": 0,
             "plain32_worst": 0.0}

    def f32(label, x3, f_fwd, ref, f_ref, plain32):
        r = _x3_against_float64(label, x3, f_fwd, ref, f_ref, plain32)
        stats["calls"] += 1
        stats["lanes"] += f_fwd.shape[0]
        stats["x3_within"] += r[1]
        stats["other_branch"] += r[2]
        stats["non_finite"] += r[3]
        stats["plain32_outside"] += r[4]
        stats["x3_worst"] = max(stats["x3_worst"], r[0])
        stats["plain32_worst"] = max(stats["plain32_worst"], r[5])
        return [torch.where(torch.isfinite(g), g, 0.0).float() for g in ref]

    class Sample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                    alpha_prime, wo, u1, u2, use_prime, eta_outer,
                    prev_flags):
            desc, wo, u1, u2, use_prime, eta_outer, prev_flags = (
                bsdf_ops._contiguous(bxdf.BsdfDesc(
                    n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                    alpha_prime), wo, u1, u2, use_prime, eta_outer,
                    prev_flags))
            f, wi, pdf, flags, alpha_i, eta_s, bits = bsdf_ops.sample_cuda(
                desc, wo, u1, u2, use_prime, eta_outer, prev_flags)
            ctx.save_for_backward(*desc, wo, wi, u1, u2, use_prime,
                                  eta_outer, prev_flags, flags, bits, f)
            ctx.mark_non_differentiable(wi, pdf, flags)
            return f, wi, pdf, flags, alpha_i, eta_s

        @staticmethod
        def backward(ctx, g_f, _g_wi, _g_pdf, _g_flags, g_alpha_i, g_eta_s):
            *d, wo, wi, u1, u2, up, eo, pf, flags, bits, f = ctx.saved_tensors
            desc = bxdf.BsdfDesc(*d)
            cots = bsdf_ops._contiguous(g_f, g_alpha_i, g_eta_s)
            at = (_f64(desc), _f64(wo), _f64(wi), _f64(u1), _f64(u2), up,
                  _f64(eo), pf, flags)
            g = f32("witness, sample", bsdf_ops.f_bwd_cuda(
                "sample", desc, wo, wi, up, eo, *cots, u2=u2, prev_flags=pf,
                bits=bits), f,
                bsdf_ops.sample_at_bwd_plain(*at, *map(_f64, cots)),
                bsdf_ops.sample_at_plain(*at)[0],
                bsdf_ops.sample_bwd_plain(desc, wo, u1, u2, up, eo, pf,
                                          *cots))
            return (None, None, *g[:7], None, None, None, g[7], None)

    class Eval(torch.autograd.Function):
        @staticmethod
        def forward(ctx, n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                    alpha_prime, wo, wi, use_prime, eta_outer):
            desc, wo, wi, use_prime, eta_outer = bsdf_ops._contiguous(
                bxdf.BsdfDesc(n_lobes, lobe, rho_d, rho_s, tau, eta, alpha0,
                              alpha_prime), wo, wi, use_prime, eta_outer)
            f, pdf = bsdf_ops.eval_cuda(desc, wo, wi, use_prime, eta_outer)
            ctx.save_for_backward(*desc, wo, wi, use_prime, eta_outer, f)
            ctx.mark_non_differentiable(pdf)
            return f, pdf

        @staticmethod
        def backward(ctx, g_f, _g_pdf):
            *d, wo, wi, up, eo, f = ctx.saved_tensors
            desc = bxdf.BsdfDesc(*d)
            (g_f,) = bsdf_ops._contiguous(g_f)
            at = (_f64(desc), _f64(wo), _f64(wi), up, _f64(eo))
            g = f32("witness, eval", bsdf_ops.f_bwd_cuda(
                "eval", desc, wo, wi, up, eo, g_f), f,
                bsdf_ops.eval_bwd_plain(*at, _f64(g_f)),
                bsdf_ops.eval_plain(*at)[0],
                bsdf_ops.eval_bwd_plain(desc, wo, wi, up, eo, g_f))
            return (None, None, *g[:7], None, None, g[7])

    return ((lambda desc, *a: Sample.apply(*desc, *a)),
            (lambda desc, *a: Eval.apply(*desc, *a)), stats)


def leaf_witness():
    """`chip_smoke.py --witness`: which of the BSDF backward's two float32
    arithmetics lies nearer the float64 one on the leaves of phase 22's
    macbeth 1280x720 @ 4 spp fwd+bwd (the turns' cell whose leaves move
    with X3).  The same fwd+bwd (its forward the same bits every time)
    with the BSDF calls' backward by X3 and by the plain version's float32
    autograd VJP (sample_f and sample_eval_f replaced by bsdf_ops'
    sample_plain and sample_eval_plain: bxdf.py op by op, the parent's
    arithmetic), each on the kept graphed replay (the turns' route) and on
    the per-round replay, and by the float64 VJP of the plain version
    (_f64_bsdf_functions) on the per-round replay (a backward that runs
    autograd inside itself is not captured), where every BSDF call also
    holds X3 to that VJP and measures the plain float32 VJP against it,
    lane by lane, as phase 27 does.  For every leaf value where
    the graphed X3 and plain routes differ by more than rtol 1e-5 / atol
    1e-7 (the turns' tolerance) it logs the five values and each one's
    distance to the float64 route's, and the relative L2 distance of
    every leaf vector to it; raises unless on each such value X3's is the
    nearer of the two on both replays, or if the routes' losses, rays or
    rounds differ."""
    import gc

    import torch

    from nart_tpu_torch import bsdf_ops, grad, render, scene

    macbeth = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    (params,) = render.load_sessions(MACBETH, {"spp": 4})[:1]
    sess = render.RenderSession(macbeth, params, DEVICE)
    w, h = params.image_width, params.image_height
    samples = _image_samples(params, DEVICE)
    cot = _rgb_cot(samples)
    theta = grad.get_params(sess.scene)
    real = (bsdf_ops.sample_f, bsdf_ops.sample_eval_f)
    f64_sample, f64_eval, f64_stats = _f64_bsdf_functions()
    routes = {"x3": real, "plain": (bsdf_ops.sample_plain,
                                    bsdf_ops.sample_eval_plain),
              "float64": (f64_sample,
                          bsdf_ops.sample_then_eval(f64_sample, f64_eval))}
    runs = {}
    for name, per_round in (("x3", False), ("plain", False), ("x3", True),
                            ("plain", True), ("float64", True)):
        label = f"{name}, {'per-round' if per_round else 'graphed'}"
        bsdf_ops.sample_f, bsdf_ops.sample_eval_f = routes[name]
        try:
            machines = {}
            t0 = time.perf_counter()
            for _ in range(1 if per_round else 2):  # graphed: capture, then
                loss, grads, rays, rounds_ = (
                    grad.radiance_weighted_loss_and_grad(
                        sess.scene, theta, sess.accel, samples, cot, params,
                        w, h, machines=machines, per_round=per_round))
            torch.cuda.synchronize()
        finally:
            bsdf_ops.sample_f, bsdf_ops.sample_eval_f = real
        runs[label] = dict(loss=float(loss), rays=int(rays),
                           rounds=int(rounds_),
                           named={k: g.detach().reshape(-1).double().cpu()
                                  for k, g in _leaves(grads)})
        log(f"    witness, {label}: loss {float(loss)!r}, {int(rays)} rays, "
            f"{int(rounds_)} rounds, {time.perf_counter() - t0:.1f} s")
        del machines
        gc.collect()
        torch.cuda.empty_cache()
    st = f64_stats
    log(f"    witness, every BSDF call of the float64 route's backward "
        f"({st['calls']} calls, {st['lanes']} lanes): X3 within rtol "
        f"{BSDF_RTOL} / atol {BSDF_ATOL} of the float64 VJP on "
        f"{st['x3_within']} lanes (at most {st['x3_worst']:.3g} of the "
        f"tolerance), outside it on another float64 branch "
        f"{st['other_branch']}, a non-finite float64 VJP (zeroed) on "
        f"{st['non_finite']}; the plain float32 VJP outside the tolerance on "
        f"{st['plain32_outside']} lanes (up to {st['plain32_worst']:.3g} "
        "times it)")
    if len({(r["loss"], r["rays"], r["rounds"]) for r in runs.values()}) != 1:
        raise AssertionError("witness: the routes' forwards differ")
    ref = runs["float64, per-round"]["named"]
    for label, r in runs.items():
        num = sum(float(((r["named"][k] - x) ** 2).sum())
                  for k, x in ref.items())
        den = sum(float((x ** 2).sum()) for x in ref.values())
        log(f"    witness, {label}: every leaf's relative L2 distance to "
            f"the float64 route's {math.sqrt(num / den):.3e}")
    a, b = runs["x3, graphed"]["named"], runs["plain, graphed"]["named"]
    c, d = runs["x3, per-round"]["named"], runs["plain, per-round"]["named"]
    nearer, values = [], 0
    for k in ref:
        bad = ~torch.isclose(a[k], b[k], rtol=1e-5, atol=1e-7)
        for j in bad.nonzero()[:, 0].tolist():
            e = float(ref[k][j])
            vals = {lab: float(x[k][j]) for lab, x in (
                ("x3 graphed", a), ("plain graphed", b),
                ("x3 per-round", c), ("plain per-round", d))}
            log(f"    witness, {k}[{j}]: float64 {e!r}; " + "; ".join(
                f"{lab} {v!r} (off {abs(v - e):.4g})"
                for lab, v in vals.items()))
            values += 1
            nearer.append(
                abs(vals["x3 graphed"] - e) < abs(vals["plain graphed"] - e)
                and abs(vals["x3 per-round"] - e)
                < abs(vals["plain per-round"] - e))
    log(f"    witness: {values} leaf values where X3 and the plain VJP "
        f"differ past rtol 1e-5 / atol 1e-7; X3 the nearer to the float64 "
        f"VJP on {sum(nearer)} of them, on both replays")
    if not all(nearer):
        raise AssertionError("witness: the plain float32 VJP is nearer the "
                             "float64 one on some leaf value")



def _f64_flight_steps(mag):
    """vol_ops.flight_steps with a float64 backward: V1 forward (the plain
    steps' bits), and backward the float64 VJP of the plain steps
    (vol_ops.flight_steps_vjp_reference), its rows summed into the cells
    by a float64 index_add_ and its partials by float64 sums, each round's
    sums rounded once to float32: the witness of the flight steps' leaf
    gradients.  The rows' magnitudes are summed into mag["cells"] (float64,
    over every backward round)."""
    import torch
    from torch.autograd.function import once_differentiable

    from nart_tpu_torch import vol_ops

    nf = len(vol_ops.FIELDS)
    beta, l_out = vol_ops.FIELDS.index("beta"), vol_ops.FIELDS.index("l_out")

    class F64Steps(torch.autograd.Function):
        @staticmethod
        def forward(ctx, k, bounces, medium, acc, *args):
            ctx.set_materialize_grads(False)
            ctx.k, ctx.bounces, ctx.medium = k, bounces, medium
            ctx.save_for_backward(*args)
            outs = vol_ops.steps_cuda(k, bounces, tuple(medium.density.shape),
                                      *args, seg=acc[0])[:-1]
            ctx.mark_non_differentiable(*[
                o for j, o in enumerate(outs) if j not in (beta, l_out)])
            return outs

        @staticmethod
        @once_differentiable
        def backward(ctx, *grads):
            args = ctx.saved_tensors
            vs = vol_ops.VolState(*args[:nf])
            cells, sig_a, sig_s, le = args[nf:nf + 4]
            g_b = (torch.zeros_like(vs.beta) if grads[beta] is None
                   else grads[beta])
            g_l = (torch.zeros_like(vs.l_out) if grads[l_out] is None
                   else grads[l_out])
            g_bi, g_li, rows, idx, p_sa, p_ss, p_le, _ = (
                vol_ops.flight_steps_vjp_reference(
                    vs, ctx.k, cells, ctx.medium, args[-1], ctx.bounces, g_b,
                    g_l))
            g_cells = torch.zeros(cells.shape, dtype=torch.float64,
                                  device=cells.device).index_add_(
                0, idx.reshape(-1), rows.reshape(-1, 8))
            if "cells" not in mag:
                mag["cells"] = torch.zeros_like(g_cells)
            mag["cells"].index_add_(0, idx.reshape(-1),
                                    rows.abs().reshape(-1, 8))
            out = [None] * (4 + len(args))  # k, bounces, medium, acc
            out[4 + beta], out[4 + l_out] = g_bi.float(), g_li.float()
            out[4 + nf:4 + nf + 4] = (
                g_cells.float(), p_sa.sum().float().reshape(sig_a.shape),
                p_ss.sum().float().reshape(sig_s.shape), p_le.sum(0).float())
            return tuple(out)

    def flight_steps(vs, k, cells, medium, sigma_maj, bounces, seg=None):
        if seg is None:
            seg = torch.zeros((), dtype=torch.int64, device=vs.o.device)
        outs = F64Steps.apply(
            k, bounces, medium, (seg,),
            *[getattr(vs, f).contiguous() for f in vol_ops.FIELDS], cells,
            medium.sigma_a, medium.sigma_s, medium.le, medium.bounds_min,
            medium.bounds_max, sigma_maj)
        return (vol_ops.VolState(*outs[:nf]), *outs[nf:], seg)

    return flight_steps


def vol_leaf_witness():
    """--vol-witness: volume_blob's fwd+bwd (1280x720 @ 4, one chunk, cot =
    1 on RGB, the per-round replay) with the flight steps' backward by V2
    (vol_ops' Function), by float32 autograd of the plain steps (the route
    before V2, vol_ops.flight_steps_plain) and by the float64 VJP
    (_f64_flight_steps); the loss the same bits on the three; on each leaf
    value where V2 and the plain route differ past rtol 1e-5 / atol 1e-7,
    which lies nearer the float64 one, and each route's values outside
    that tolerance of the float64 one; on the density's leaf, each route's
    distance from the float64 one over the float64 sum of its terms'
    magnitudes (the rows of every step and round, through the cells'
    packing)."""
    import torch

    from nart_tpu_torch import grad, vol_ops

    params, sess = volume_session({"image_width": 1280, "image_height": 720,
                                   "spp": 4})
    samples = _image_samples(params, DEVICE)
    cot = _rgb_cot(samples)
    theta = grad.get_params(sess.scene)
    from nart_tpu_torch import media

    real = vol_ops.flight_steps
    mag = {}
    routes = {"V2": real, "plain float32": vol_ops.flight_steps_plain,
              "float64": _f64_flight_steps(mag)}
    leaves, losses, density = {}, {}, {}
    for name, fn in routes.items():
        vol_ops.flight_steps = fn
        try:
            t0 = time.perf_counter()
            loss, grads, _, rounds = grad.radiance_weighted_loss_and_grad(
                sess.scene, theta, None, samples, cot, params,
                params.image_width, params.image_height, per_round=True)
            torch.cuda.synchronize()
        finally:
            vol_ops.flight_steps = real
        leaves[name] = grad.flatten_leaves(grads).double()
        density[name] = grads["medium"]["density"].double()
        losses[name] = float(loss)
        log(f"    {name}: loss {float(loss)!r}, {rounds} rounds, "
            f"{time.perf_counter() - t0:.1f} s")
    if len(set(losses.values())) != 1:
        raise AssertionError(f"the routes' losses differ: {losses}")
    a, p, w = leaves["V2"], leaves["plain float32"], leaves["float64"]

    def off(x, y):
        return ~torch.isclose(x, y, rtol=1e-5, atol=1e-7)

    split = off(a, p)
    nearer = ((a - w).abs() < (p - w).abs()) & split
    tie = ((a - w).abs() == (p - w).abs()) & split
    log(f"    {int(split.sum())} of {a.numel()} leaf values where V2 and the "
        f"plain route differ past rtol 1e-5 / atol 1e-7: V2 nearer the "
        f"float64 VJP on {int(nearer.sum())}, the plain route on "
        f"{int((split & ~nearer & ~tie).sum())}, as near on {int(tie.sum())}"
        f"; outside that tolerance of the float64 one: V2 "
        f"{int(off(a, w).sum())}, the plain route {int(off(p, w).sum())}; "
        f"largest |V2 - float64| {float((a - w).abs().max()):.3g}, "
        f"|plain - float64| {float((p - w).abs().max()):.3g}")
    for j in split.nonzero()[:8, 0].tolist():
        log(f"        [{j}] V2 {float(a[j])!r}, plain {float(p[j])!r}, "
            f"float64 {float(w[j])!r}")
    dens = sess.scene.medium.density.detach().double().requires_grad_()
    (size,) = torch.autograd.grad(media.pack_density_cells(dens), dens,
                                  mag["cells"])
    ref = density["float64"]
    split_d = off(density["V2"], density["plain float32"])
    reached = size > 0
    for name in ("V2", "plain float32"):
        rel = (density[name] - ref).abs() / size.clamp(min=1e-30)
        log(f"    density ({int(reached.sum())} values reached): {name}'s "
            f"distance from the float64 one over the float64 sum of its "
            f"terms' magnitudes at most {float(rel.max()):.3g}, on the "
            f"{int(split_d.sum())} values split above at most "
            f"{float(rel[split_d].max()) if bool(split_d.any()) else 0:.3g}")
    share = ref.abs() / size.clamp(min=1e-30)
    log(f"    density: the leaf's size over that sum, median "
        f"{float(share[reached].median()):.3g} over the reached values, "
        f"at most {float(share[split_d].max()) if bool(split_d.any()) else 0:.3g}"
        " on the split ones")

def _macbeth_mesh_ids(device, lanes):
    """(the mesh ids of `lanes` macbeth camera rays' closest hits through
    random pixels of the 1280x720 view, clamped to the table as small_lut
    clamps them (a miss's -1 to 0), the mesh count)."""
    import torch

    from nart_tpu_torch import cluster_accel as ca, scene

    sc = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    acc = ca.build_clusters(sc.tri_v.numpy()).to(device)
    hit = ca.intersect_clusters(
        *camera_rays(sc, lanes, np.random.default_rng(0), device), acc)
    n_mesh = sc.mat_type.shape[0]
    mesh = sc.tri_mesh.to(device).long()[hit.tri.clamp(min=0)]
    return torch.where(hit.tri >= 0, mesh, -1).clamp(0, n_mesh - 1), n_mesh


def _captured_lut(fwd, bwd, table, g, idx, n):
    """A look-up's forward and backward wrappers (fwd(table, idx),
    bwd(g, idx, n)) captured into a CUDA graph (after a warm launch on a
    side stream) and replayed once: copies of (out, d_table)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd(table, idx)
        bwd(g, idx, n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fwd(table, idx)
        d_table = bwd(g, idx, n)
    graph.replay()
    torch.cuda.synchronize()
    return out.clone(), d_table.clone()


def lut_bound(lanes, n, width, backward):
    """Least time the card could take (ms) for a look-up and what sets it:
    lut_many_bound of one (n, width) table."""
    return lut_many_bound(lanes, [(n, width)], backward)


def _bwd_one(g, idx, n):
    """The small-table backward of one table: the many-table kernel of
    one (the path's route)."""
    from nart_tpu_torch import select

    return select.lut_gather_bwd_many_cuda([g], idx, [n])[0]


def lut_many_bound(lanes, shapes, backward):
    """Least time the card could take (ms) for one look-up of tables
    (rows, width) by one idx, and what sets it.  Bytes: idx (8 B a lane)
    read once, each table's lanes' values (4 * width B a lane: the output,
    or the cotangent read) and its (rows, width) table (read, or written)
    once.  Operations: none in the forward (a copy), one float32 addition
    a lane's value in the backward, over 67 TFLOP/s."""
    width = sum(w for _, w in shapes)
    nbytes = lanes * (8 + 4 * width) + 4 * sum(n * w for n, w in shapes)
    ops = lanes * width if backward else 0
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def _many_bwd_checks(label, idx, shapes, rng):
    """The many-table backward of tables (rows, width) read by idx: each
    table's sums the two-launch route's bits (one call a table, on the
    clamped rows), within rtol / atol of the float64 sum (signed
    cotangents: rtol times the sum of magnitudes; positive ones), integer
    cotangents' sums exact, the same bits on a second call and from a CUDA
    graph's replay.
    Returns the max abs error against the float64 sums."""
    import torch

    from nart_tpu_torch import select

    device = idx.device
    lanes = idx.shape[0]
    rows = [n for n, _ in shapes]
    lane_shapes = [(lanes, w) if w > 1 else (lanes,) for _, w in shapes]
    g = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
         for s in lane_shapes]
    g_pos = [torch.from_numpy(rng.random(s, dtype=np.float32)).to(device)
             for s in lane_shapes]
    g_int = [torch.from_numpy(rng.integers(-LUT_INT, LUT_INT + 1, s)).to(
        device) for s in lane_shapes]
    many = select.lut_gather_bwd_many_cuda
    d1, d2 = many(g, idx, rows), many(g, idx, rows)
    d_pos = many(g_pos, idx, rows)
    d_int = many([x.float() for x in g_int], idx, rows)
    captured = _captured_many(lambda x, i: many(x, i, rows), g, idx)
    err = 0.0
    for k, n in enumerate(rows):
        ci = idx.clamp(0, n - 1)
        shape = (n,) + tuple(g[k].shape[1:])
        ref = select.lut_gather_bwd_cuda(g[k], ci, n)

        def f64_sum(x):
            return torch.zeros(shape, dtype=torch.float64,
                               device=device).index_add_(0, ci, x.double())

        want_int = torch.zeros(shape, dtype=torch.int64,
                               device=device).index_add_(0, ci, g_int[k])
        e = (d1[k].double() - f64_sum(g[k])).abs()
        e_pos = (d_pos[k].double() - f64_sum(g_pos[k])).abs()
        where = f"many-table backward {label}, table {k} ({shape})"
        if not torch.equal(d1[k], ref):
            raise AssertionError(f"{where}: other bits than the two-launch "
                                 "route")
        if not (torch.equal(d1[k], d2[k])
                and torch.equal(d1[k], captured[k])):
            raise AssertionError(f"{where}: other bits on a second call or "
                                 "from a graph's replay")
        if not torch.equal(d_int[k], want_int.float()):
            raise AssertionError(f"{where}: integer sums off the int64 "
                                 "index_add_")
        if not (bool((e <= LUT_ATOL + LUT_RTOL * f64_sum(g[k].abs())).all())
                and torch.allclose(d_pos[k].double(), f64_sum(g_pos[k]),
                                   rtol=LUT_RTOL, atol=LUT_ATOL)):
            raise AssertionError(f"{where}: off the float64 sum by "
                                 f"{float(e.max())} (signed), "
                                 f"{float(e_pos.max())} (positive)")
        err = max(err, float(e.max()), float(e_pos.max()))
    return err


def lut_checks(device):
    """Phase 23: the small-table look-up kernels against their plain
    versions.  Returns their records at the main path's shape (the macbeth
    mesh ids, rows of 3)."""
    import torch

    from nart_tpu_torch import select

    rng = np.random.default_rng(23)
    mesh, n_mesh = _macbeth_mesh_ids(device, LUT_LANES[0])
    cases = [(f"macbeth mesh ids, N={LUT_LANES[0]}, n={n_mesh}", mesh,
              n_mesh)]
    for lanes in LUT_LANES:
        for n in LUT_ROWS:
            cases.append((f"uniform, N={lanes}, n={n}", torch.from_numpy(
                rng.integers(0, n, lanes)).to(device), n))
            cases.append((f"one row, N={lanes}, n={n}", torch.full(
                (lanes,), int(rng.integers(0, n)), dtype=torch.int64,
                device=device), n))
    err_f = err_b = 0.0
    for label, idx, n in cases:
        for width in LUT_WIDTHS:
            shape = (n,) if width == 1 else (n, width)
            lanes_shape = (idx.shape[0],) + shape[1:]
            table = torch.from_numpy(
                rng.normal(size=shape).astype(np.float32)).to(device)
            # signed cotangents, and positive ones, whose sums do not
            # cancel: a float32 sum's rounding follows the sum of the
            # terms' magnitudes, so the signed sums are held to rtol times
            # that (plus atol), the positive ones to rtol times the sum
            g = torch.from_numpy(
                rng.normal(size=lanes_shape).astype(np.float32)).to(device)
            g_pos = torch.from_numpy(
                rng.random(lanes_shape, dtype=np.float32)).to(device)
            # and small integers, whose float32 sums in any order are exact
            # (every partial sum below 2^24): one lane dropped or counted
            # twice shows in the bits
            g_int = torch.from_numpy(
                rng.integers(-LUT_INT, LUT_INT + 1, lanes_shape)).to(device)
            out = select.lut_gather_cuda(table, idx)
            d1 = _bwd_one(g, idx, n)
            d2 = _bwd_one(g, idx, n)
            d_pos = _bwd_one(g_pos, idx, n)
            d_int = _bwd_one(g_int.float(), idx, n)
            d_ref = select.lut_gather_bwd_cuda(g, idx, n)
            want_int = torch.zeros(shape, dtype=torch.int64,
                                   device=device).index_add_(0, idx, g_int)
            out_g, d_g = _captured_lut(select.lut_gather_cuda, _bwd_one,
                                       table, g, idx, n)
            plain = select.lut_gather_plain(table, idx)

            def f64_sum(x):
                return torch.zeros(shape, dtype=torch.float64,
                                   device=device).index_add_(0, idx,
                                                             x.double())

            want, want_pos = f64_sum(g), f64_sum(g_pos)
            scale = f64_sum(g.abs())
            torch.cuda.synchronize()
            where = f"look-up {label}, rows of {width}"
            if not torch.equal(out, plain):
                raise AssertionError(f"{where}: the forward kernel differs "
                                     "from the plain gather")
            if not (torch.equal(d1, d2) and torch.equal(d_g, d1)
                    and torch.equal(out_g, out)):
                raise AssertionError(f"{where}: other bits on a second "
                                     "launch or from a graph's replay")
            if not torch.equal(d1, d_ref):
                raise AssertionError(
                    f"{where}: the many-table backward's bits differ from "
                    "the two-launch route's, max abs diff "
                    f"{float((d1 - d_ref).abs().max())}")
            if not torch.equal(d_int, want_int.float()):
                raise AssertionError(
                    f"{where}: the backward kernel's sums of integer "
                    f"cotangents are off the int64 index_add_ by "
                    f"{float((d_int.double() - want_int).abs().max())}")
            err = (d1.double() - want).abs()
            err_pos = (d_pos.double() - want_pos).abs()
            if not (bool((err <= LUT_ATOL + LUT_RTOL * scale).all())
                    and torch.allclose(d_pos.double(), want_pos,
                                       rtol=LUT_RTOL, atol=LUT_ATOL)):
                raise AssertionError(
                    f"{where}: the backward kernel is off the float64 sum "
                    f"by {float(err.max())} (signed), "
                    f"{float(err_pos.max())} (positive)")
            err_f = max(err_f, float((out - plain).abs().max()))
            err_b = max(err_b, float(err.max()), float(err_pos.max()))
    # the many-table forward: one launch reads every width at once, the
    # bits of one launch a table and of the plain gathers, in a graph too
    for label, idx, n in cases:
        tables = [torch.from_numpy(rng.normal(size=(n, w) if w > 1 else (n,))
                                   .astype(np.float32)).to(device)
                  for w in LUT_MANY_WIDTHS]
        outs = select.lut_gather_many_cuda(tables, idx)
        singles = [select.lut_gather_cuda(t, idx) for t in tables]
        captured = _captured_many(select.lut_gather_many_cuda, tables, idx)
        torch.cuda.synchronize()
        for t, o, o1, og in zip(tables, outs, singles, captured):
            if not (torch.equal(o, select.lut_gather_plain(t, idx))
                    and torch.equal(o, o1) and torch.equal(o, og)):
                raise AssertionError(
                    f"many-table look-up {label}, rows of "
                    f"{tuple(t.shape[1:])}: other bits than the plain "
                    "gather, one launch a table or a graph's replay")
    log(f"many-table forward, {len(cases)} cases, {len(LUT_MANY_WIDTHS)} "
        f"tables of widths {LUT_MANY_WIDTHS} in one launch: the plain "
        "gathers' bits, those of one launch a table, and from a CUDA graph's "
        "replay")
    # the many-table backward: every case's tables in one launch, held to
    # the two-launch route table by table
    light = torch.zeros(LUT_LANES[1], dtype=torch.int64, device=device)
    many_bwd = [("16 tables", torch.from_numpy(rng.integers(
                    -3, 67, LUT_LANES[0])).to(device), LUT_BWD_MIX),
                ("make_bsdf's five trainable tables, macbeth mesh ids",
                 mesh, [(n_mesh, w) for w in MAKE_BSDF_WIDTHS]),
                ("le and intensity, one light row", light, [(1, 3), (1, 1)])]
    for label, idx, shapes in many_bwd:
        err_b = max(err_b, _many_bwd_checks(label, idx, shapes, rng))
    for label, idx, n in cases:
        err_b = max(err_b, _many_bwd_checks(
            label, idx, [(n, w) for w in LUT_WIDTHS], rng))
    log(f"many-table backward, {len(many_bwd) + len(cases)} cases ("
        f"{', '.join(c[0] for c in many_bwd)}; the rows of {LUT_WIDTHS} of "
        "each case above together): each table's sums the bits of the "
        "two-launch route (one call a table), "
        f"within rtol {LUT_RTOL} / atol {LUT_ATOL} of the float64 sums, "
        "integer sums exact, the same bits on a second call and from a CUDA "
        "graph's replay")
    log(f"look-up kernels, {len(cases) * len(LUT_WIDTHS)} cases (N in "
        f"{LUT_LANES}, n in {LUT_ROWS}, rows of {LUT_WIDTHS}; uniform, one "
        f"row, macbeth's mesh ids): the forward the plain gather's bits; the "
        f"backward (the many-table kernel of one table) the two-launch "
        f"route's bits, against the float64 index_add_ within rtol "
        f"{LUT_RTOL} / "
        f"atol {LUT_ATOL} (positive cotangents; signed ones: rtol times the "
        f"sum of their magnitudes), max abs err {err_b:.3g}, and integer "
        f"cotangents in [-{LUT_INT}, {LUT_INT}] the int64 index_add_'s bits; "
        "the same bits on a second launch and from a CUDA graph's replay")

    # times: the main path's shape (macbeth's mesh ids, the per-mesh rows
    # of 3), the bench's one light row, a table of 64 rows; device ms (many
    # launches in one graph), and the kernels' ms per call, host included
    emb_bwd = torch.ops.aten.embedding_dense_backward
    shapes = [("macbeth mesh ids", mesh, n_mesh),
              ("one light row", torch.zeros(LUT_LANES[1], dtype=torch.int64,
                                            device=device), 1),
              ("uniform over 64 rows", torch.from_numpy(
                  rng.integers(0, 64, LUT_LANES[0])).to(device), 64)]
    records = None
    reps = SIZES["reps"]
    for label, idx, n in shapes:
        lanes = idx.shape[0]
        table = torch.from_numpy(
            rng.normal(size=(n, 3)).astype(np.float32)).to(device)
        g = torch.from_numpy(
            rng.normal(size=(lanes, 3)).astype(np.float32)).to(device)
        t = {
            "fwd": kernel_ms(lambda: select.lut_gather_cuda(table, idx),
                             reps),
            "bwd": kernel_ms(lambda: _bwd_one(g, idx, n), reps),
            "bwd_reference": kernel_ms(
                lambda: select.lut_gather_bwd_cuda(g, idx, n), reps),
            "fwd_plain": device_ms(
                lambda: select.lut_gather_plain(table, idx)),
            "bwd_plain": kernel_ms(
                lambda: select.lut_gather_bwd_plain(g, idx, n), 3),
            "fwd_library": device_ms(
                lambda: torch.nn.functional.embedding(idx, table)),
            "bwd_library": device_ms(lambda: emb_bwd(g, idx, n, -1, False)),
            "bwd_index_add": device_ms(
                lambda: g.new_zeros((n, 3)).index_add_(0, idx, g)),
        }
        fb, bb = lut_bound(lanes, n, 3, False), lut_bound(lanes, n, 3, True)
        log(f"time look-up {label}, N={lanes}, n={n}, rows of 3: forward "
            f"kernel {fmt(t['fwd'])}, plain {fmt(t['fwd_plain'])}, "
            f"F.embedding {fmt(t['fwd_library'])}, bound "
            f"{fb['bound_ms']:.6f} ms ({fb['bound_by']}); backward kernel "
            f"{fmt(t['bwd'])}, the two-launch route "
            f"{fmt(t['bwd_reference'])}, plain (index_put_, "
            f"indexing_backward) {fmt(t['bwd_plain'])}, "
            f"embedding_dense_backward {fmt(t['bwd_library'])}, zeros + "
            f"index_add_ {fmt(t['bwd_index_add'])}, bound "
            f"{bb['bound_ms']:.6f} ms ({bb['bound_by']})")
        if records is None:
            records = {
                "lut_gather": dict(max_abs_err=err_f, **_rec(t, "fwd"), **fb),
                "lut_gather_bwd": dict(
                    max_abs_err=err_b, **_rec(t, "bwd"), **bb,
                    reference_ms=t["bwd_reference"]["ms"],
                    reference_ms_per_call=t["bwd_reference"]["ms_per_call"],
                    index_add_ms=t["bwd_index_add"]["ms"]),
            }
    # the many-table forward at the main path's two reads: make_bsdf's six
    # float per-mesh tables at macbeth's mesh ids, and area_pack_sample's ten
    # float light fields on the bench's one light row
    many = {}
    for label, idx, n, widths in (
            ("make_bsdf's per-mesh tables, macbeth mesh ids", mesh, n_mesh,
             (3, 3, 3, 1, 1, 3)),
            ("area_pack_sample's light fields, one light row",
             shapes[1][1], 1, (1, 1, 1, 1, 3, 3, 3, 3, 3, 1))):
        tables = [torch.from_numpy(rng.normal(size=(n, w) if w > 1 else (n,))
                                   .astype(np.float32)).to(device)
                  for w in widths]
        t = {
            "one": kernel_ms(
                lambda: select.lut_gather_many_cuda(tables, idx), reps),
            "each": kernel_ms(lambda: [select.lut_gather_cuda(x, idx)
                                       for x in tables], reps),
            "plain": device_ms(lambda: [select.lut_gather_plain(x, idx)
                                        for x in tables]),
            "embedding": device_ms(lambda: [
                torch.nn.functional.embedding(idx, x.reshape(n, -1))
                for x in tables]),
        }
        lanes = idx.shape[0]
        nbytes = lanes * 8 + sum(4 * w * (lanes + n) for w in widths)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        log(f"time many-table look-up, {label}: {len(widths)} tables of "
            f"widths {widths}, N={lanes}, n={n}: one launch {fmt(t['one'])}, "
            f"one launch a table {fmt(t['each'])}, plain (table[idx] each) "
            f"{fmt(t['plain'])}, F.embedding each {fmt(t['embedding'])}, "
            f"bound {bound_ms:.6f} ms (bytes: {nbytes})")
        many[label] = dict(tables=len(widths), ms=t["one"]["ms"],
                           ms_min=t["one"]["min"], ms_max=t["one"]["max"],
                           ms_per_call=t["one"]["ms_per_call"],
                           one_launch_a_table_ms=t["each"]["ms"],
                           plain_ms=t["plain"]["ms"],
                           embedding_each_ms=t["embedding"]["ms"],
                           bound_ms=bound_ms, bytes=nbytes)
    records["lut_gather"]["many"] = many
    # the many-table backward at the main path's two: make_bsdf's five
    # trainable per-mesh tables at macbeth's mesh ids, and a light's le and
    # intensity on the bench's one light row; and the 16-table mix.  One
    # launch for all, and, a table at a time, the two-launch route, the
    # plain version, embedding_dense_backward and zeros + index_add_; graph
    # nodes a call
    many = {}
    for label, idx, shapes in many_bwd:
        lanes = idx.shape[0]
        rows = [n for n, _ in shapes]
        g = [torch.from_numpy(rng.normal(size=(lanes, w) if w > 1 else lanes)
                              .astype(np.float32)).to(device)
             for _, w in shapes]
        cis = [idx.clamp(0, n - 1) for n in rows]
        t = {
            "one": kernel_ms(
                lambda: select.lut_gather_bwd_many_cuda(g, idx, rows), reps),
            "reference": kernel_ms(lambda: [
                select.lut_gather_bwd_cuda(x, ci, n)
                for x, ci, n in zip(g, cis, rows)], reps),
            "plain": kernel_ms(lambda: [
                select.lut_gather_bwd_plain(x, ci, n)
                for x, ci, n in zip(g, cis, rows)], 3),
            "embedding": device_ms(lambda: [
                emb_bwd(x.reshape(lanes, -1), ci, n, -1, False)
                for x, ci, n in zip(g, cis, rows)]),
            "index_add": device_ms(lambda: [
                x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, ci, x)
                for x, ci, n in zip(g, cis, rows)]),
        }
        nodes = graph_nodes(
            lambda: select.lut_gather_bwd_many_cuda(g, idx, rows))
        nodes_ref = graph_nodes(lambda: [
            select.lut_gather_bwd_cuda(x, ci, n)
            for x, ci, n in zip(g, cis, rows)])
        if nodes != 1:
            raise AssertionError(f"many-table backward {label}: {nodes} graph "
                                 "nodes a call, not one kernel node")
        b = lut_many_bound(lanes, shapes, True)
        log(f"time many-table backward, {label}: {len(shapes)} tables "
            f"(rows, width) {shapes}, N={lanes}: one launch {fmt(t['one'])} "
            f"in {nodes} graph node; the two-launch route a table "
            f"{fmt(t['reference'])} in {nodes_ref} nodes, plain (index_put_ "
            f"each) {fmt(t['plain'])}, embedding_dense_backward each "
            f"{fmt(t['embedding'])}, zeros + index_add_ each "
            f"{fmt(t['index_add'])}, bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}: {b['bytes']} bytes), "
            f"{100.0 * b['bound_ms'] / t['one']['ms']:.3f}% of it reached")
        many[label] = dict(
            tables=len(shapes), ms=t["one"]["ms"], ms_min=t["one"]["min"],
            ms_max=t["one"]["max"], ms_per_call=t["one"]["ms_per_call"],
            reference_each_ms=t["reference"]["ms"],
            reference_each_ms_per_call=t["reference"]["ms_per_call"],
            plain_ms=t["plain"]["ms"], embedding_each_ms=t["embedding"]["ms"],
            index_add_each_ms=t["index_add"]["ms"], nodes_per_call=nodes,
            reference_nodes_per_call=nodes_ref, **b)
    records["lut_gather_bwd"]["many"] = many
    for k, r in records.items():
        log(f"bound {k}: {r['bound_ms']:.6f} ms by {r['bound_by']} "
            f"({r['bytes']} bytes; {r['operations']} operations): the kernel "
            f"reaches {100.0 * r['bound_ms'] / r['ms']:.3f}% of it")
    return records


def _rec(t, key):
    """A look-up record's times from phase 23's or 24's readings t: the
    kernel's device ms with its spread and its ms per call, host included;
    the plain version's and the library call's device ms."""
    k = t[key]
    return dict(ms=k["ms"], ms_min=k["min"], ms_max=k["max"],
                ms_per_call=k["ms_per_call"], plain_ms=t[key + "_plain"]["ms"],
                library_ms=t[key + "_library"]["ms"])


def _captured_many(fwd, tables, idx):
    """fwd(tables, idx) captured into a CUDA graph (after a warm launch on a
    side stream) and replayed once: copies of its outputs."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fwd(tables, idx)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fwd(tables, idx)
    graph.replay()
    torch.cuda.synchronize()
    return [o.clone() for o in outs]


def _large_indices(kind, n, lanes, rng, device):
    """A large-table case's rows: uniform, all on one row, long runs (half
    the lanes on one row, a quarter on another, the rest uniform), or
    masked (half the lanes -1, clamped to row 0, as a masked fetch's)."""
    import torch

    if kind == "uniform":
        idx = rng.integers(0, n, lanes)
    elif kind == "one row":
        idx = np.full(lanes, rng.integers(0, n))
    elif kind == "runs":
        idx = rng.integers(0, n, lanes)
        pick = rng.random(lanes)
        idx[pick < 0.5] = rng.integers(0, n)
        idx[(pick >= 0.5) & (pick < 0.75)] = rng.integers(0, n)
    else:
        idx = rng.integers(0, n, lanes)
        idx[rng.random(lanes) < 0.5] = -1
    return torch.from_numpy(idx).to(device)


def _sorted_route(g, idx, n):
    """The sorted route of the large-table backward, the yardstick the radix
    route is held to: a stable torch.sort of the clamped rows as int32,
    then the segmented sum and the carry given that order."""
    import torch

    from nart_tpu_torch import select

    keys, perm = torch.sort(idx.clamp(0, n - 1).to(torch.int32), stable=True)
    return select.lut_gather_large_bwd_sorted_cuda(g, keys, perm, n)


def graph_nodes(fn):
    """The nodes (kernels, memsets, copies) of a CUDA graph that captures
    one call of fn after a warm call on a side stream, as the driver counts
    them (cuGraphGetNodes on the kept graph)."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {rc}")
    return count.value


def large_lut_checks(device):
    """Phase 24: the large-table look-ups (the forward kernel, and the
    backward kernel S2) against their plain versions and the sorted route
    (torch.sort, then the same segmented sum) at the main path's shapes,
    and the two backward kernels against each other on small tables.
    Returns S2's record at the env map's shape (the most launches a
    macbeth round), with every shape's times under "shapes" and the
    backward kernels' side by side under "against_small", and the forward
    kernel's times at these shapes ("lut_gather_shapes")."""
    import torch

    from nart_tpu_torch import select

    rng = np.random.default_rng(24)
    err_f = err_b = 0.0
    kinds = ("uniform", "one row", "runs", "masked")
    for label, lanes, n, width in LARGE_SHAPES:
        table = torch.from_numpy(
            rng.normal(size=(n, width)).astype(np.float32)).to(device)
        for kind in kinds:
            idx = _large_indices(kind, n, lanes, rng, device)
            ci = idx.clamp(0, n - 1)
            shape = (n, width)
            g = torch.from_numpy(
                rng.normal(size=(lanes, width)).astype(np.float32)).to(device)
            g_int = torch.from_numpy(
                rng.integers(-LUT_INT, LUT_INT + 1, (lanes, width))).to(device)
            out = select.lut_gather_cuda(table, idx)
            d1, keys, lanes_sorted = select.lut_gather_large_bwd_order_cuda(
                g, idx, n)
            d2 = select.lut_gather_large_bwd_cuda(g, idx, n)
            d_int = select.lut_gather_large_bwd_cuda(g_int.float(), idx, n)
            d_sorted = _sorted_route(g, idx, n)
            # the backward's sort is captured with it
            out_g, d_g = _captured_lut(select.lut_gather_cuda,
                                       select.lut_gather_large_bwd_cuda,
                                       table, g, idx, n)
            plain = select.lut_gather_plain(table, ci)
            want_int = torch.zeros(shape, dtype=torch.int64,
                                   device=device).index_add_(0, ci, g_int)
            keys_t, perm_t = torch.sort(ci.to(torch.int32), stable=True)
            keys_p, lanes_p = select.radix_order_plain(idx, n)

            def f64_sum(x):
                return torch.zeros(shape, dtype=torch.float64,
                                   device=device).index_add_(0, ci,
                                                             x.double())

            want, scale = f64_sum(g), f64_sum(g.abs())
            torch.cuda.synchronize()
            where = f"large look-up {label}, {kind}"
            if not torch.equal(out, plain):
                raise AssertionError(f"{where}: the forward kernel differs "
                                     "from the plain gather")
            if not (torch.equal(keys, keys_t)
                    and torch.equal(lanes_sorted.long(), perm_t)
                    and torch.equal(keys, keys_p)
                    and torch.equal(lanes_sorted, lanes_p)):
                raise AssertionError(
                    f"{where}: the radix sort's order is not "
                    "torch.sort(stable=True)'s or radix_order_plain's")
            if not torch.equal(d1, d_sorted):
                raise AssertionError(
                    f"{where}: other bits than the sorted route (torch.sort "
                    "and the same segmented sum), max abs diff "
                    f"{float((d1 - d_sorted).abs().max())}")
            if not (torch.equal(d1, d2) and torch.equal(d_g, d1)
                    and torch.equal(out_g, out)):
                raise AssertionError(f"{where}: other bits on a second "
                                     "launch or from a graph's replay")
            if not torch.equal(d_int, want_int.float()):
                raise AssertionError(
                    f"{where}: the backward kernel's sums of integer "
                    f"cotangents are off the int64 index_add_ by "
                    f"{float((d_int.double() - want_int).abs().max())}")
            err = (d1.double() - want).abs()
            if not bool((err <= LUT_ATOL + LUT_RTOL * scale).all()):
                raise AssertionError(
                    f"{where}: the backward kernel is off the float64 sum "
                    f"by {float(err.max())}")
            err_f = max(err_f, float((out - plain).abs().max()))
            err_b = max(err_b, float(err.max()))
            del want, scale, want_int
    log(f"large-table look-up kernels, {len(LARGE_SHAPES) * len(kinds)} "
        f"cases ({', '.join(s[0] for s in LARGE_SHAPES)}; {', '.join(kinds)}"
        f"): the forward the plain gather's bits; the radix sort's order "
        f"torch.sort(stable=True)'s and radix_order_plain's; the backward "
        f"the bits of the sorted route (torch.sort, then the same segmented "
        f"sum), within atol {LUT_ATOL} plus rtol {LUT_RTOL} times the sum of "
        f"the cotangents' magnitudes of the float64 index_add_, max abs err "
        f"{err_b:.3g}, integer cotangents in [-{LUT_INT}, {LUT_INT}] the "
        "int64 index_add_'s bits; the same bits on a second launch and from "
        "a CUDA graph's replay")

    # times at each shape: uniform rows, and every lane on one row (the
    # plain backward's worst case); device ms (many launches in one graph)
    # of the radix route, the sorted route, the plain version and the library
    # calls, and the radix route's ms per call, host included
    emb_bwd = torch.ops.aten.embedding_dense_backward
    reps = SIZES["reps"]
    shapes = {}
    for label, lanes, n, width in LARGE_SHAPES:
        table = torch.from_numpy(
            rng.normal(size=(n, width)).astype(np.float32)).to(device)
        g = torch.from_numpy(
            rng.normal(size=(lanes, width)).astype(np.float32)).to(device)
        for kind in kinds[:2]:
            idx = _large_indices(kind, n, lanes, rng, device)
            touched = int(torch.unique(idx).numel())
            t = {
                "fwd": kernel_ms(
                    lambda: select.lut_gather_cuda(table, idx), reps),
                "bwd": kernel_ms(
                    lambda: select.lut_gather_large_bwd_cuda(g, idx, n),
                    reps),
                "bwd_sorted": kernel_ms(lambda: _sorted_route(g, idx, n),
                                      reps),
                "fwd_plain": device_ms(
                    lambda: select.lut_gather_plain(table, idx)),
                "bwd_plain": kernel_ms(
                    lambda: select.lut_gather_bwd_plain(g, idx, n), 3),
                "fwd_library": device_ms(
                    lambda: torch.nn.functional.embedding(idx, table)),
                "bwd_library": device_ms(
                    lambda: emb_bwd(g, idx, n, -1, False)),
                "bwd_index_add": device_ms(
                    lambda: g.new_zeros((n, width)).index_add_(0, idx, g)),
            }
            nodes = graph_nodes(
                lambda: select.lut_gather_large_bwd_cuda(g, idx, n))
            nodes_sorted = graph_nodes(lambda: _sorted_route(g, idx, n))
            want = 1 + select.radix_schedule(n)[1]  # memset, radix passes
            if nodes != want or nodes > 5:
                raise AssertionError(
                    f"large look-up {label}: {nodes} graph nodes a call, "
                    f"{want} expected, at most 5")
            # the forward moves the rows it reads, the backward writes the
            # whole dense (n, C) table
            fb = lut_bound(lanes, touched, width, False)
            bb = lut_bound(lanes, n, width, True)
            log(f"time large look-up {label} ({kind}), N={lanes}, n={n}, "
                f"rows of {width}, {touched} rows touched: forward kernel "
                f"{fmt(t['fwd'])}, plain {fmt(t['fwd_plain'])}, F.embedding "
                f"{fmt(t['fwd_library'])}, bound {fb['bound_ms']:.6f} ms "
                f"({fb['bound_by']}); backward, the radix route "
                f"{fmt(t['bwd'])} in {nodes} graph nodes, the sorted route "
                f"(torch.sort, same segmented sum) {fmt(t['bwd_sorted'])} in "
                f"{nodes_sorted} nodes, sorted / radix "
                f"{t['bwd_sorted']['ms'] / t['bwd']['ms']:.3f}x; plain "
                f"(index_put_, indexing_backward) {fmt(t['bwd_plain'])}, "
                f"embedding_dense_backward {fmt(t['bwd_library'])}, zeros + "
                f"index_add_ {fmt(t['bwd_index_add'])}, bound "
                f"{bb['bound_ms']:.6f} ms ({bb['bound_by']}), "
                f"{100.0 * bb['bound_ms'] / t['bwd']['ms']:.3f}% of it "
                "reached")
            shapes[f"{label}, {kind}"] = {
                "fwd": dict(**_rec(t, "fwd"), **fb),
                "bwd": dict(**_rec(t, "bwd"), **bb,
                            sorted_route_ms=t["bwd_sorted"]["ms"],
                            sorted_route_ms_per_call=t["bwd_sorted"][
                                "ms_per_call"],
                            index_add_ms=t["bwd_index_add"]["ms"],
                            nodes_per_call=nodes,
                            sorted_route_nodes_per_call=nodes_sorted)}

    # the two backward kernels side by side where both apply (rows of 3):
    # where the small-table one stops paying for its tiles' passes over the
    # lanes, against the large-table one's sort
    against = {}
    for lanes, n, kind in [(65536, n, "uniform") for n in S1_S2_ROWS] + [
            (131072, 1, "one row")]:
        idx = _large_indices(kind, n, lanes, rng, device)
        g = torch.from_numpy(
            rng.normal(size=(lanes, 3)).astype(np.float32)).to(device)
        small = select.lut_gather_bwd_cuda(g, idx, n)
        large = select.lut_gather_large_bwd_cuda(g, idx, n)
        want = torch.zeros((n, 3), dtype=torch.float64,
                           device=device).index_add_(0, idx, g.double())
        scale = torch.zeros((n, 3), dtype=torch.float64,
                            device=device).index_add_(0, idx, g.double().abs())
        for d in (small, large):
            if not bool(((d.double() - want).abs()
                         <= LUT_ATOL + LUT_RTOL * scale).all()):
                raise AssertionError(f"backward kernels at n={n}: off the "
                                     "float64 sum")
        t_small = device_ms(lambda: select.lut_gather_bwd_cuda(g, idx, n))
        t_large = device_ms(
            lambda: select.lut_gather_large_bwd_cuda(g, idx, n))
        against[f"N={lanes}, n={n}, {kind}"] = dict(small_ms=t_small["ms"],
                                                     large_ms=t_large["ms"])
        log(f"time backward kernels, N={lanes}, n={n} rows of 3, {kind}: "
            f"small-table (S1's two-launch route, which takes any n) "
            f"{fmt(t_small)}, large-table (S2, the radix "
            f"route) {fmt(t_large)}, S2 / S1 "
            f"{t_large['ms'] / t_small['ms']:.3f}")

    main = shapes[f"{LARGE_SHAPES[0][0]}, uniform"]
    return {
        "lut_gather_large_bwd": dict(max_abs_err=err_b, **main["bwd"],
                                     shapes={k: v["bwd"]
                                             for k, v in shapes.items()},
                                     against_small=against),
        "lut_gather_shapes": dict(max_abs_err=err_f,
                                  shapes={k: v["fwd"]
                                          for k, v in shapes.items()}),
    }


def write_large_mesh(out_dir, seed=LARGE_SEED):
    """Phase 25's scene, written into out_dir (never the repository): a
    displaced closed torus of 512 x 1,024 quads, so 1,048,576 fan
    triangles, with per-vertex normals and uvs, made from a seed, as a .geo
    file, and a scene JSON beside it: macbeth's camera (with its medium),
    env light and session, the torus as a diffuse mesh under a transform
    that is not the identity, and macbeth's sphere, shrunk into the
    torus' hole, as a dielectric one (macbeth's files named by absolute
    path).  Returns (scene path, .geo path, the torus' objectToWorld)."""
    rng = np.random.default_rng(seed)
    n_v, n_u = LARGE_QUADS  # around the tube, around the ring
    v = 2 * np.pi * np.arange(n_v) / n_v
    u = 2 * np.pi * np.arange(n_u) / n_u
    uu, vv = np.meshgrid(u, v)  # (n_v, n_u)
    # the tube's radius displaced by waves whole around both circles
    wave = sum(a * np.sin(fu * uu + fv * vv + ph) for a, fu, fv, ph in zip(
        rng.uniform(0.02, 0.06, 6), rng.integers(1, 17, 6),
        rng.integers(1, 9, 6), rng.uniform(0, 2 * np.pi, 6)))
    big, tube = 1.5, 0.55 * (1.0 + wave)
    p = np.stack([(big + tube * np.cos(vv)) * np.cos(uu),
                  (big + tube * np.cos(vv)) * np.sin(uu),
                  tube * np.sin(vv)], axis=-1)
    # normals from central differences on the closed grid: outward
    du = np.roll(p, -1, axis=1) - np.roll(p, 1, axis=1)
    dv = np.roll(p, -1, axis=0) - np.roll(p, 1, axis=0)
    nrm = np.cross(du, dv)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = np.stack([uu / (2 * np.pi), vv / (2 * np.pi)], axis=-1)
    idx = np.arange(n_v * n_u).reshape(n_v, n_u)
    quads = np.stack([idx, np.roll(idx, -1, axis=1),
                      np.roll(np.roll(idx, -1, axis=0), -1, axis=1),
                      np.roll(idx, -1, axis=0)], axis=-1).reshape(-1)
    geo_path = os.path.join(out_dir, "torus.geo")
    with open(geo_path, "w") as f:
        f.write(f"{n_v * n_u}\n")
        for arr, form in ((np.full(n_v * n_u, 4), "%d"), (quads, "%d"),
                          (p, "%.7g"), (quads, "%d"), (nrm, "%.7g"),
                          (quads, "%d"), (uv, "%.7g")):
            f.flush()
            np.asarray(arr).astype(np.float32 if form != "%d" else np.int64
                                   ).tofile(f, sep=" ", format=form)
            f.write("\n")
    xf = np.array([[1.0, 0.0, 0.0, 0.34],  # the ring faces the camera
                   [0.0, 0.0, -1.0, 0.0],
                   [0.0, 1.0, 0.0, 0.05],
                   [0.0, 0.0, 0.0, 1.0]], np.float32)
    with open(MACBETH) as f:
        doc = json.load(f)

    def absolute(node):
        node["filePath"] = os.path.join(MACBETH_DIR,
                                        node["filePath"].replace("//", "/"))

    absolute(doc["camera"]["medium"])
    for light in doc["lights"]:
        absolute(light["Le"])
    sphere = {"filePath": "input//meshes//sphere.geo",
              "material": {"type": "glass", "rho_s": [1, 1, 1],
                           "tau": [1, 1, 1], "eta": 1.5, "roughness": 0.05},
              "transform": [0.5, 0, 0, 0.34, 0, 0.5, 0, -0.1,
                            0, 0, 0.5, 0.05, 0, 0, 0, 1]}
    absolute(sphere)
    doc["meshes"] = [{"filePath": geo_path,
                      "material": {"type": "lambert",
                                   "rho_d": [0.55, 0.45, 0.35]},
                      "transform": xf.reshape(-1).tolist()}, sphere]
    scene_path = os.path.join(out_dir, "torus.json")
    with open(scene_path, "w") as f:
        json.dump(doc, f, indent=1)
    return scene_path, geo_path, xf


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _same_bits(label, got, want):
    """Raises unless got and want have one dtype, one shape, the same bytes."""
    got, want = np.asarray(got), np.asarray(want)
    if not (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.uint8), want.view(np.uint8))):
        raise AssertionError(f"{label}: the C++ core's bits differ from the "
                             "numpy version's")


def host_cpu():
    """The host's CPU as /proc/cpuinfo gives it (its first processor's
    vendor, family, model and model name lines), the machine and the
    logical CPUs."""
    import platform

    with open("/proc/cpuinfo") as f:
        first = f.read().split("\n\n")[0]
    fields = dict(ln.split(":", 1) for ln in first.splitlines() if ":" in ln)
    keys = ("vendor_id", "cpu family", "model", "model name",
            "CPU implementer", "CPU part")
    desc = ", ".join(f"{k.strip()} {fields[k].strip()}" for k in fields
                     if k.strip() in keys)
    return f"{desc}; {platform.machine()}, {os.cpu_count()} logical CPUs"


def _large_render(scene_path, kind):
    """A graphed 1280x720 @ 1 render of the large mesh by accel `kind`
    through render_scene_file on the card: the session's first render
    captures, the next is counted (the launch counts reset just before it)
    and profiled.  The "cluster" render takes a timed untraced render
    before the counted one, whose wall the busy share divides; B1's render
    takes ~16 s, so its counted, profiled render is also its timed one
    (wall traced).  (image, record, session)."""
    import torch

    from nart_tpu_torch import cuda_build, render

    w, h, spp = LARGE_RENDER
    torch.cuda.reset_peak_memory_stats()
    (_, sess), t_sess = _timed(lambda: next(render.render_scene_file(
        scene_path, dict(image_width=w, image_height=h, spp=spp,
                         accel=kind), device=DEVICE)))
    (_, t_first) = _timed(sess.render)
    traced = kind == "bvh"
    wall = None
    if not traced:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.render()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda_build.reset_launch_counts()
    before = machine_totals(sess.machines)
    images = []
    _, busy, _, busy_ms = device_busy(f"large mesh {kind} render",
                                      lambda: images.append(sess.image()),
                                      wall)
    img = images[0]
    if traced:  # the profiled render's own wall
        wall = busy_ms / (1e3 * busy)
    launches = dict(cuda_build.launch_counts)
    after = machine_totals(sess.machines)
    ran = after["rounds_run"] - before["rounds_run"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    want = ({"bvh_hit": 2 * ran} if kind == "bvh"
            else {"closest_hit": ran, "any_hit": ran, "bvh_hit": 0})
    if (after["captures"] != 1 or any(launches[k] != n for k, n in
                                      want.items())
            or (kind == "bvh" and any(launches[k] for k in TRAVERSAL))):
        raise AssertionError(f"large mesh {kind}: launches {launches}, "
                             f"{ran} rounds run, {after}")
    rec = {"session_s": t_sess, "first_render_s": t_first, "wall_s": wall,
           "wall_traced": traced, "device_ms": busy_ms, "busy": busy,
           "rounds": sess.stats["rounds"], "rounds_run": ran,
           "rays": sess.stats["rays"], "peak_mib": peak, "launches": launches}
    log(f"(d) large mesh, accel {kind}: session (load + accel build) "
        f"{t_sess:.3f} s, first render (captures) {t_first:.3f} s; timed "
        f"render {wall:.4f} s ({'traced' if traced else 'untraced'}), "
        f"{busy_ms:.3f} device ms ({100 * busy:.2f}% busy), "
        f"{rec['rounds']} rounds ({ran} run), {rec['rays']} rays, peak "
        f"{peak:.1f} MiB, launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return img.cpu().numpy(), rec, sess


def large_mesh():
    """Phase 25: the 1,048,576-triangle mesh from file to film on the card
    (write_large_mesh): (a) the .geo loaded by the C++ core and by numpy,
    the same bits on v, n and uv; (b) the LBVH of the scene's soup built
    by the core and by numpy, the same bits on node_lo, node_hi, order and
    tri_v;
    (c) the cluster build, under the large-mesh policy; (d) renders at
    1280x720 @ 1 spp, graphed, through render_scene_file on the card with
    accel "cluster" (K1/K2) and "bvh" (B1): wall, device ms, rounds, peak
    MiB, launches; (e) K1's and B1's hits on the 921,600 pixel-centre
    camera rays (tri on >= 99.99%, t/u/v rtol 1e-4 / atol 1e-5) and the two
    films by macbeth's golden criteria; (f) the CLI's main on the scene
    with --timing.  Host times name the host's CPU.  Returns every
    kernel's launches in the counted renders (B1's in the bvh one, the
    others' in the cluster one)."""
    import contextlib
    import io

    import torch

    from nart_tpu_torch import bvh, camera, cli, exr, geo, native
    from nart_tpu_torch import cluster_accel as ca
    from nart_tpu_torch import scene as scene_mod

    log(f"host CPU: {host_cpu()}")
    with tempfile.TemporaryDirectory() as tmp:
        (scene_path, geo_path, xf), t_gen = _timed(
            lambda: write_large_mesh(tmp))
        log(f"large mesh: {LARGE_QUADS[0]} x {LARGE_QUADS[1]} quads written "
            f"in {t_gen:.3f} s, {os.path.getsize(geo_path)} bytes")
        # (a)
        cpp, t_cpp = _timed(lambda: geo.load_geo(geo_path, xf))
        plain, t_np = _timed(lambda: geo.load_geo_plain(geo_path, xf))
        if cpp.v.shape != (2 * LARGE_QUADS[0] * LARGE_QUADS[1], 3, 3):
            raise AssertionError(f"(a) {cpp.v.shape[0]} triangles")
        for name in ("v", "n", "uv"):
            _same_bits(f"(a) .geo {name}", getattr(cpp, name),
                       getattr(plain, name))
        log(f"(a) .geo load, {cpp.v.shape[0]} triangles: C++ core "
            f"{t_cpp:.3f} s, numpy {t_np:.3f} s ({t_np / t_cpp:.2f}x); v, n "
            f"and uv the same bits")
        del cpp, plain
        # (b)
        scn, t_scene = _timed(lambda: scene_mod.load_scene(scene_path))
        tri = scn.tri_v.numpy()
        lb_cpp, t_lcpp = _timed(lambda: native.lbvh_build(tri, 8))
        lb_np, t_lnp = _timed(lambda: bvh.build_bvh_arrays(tri, 8))
        for k in ("node_lo", "node_hi", "order", "tri_v"):
            _same_bits(f"(b) LBVH {k}", lb_cpp[k], lb_np[k])
        log(f"(b) LBVH of the scene's {len(tri)} triangles (load_scene "
            f"by the C++ core {t_scene:.3f} s): C++ core {t_lcpp:.3f} s, "
            f"numpy {t_lnp:.3f} s ({t_lnp / t_lcpp:.2f}x); {lb_cpp['n_leaves']}"
            f" leaves of 8, depth {lb_cpp['depth']}; node_lo, node_hi, "
            f"order and tri_v the same bits")
        del lb_cpp, lb_np
        # (c)
        acc, t_cl = _timed(lambda: ca.build_clusters(tri))
        if not (len(tri) >= ca.LARGE_MESH and acc.csize == ca.CLUSTER_LARGE
                and acc.sc_size == -(-(-(-len(tri) // acc.csize))
                                     // ca.SUPER_TARGET_LARGE)):
            raise AssertionError(f"(c) not the large-mesh policy: csize "
                                 f"{acc.csize}, {acc.n_sc} superclusters of "
                                 f"{acc.sc_size}")
        log(f"(c) cluster build (numpy): {t_cl:.3f} s; the large-mesh policy "
            f"(>= {ca.LARGE_MESH} triangles: median split, clusters of "
            f"{acc.csize}, target {ca.SUPER_TARGET_LARGE} superclusters): "
            f"{acc.n_clusters} clusters, {acc.n_sc} superclusters of "
            f"{acc.sc_size}")
        del acc
        # (d)
        imgs, recs, sess = {}, {}, {}
        for kind in ("cluster", "bvh"):
            imgs[kind], recs[kind], sess[kind] = _large_render(scene_path,
                                                                kind)
        if not all(np.isfinite(i).all() and i[..., :3].mean() > 0
                   for i in imgs.values()):
            raise AssertionError("(d) a large-mesh image is not finite or "
                                 "is black")
        log(f"(d) bvh / cluster: wall {recs['bvh']['wall_s'] / recs['cluster']['wall_s']:.3f}x, "
            f"device {recs['bvh']['device_ms'] / recs['cluster']['device_ms']:.3f}x")
        # (e)
        w, h, _ = LARGE_RENDER
        pix = torch.arange(w * h)
        n = pix.shape[0]
        o, d = camera.cast_rays(scn.cam_to_world, scn.fov, w, h, pix % w,
                                pix // w, torch.full((n, 2), 0.5))
        rays = (o.to(DEVICE), d.to(DEVICE), torch.zeros(n, device=DEVICE),
                torch.full((n,), float("inf"), device=DEVICE))
        hk = ca.intersect_clusters(*rays, sess["cluster"].accel)
        hb = bvh.intersect_bvh(*rays, sess["bvh"].accel)
        torch.cuda.synchronize()
        frac, err = compare_closest("(e) large mesh, K1 against B1", hk, hb)
        hit = float((hk.tri >= 0).float().mean())
        log(f"(e) camera rays ({n}, {100 * hit:.2f}% hit): K1 and B1 agree "
            f"on tri for {frac:.6f}, t/u/v max abs err {err:.3g}")
        block_compare(imgs["bvh"], imgs["cluster"], 0.03, 0.12, 0.95,
                      label="(e) large mesh, bvh film against cluster film")
        del sess, hk, hb, rays
        # (f) `python -m nart_tpu_torch.cli` in this process (its main)
        out = os.path.join(tmp, "cli")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, t_cli = _timed(lambda: cli.main(
                [scene_path, out, "-w", str(w), "-h", str(h), "-s",
                 str(LARGE_RENDER[2]), "--timing"]))
        for line in err.getvalue().splitlines():
            log(f"    cli {line}")
        if rc != 0:
            raise AssertionError(f"(f) the CLI returned {rc}")
        img = exr.read(out + ".exr")
        if not (np.isfinite(img).all() and img[..., :3].mean() > 0):
            raise AssertionError("(f) the CLI's EXR is not finite or black")
        log(f"(f) CLI, its main: {t_cli:.3f} s; EXR {img.shape}")
    torch.cuda.empty_cache()
    counts = dict(recs["cluster"]["launches"])
    counts["bvh_hit"] = recs["bvh"]["launches"]["bvh_hit"]
    return counts


def scaling_phase(ranks=(4, 8)):
    """Phase 26: nart_tpu_torch.scaling_evidence at its defaults (the JAX
    tool's simple_glass at 256x256 @ 64 spp), with 4 and then 8 ranks run
    one after another on the card, through its command line (--out into a
    temporary directory): per-rank rounds, drain-tail rounds, rays and
    device ms, the balance and the drain fraction; the ranks' rays must
    sum to a one-process render's, and each rank's drain be at most its
    rounds."""
    from nart_tpu_torch import scaling_evidence

    sess = scaling_evidence.session(device=DEVICE)
    sess.render()
    one = sess.stats["rays"]
    del sess
    with tempfile.TemporaryDirectory() as tmp:
        for n in ranks:
            path = os.path.join(tmp, f"ranks{n}.json")
            _, secs = _timed(lambda: scaling_evidence.main(
                ["--ranks", str(n), "--out", path]))
            with open(path) as f:
                rec = json.load(f)
            log(f"scaling evidence, {n} ranks, {rec['config']} ({secs:.2f} "
                f"s, {rec['device']}): rounds {rec['rounds_per_rank']}, "
                f"drain {rec['drain_tail_rounds']}, device ms "
                f"{rec['device_ms_per_rank']}, rays "
                f"{rec['rays_per_rank']}; balance "
                f"{rec['round_balance_efficiency']:.4f}, drain fraction "
                f"{rec['drain_tail_fraction']:.4f}; all-reduce film "
                f"{rec['all_reduce_film_bytes']} B (the JAX tool's psum "
                f"{rec['psum_film_bytes_per_step']} B), gradient "
                f"{rec['psum_grad_bytes_per_step']} B")
            if sum(rec["rays_per_rank"]) != one:
                raise AssertionError(f"{n} ranks: rays sum to "
                                     f"{sum(rec['rays_per_rank'])}, the "
                                     f"one-process render's {one}")
            if any(dr > r for dr, r in zip(rec["drain_tail_rounds"],
                                           rec["rounds_per_rank"])):
                raise AssertionError(f"{n} ranks: drain above rounds")
    log(f"scaling evidence: the ranks' rays sum to the one-process render's "
        f"{one}")


def _bits_equal(label, names, got, want, whose="the plain version's"):
    """Raises unless every output has want's bits (whose: the plain
    version's, or another kernel's) on every lane; returns the largest
    absolute difference (0)."""
    import torch

    for name, a, b in zip(names, got, want):
        a, b = a.contiguous(), b.contiguous()
        same = (a.view(torch.int32) == b.view(torch.int32)
                if a.dtype == torch.float32 else a == b)
        if not bool(same.all()):
            bad = (~same).reshape(a.shape[0], -1).any(-1).nonzero()[:4, 0]
            raise AssertionError(
                f"{label}: {name} differs from {whose} bits on "
                f"{int((~same).reshape(a.shape[0], -1).any(-1).sum())} lanes,"
                f" e.g. lanes {bad.tolist()}: {a[bad].tolist()} vs "
                f"{b[bad].tolist()}")
    return 0.0


def _f64(x):
    import torch

    from nart_tpu_torch import bxdf

    if isinstance(x, bxdf.BsdfDesc):
        return bxdf.BsdfDesc(*[_f64(t) for t in x])
    return x.double() if x.dtype == torch.float32 else x


def _x3_against_float64(label, got, f_fwd, ref, f_ref, plain32):
    """X3's per-lane gradients (got, bsdf_ops.DIFF's order) against the
    float64 VJP of the plain version (ref), which must be finite on every
    lane: within BSDF_RTOL / BSDF_ATOL on every lane but those whose
    float64 forward (f_ref) takes another branch than the float32 forward
    (f_fwd):
    f beyond rtol 1e-3 / atol 1e-5 of it, or zero where it is not (a TIR
    or a grazing cut at its boundary).  The plain float32 VJP (plain32:
    the CPU route's, and the parent's on the card) is measured against the
    same float64 VJP, not held to it.  Returns (the largest |X3 - float64|
    / (atol + rtol |float64|) of the lanes within tolerance, their count,
    the lanes outside it on another branch, the lanes with a non-finite
    float64 VJP, the lanes where plain32 is outside the tolerance, its
    largest ratio there, X3's largest absolute error)."""
    import torch

    from nart_tpu_torch import bsdf_ops

    n = f_fwd.shape[0]
    f32 = f_fwd.double()
    branch = (~torch.isclose(f_ref, f32, rtol=1e-3, atol=1e-5)
              | ((f_ref == 0.0) != (f32 == 0.0))).any(-1)
    finite = torch.ones(n, dtype=torch.bool, device=f_fwd.device)
    ratio = torch.zeros(n, dtype=torch.float64, device=f_fwd.device)
    ratio32, err = torch.zeros_like(ratio), torch.zeros_like(ratio)
    for name, a, b, c in zip(bsdf_ops.DIFF, got, ref, plain32):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: X3's {name} is not finite")
        a, b = a.double().reshape(n, -1), b.reshape(n, -1)
        scale = BSDF_ATOL + BSDF_RTOL * b.abs()
        finite &= torch.isfinite(b).all(-1)
        ratio = torch.maximum(ratio, ((a - b).abs() / scale).amax(-1))
        err = torch.maximum(err, (a - b).abs().amax(-1))
        ratio32 = torch.maximum(ratio32, ((c.double().reshape(n, -1) - b)
                                          .abs() / scale).amax(-1))
    ok = ratio <= 1.0
    ratio32 = torch.nan_to_num(ratio32, nan=math.inf)  # a NaN is outside
    if not bool(finite.all()):
        i = (~finite).nonzero()[:3, 0]
        raise AssertionError(
            f"{label}: the float64 VJP of the plain version is not finite on "
            f"{int((~finite).sum())} lanes (the plain VJP's fault), e.g. "
            f"{i.tolist()}: {[r[i].tolist() for r in ref]}")
    bad = ~ok & ~branch
    if bool(bad.any()):
        i = bad.nonzero()[:3, 0]
        raise AssertionError(
            f"{label}: X3 outside rtol {BSDF_RTOL} / atol {BSDF_ATOL} of "
            f"the float64 VJP on {int(bad.sum())} lanes of the float32 "
            f"branches, e.g. {i.tolist()}: "
            f"{[g[i].tolist() for g in got]} vs "
            f"{[r[i].tolist() for r in ref]}")
    use = ok & finite
    out32 = finite & (ratio32 > 1.0)
    return (float(ratio[use].max()) if bool(use.any()) else 0.0,
            int(use.sum()), int((~ok & finite & branch).sum()),
            int((~finite).sum()), int(out32.sum()),
            float(ratio32[finite].max()) if bool(finite.any()) else 0.0,
            float(err[use].max()) if bool(use.any()) else 0.0)


def _bsdf_sample_set(label, s, rng):
    """X1 and X3 ("sample") on one sample call's inputs s, beside their
    first designs (nart_bsdf_sample_ref, nart_bsdf_f_bwd_ref): X1's outputs
    the plain version's and the reference's bits on every lane; returns
    (X1's max abs error, X3's readings (_x3_against_float64), X3's share of
    the reference X3's bits, the reference X3's readings)."""
    import torch

    from nart_tpu_torch import bsdf_ops
    from nart_tpu_torch.testing import bit_share

    desc, wo, eo = s["desc"], s["wo"], s["eta_outer"]
    args = (s["u1"], s["u2"], s["use_prime"], eo, s["prev_flags"])
    got = bsdf_ops.sample_cuda(desc, wo, *args)
    want = bsdf_ops.sample_plain(desc, wo, *args)
    names = ("f", "wi", "pdf", "flags", "alpha_i", "eta_sampled", "bits")
    err1 = _bits_equal(f"{label}: X1", names, got[:6], want)
    _bits_equal(f"{label}: X1", names, got,
                bsdf_ops.sample_ref_cuda(desc, wo, *args),
                "its first design's (nart_bsdf_sample_ref)")
    n = wo.shape[0]
    cots = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        DEVICE) for shape in ((n, 3), (n,), (n,))]
    bwd = (desc, wo, got[1], s["use_prime"], eo, *cots)
    kw = dict(u2=s["u2"], prev_flags=s["prev_flags"], bits=got[6])
    x3 = bsdf_ops.f_bwd_cuda("sample", *bwd, **kw)
    x3_ref = bsdf_ops.f_bwd_ref_cuda("sample", *bwd, **kw)
    at = (_f64(desc), _f64(wo), _f64(got[1]), _f64(s["u1"]), _f64(s["u2"]),
          s["use_prime"], _f64(eo), s["prev_flags"], got[3])
    ref = bsdf_ops.sample_at_bwd_plain(*at, *[_f64(c) for c in cots])
    f_ref = bsdf_ops.sample_at_plain(*at)[0]
    plain32 = bsdf_ops.sample_bwd_plain(desc, wo, *args, *cots)
    err3 = _x3_against_float64(f"{label}: X3 sample", x3, got[0], ref, f_ref,
                               plain32)
    err_ref = _x3_against_float64(f"{label}: X3's first design, sample",
                                  x3_ref, got[0], ref, f_ref, plain32)
    return err1, err3, bit_share(x3, x3_ref), err_ref


def _bsdf_eval_set(label, s, rng):
    """X2 and X3 ("eval") on one eval call's inputs s, X3 beside its first
    design: _bsdf_sample_set's readings."""
    import torch

    from nart_tpu_torch import bsdf_ops
    from nart_tpu_torch.testing import bit_share

    desc, wo, wi, up, eo = (s["desc"], s["wo"], s["wi"], s["use_prime"],
                            s["eta_outer"])
    got = bsdf_ops.eval_cuda(desc, wo, wi, up, eo)
    want = bsdf_ops.eval_plain(desc, wo, wi, up, eo)
    err2 = _bits_equal(f"{label}: X2", ("f", "pdf"), got, want)
    g_f = torch.from_numpy(rng.normal(size=(wo.shape[0], 3)).astype(
        np.float32)).to(DEVICE)
    x3 = bsdf_ops.f_bwd_cuda("eval", desc, wo, wi, up, eo, g_f)
    x3_ref = bsdf_ops.f_bwd_ref_cuda("eval", desc, wo, wi, up, eo, g_f)
    at = (_f64(desc), _f64(wo), _f64(wi), up, _f64(eo))
    ref = bsdf_ops.eval_bwd_plain(*at, _f64(g_f))
    f_ref = bsdf_ops.eval_plain(*at)[0]
    plain32 = bsdf_ops.eval_bwd_plain(desc, wo, wi, up, eo, g_f)
    err3 = _x3_against_float64(f"{label}: X3 eval", x3, got[0], ref, f_ref,
                               plain32)
    err_ref = _x3_against_float64(f"{label}: X3's first design, eval",
                                  x3_ref, got[0], ref, f_ref, plain32)
    return err2, err3, bit_share(x3, x3_ref), err_ref


def bsdf_bytes_dense(kernel, n):
    """The bytes of every input tensor read once and every output written
    once at n lanes (more than a launch must move: a lane reads only what
    its lobes need, bsdf_bytes)."""
    i64, f32, row3 = 8, 4, 12
    desc = 2 * i64 + i64 + 3 * row3 + 3 * f32  # n_lobes, lobe, rho, scalars
    if kernel in ("bsdf_sample", "bsdf_sample_eval"):
        # + wo, u1, u2, use_prime, eta_outer, prev
        ins = desc + row3 + f32 + 2 * f32 + 1 + f32 + i64
        outs = row3 + row3 + f32 + i64 + f32 + f32 + 4  # ..., bits
        if kernel == "bsdf_sample_eval":  # + wi_b in; f_b, pdf_b out
            ins, outs = ins + row3, outs + row3 + f32
    elif kernel == "bsdf_eval":  # + wo, wi, use_prime, eta_outer
        ins = desc + 2 * row3 + 1 + f32
        outs = row3 + f32
    else:  # "sample": + wo, wi, u2, use_prime, eta_outer, prev, bits,
        # g_f, g_alpha_i, g_eta_sampled
        ins = desc + 2 * row3 + 2 * f32 + 1 + f32 + i64 + 4 + row3 + 2 * f32
        outs = 3 * row3 + 3 * f32 + row3 + f32  # the DIFF rows
    return n * (ins + outs)


def bsdf_bytes(kernel, s, x1):
    """The bytes a launch must move on the lanes of call s (x1: X1's
    outputs on the sample call): each output written once, and of the
    inputs what each lane's lobe codes need (LOBE_READS: the rows and
    scalars of the lobes it samples or evaluates, one alpha as use_prime
    picks it), read once.  X1: n_lobes, the lobe codes it reads, u1, the
    u2 and prev_flags its picked lobe reads, and the rows of the picked
    lobe and of the other where it is mixed in (X1's flags not
    SPECULAR).  X2: n_lobes, the codes, wi where a lobe is not specular,
    the rows of its non-specular lobes (a specular one's f and pdf are 0).
    The sample+eval launch (s: the sample call's inputs and wi_b): X1's,
    and X2's at wi_b, each row and code read once (a row either reads).
    X3 ("sample"): X1's lobe bits, the cotangents its lobe reaches, wi,
    u2 and prev_flags where its lobe reads them, and the rows of the
    picked lobe and of the other where X1 added it (a Lambert lobe's
    gradient reads no row: rho_d / pi)."""
    import torch

    from nart_tpu_torch import bxdf

    d = s["desc"]
    dev = d.n_lobes.device
    two = d.n_lobes >= 2
    l0, l1 = d.lobe[:, 0], d.lobe[:, 1]
    table = torch.tensor([LOBE_READS[c] for c in range(5)], dtype=torch.bool,
                         device=dev)
    widths = torch.tensor(LOBE_READ_BYTES, dtype=torch.int64, device=dev)

    def rows(code, used):
        return table[code.clamp(0, 4)] & used[:, None]

    def evaluated(code):  # a lobe whose f and pdf are not 0 by its code
        return (code >= bxdf.L_LAMBERT) & (code <= bxdf.L_DIELECTRIC)

    def among(code, *codes):
        return sum((code == c).long() for c in codes)

    every = torch.ones_like(two)
    e0, e1 = evaluated(l0), two & evaluated(l1)
    if kernel in ("bsdf_sample", "bsdf_sample_eval"):
        idx = (s["u1"] * d.n_lobes.float()).long().clamp(0, 1)
        code = torch.where(idx == 0, l0, l1)
        other = torch.where(idx == 1, l0, l1)
        mix = (((x1[3] & bxdf.SPECULAR) == 0) & two
               & (other != bxdf.L_SPECULAR) & (other != bxdf.L_SPECDIEL))
        need = rows(code, every) | rows(other, mix)
        lane = (8 + 8 + 8 * two.long() + 4  # n_lobes, codes, u1
                + 8 * among(code, bxdf.L_LAMBERT, bxdf.L_TS,
                            bxdf.L_DIELECTRIC)
                + 4 * among(code, bxdf.L_SPECDIEL)  # u2
                + 8 * among(code, bxdf.L_DIELECTRIC, bxdf.L_SPECDIEL)
                + 48)  # f, wi, pdf, flags, alpha_i, eta_sampled, bits
        if kernel == "bsdf_sample_eval":  # + wi_b, f_b and pdf_b
            need = need | rows(l0, e0) | rows(l1, e1)
            lane = lane + 12 * (e0 | e1).long() + 16
    elif kernel == "bsdf_eval":
        need = rows(l0, e0) | rows(l1, e1)
        lane = 8 + 8 + 8 * two.long() + 12 * (e0 | e1).long() + 16
    else:
        bits = x1[6].long()
        code, other = (bits & 7) - 1, ((bits >> 3) & 7) - 1
        add = (bits & 64) != 0
        need = (rows(code, code != bxdf.L_LAMBERT)
                | rows(other, add & (other != bxdf.L_LAMBERT)))
        wi = torch.where(add | (among(code, bxdf.L_TS, bxdf.L_DIELECTRIC)
                                > 0), 12, 4 * among(code, bxdf.L_SPECULAR))
        lane = (4 + 12 + wi  # bits, g_f, wi
                + 4 * among(code, bxdf.L_TS, bxdf.L_DIELECTRIC)  # g_alpha_i
                + 4 * (code != bxdf.L_LAMBERT).long()  # g_eta_sampled
                + (4 + 8) * among(code, bxdf.L_SPECDIEL)  # u2, prev_flags
                + 64)  # the DIFF rows
    return int((lane + (need.long() * widths).sum(-1)).sum())


def bsdf_ops_ms(kernel, desc):
    """The operations side of a BSDF kernel's bound on these lanes: each
    lane's BSDF_OPS by its (lobe 0, lobe 1) (the sample+eval launch's:
    X1's and X2's), the float32 ones over
    PEAK_FLOPS and the float64 ones over PEAK_FLOPS64 (separate pipes: the
    larger).  Returns (ms, float32 ops, float64 ops)."""
    import torch

    pairs, counts = torch.unique(desc.lobe, dim=0, return_counts=True)
    parts = (("bsdf_sample", "bsdf_eval") if kernel == "bsdf_sample_eval"
             else (kernel,))  # the sample+eval launch: X1's and X2's
    f32 = f64 = 0.0
    for (l0, l1), c in zip(pairs.tolist(), counts.tolist()):
        for part in parts:
            a, b = BSDF_OPS[(l0, l1)][part]
            f32, f64 = f32 + a * c, f64 + b * c
    return 1e3 * max(f32 / PEAK_FLOPS, f64 / PEAK_FLOPS64), f32, f64


def _bsdf_fused_set(label, s, wi_b):
    """The sample+eval launch (X2's redesign, nart_bsdf_sample_eval) on a
    sample call's inputs s and the eval direction wi_b: its nine outputs
    the bits of X1 (nart_bsdf_sample) followed by X2's first design
    (nart_bsdf_eval) at wi_b, and its eight float outputs the plain
    versions' (bsdf_ops.sample_eval_plain), on every lane; returns the
    largest absolute difference (0)."""
    from nart_tpu_torch import bsdf_ops

    desc, wo, up, eo = s["desc"], s["wo"], s["use_prime"], s["eta_outer"]
    args = (s["u1"], s["u2"], up, eo, s["prev_flags"])
    got = bsdf_ops.sample_eval_cuda(desc, wo, *args, wi_b)
    names = ("f", "wi", "pdf", "flags", "alpha_i", "eta_sampled", "bits",
             "f_b", "pdf_b")
    _bits_equal(f"{label}: sample+eval", names, got,
                (*bsdf_ops.sample_cuda(desc, wo, *args),
                 *bsdf_ops.eval_cuda(desc, wo, wi_b, up, eo)),
                "X1's and X2's first design's (two launches)")
    return _bits_equal(f"{label}: sample+eval", names[:6] + names[7:],
                       got[:6] + got[7:],
                       bsdf_ops.sample_eval_plain(desc, wo, *args, wi_b))


def bsdf_checks():
    """Phase 27: X1-X3 and the sample+eval launch (X2's redesign;
    csrc/bsdf.cu) against their plain versions on the card: 65,536 lanes
    of each LOBES kind and the two BSDF calls of a mid-trace round of
    macbeth 1280x720 and simple_glass 512x512 (testing.mid_trace_bsdf:
    strategy A's sample with strategy B's eval, the scatter's sample).
    X1's, X2's first design's and the sample+eval launch's outputs the
    plain version's bits on every lane, the sample+eval launch's also X1's
    and X2's (at the LOBES sets' eval directions and at the rounds' strategy
    B directions); X3 within BSDF_RTOL / BSDF_ATOL of the float64 VJP of
    the plain version, wi held fixed (bsdf_ops.sample_at_plain,
    bxdf.bsdf_f), which must be finite on every lane, on every lane whose
    float64 forward takes the float32 forward's branches (the others
    counted).  X1's outputs are also the bits of its first design
    (nart_bsdf_sample_ref) on every lane, and X3 is read beside its first
    design (nart_bsdf_f_bwd_ref: the share of its bits, and its own
    distance from the float64 VJP).  Then, at macbeth's mid-trace calls:
    each kernel's and plain version's device ms (the plain VJP's over
    eager calls: stream_ms), ms per call, and the bound (bytes over 3.35
    TB/s; no PyTorch call computes a BSDF: library none); X1 and X3
    against their first designs and the sample+eval launch against X1
    then X2 (the two launches it replaced), in turns (reference, new, new,
    reference), device ms each, the last also on the round's lanes four
    times over (262,144).  Returns the kernels' records."""
    import torch

    from nart_tpu_torch import (bench, bsdf_ops, cuda_build, render, scene,
                                testing)

    rng = np.random.default_rng(27)
    worst = 0.0  # X3's largest error over its tolerance
    errs = 0.0  # and absolute
    cuda_build.reset_launch_counts()

    def x3_log(r, share, r_ref):
        ratio, used, br, nf, out32, worst32, _ = r
        return (f"X3 within rtol {BSDF_RTOL} / atol {BSDF_ATOL} of the "
                f"float64 VJP on {used} lanes (at most {ratio:.3g} of the "
                f"tolerance); outside it on another float64 branch {br}; a "
                f"non-finite float64 VJP on {nf}; the first design's X3 at "
                f"most {r_ref[0]:.3g} of the tolerance, {100 * share:.2f}% "
                f"of its values X3's bits; the plain float32 VJP outside "
                f"the tolerance on {out32} lanes (up to {worst32:.3g} times "
                f"it)")

    for i, kind in enumerate(testing.BSDF_LOBES):
        s = testing.bsdf_lane_set(kind, BSDF_LANES, 2700 + i, DEVICE)
        for mode, (_, r, share, r_ref) in (
                ("sample", _bsdf_sample_set(kind, s, rng)),
                ("eval", _bsdf_eval_set(kind, s, rng))):
            worst, errs = max(worst, r[0]), max(errs, r[6])
            also = " and the first design's" if mode == "sample" else ""
            log(f"    {kind} ({BSDF_LANES} lanes), {mode}: the plain "
                f"version's bits{also} on every lane; "
                f"{x3_log(r, share, r_ref)}")
        _bsdf_fused_set(kind, s, s["wi"])
        log(f"    {kind} ({BSDF_LANES} lanes), sample+eval: X1's and X2's "
            "bits and the plain version's on every lane")
    _, glass = bench.bench_scene()
    macbeth = scene.load_scene(MACBETH, asset_root=MACBETH_DIR)
    p_mac = render.load_sessions(MACBETH, {"spp": 1})[0]
    p_glass = render.RenderParams(image_width=512, image_height=512, spp=1,
                                  bounces=10, filter_width=2.0,
                                  roughening_factor=0.2)
    mid = {}
    for label, sc, p in (("macbeth 1280x720", macbeth, p_mac),
                         ("simple_glass 512x512", glass, p_glass)):
        r, deep, calls = testing.mid_trace_bsdf(
            lambda: render.RenderSession(sc, p, DEVICE, per_round=True))
        fused = calls["sample A + eval B"]
        sample_a, eval_b = testing.split_sample_eval(fused)
        mid[label] = (fused, sample_a, eval_b)
        for name, s in (("sample A", sample_a), ("eval B", eval_b),
                        ("scatter", calls["scatter"])):
            at = f"{label}, round {r}, {name}"
            _, x3r, share, r_ref = (_bsdf_eval_set if name == "eval B"
                                    else _bsdf_sample_set)(at, s, rng)
            worst, errs = max(worst, x3r[0]), max(errs, x3r[6])
            codes = torch.bincount(s["desc"].lobe[:, 0] + 1, minlength=6)
            also = "" if name == "eval B" else " and the first design's"
            log(f"    {at} ({s['wo'].shape[0]} lanes, {deep} live past "
                f"their first bounce, lobe 0 codes -1..4: "
                f"{codes.tolist()}): the plain version's bits{also} on "
                f"every lane; {x3_log(x3r, share, r_ref)}")
        _bsdf_fused_set(f"{label}, round {r}", sample_a, fused["wi_b"])
        log(f"    {label}, round {r}, sample A + eval B in one launch: X1's "
            "and X2's bits and the plain version's on every lane")
    if any(cuda_build.launch_counts[k] <= 0 for k in BSDF + BSDF_REF):
        raise AssertionError(f"phase 27 launches {cuda_build.launch_counts}")

    # times and bounds at macbeth's mid-trace calls (65,536 lanes)
    fused, sa, eb = mid["macbeth 1280x720"]
    n = sa["wo"].shape[0]
    s_args = (sa["desc"], sa["wo"], sa["u1"], sa["u2"], sa["use_prime"],
              sa["eta_outer"], sa["prev_flags"])
    e_args = (eb["desc"], eb["wo"], eb["wi"], eb["use_prime"],
              eb["eta_outer"])
    se_args = (*s_args, fused["wi_b"])
    x1 = bsdf_ops.sample_cuda(*s_args)
    cots = [torch.ones(n, 3, device=DEVICE), torch.ones(n, device=DEVICE),
            torch.ones(n, device=DEVICE)]
    bwd_kw = dict(u2=sa["u2"], prev_flags=sa["prev_flags"], bits=x1[6])
    fns = {
        "bsdf_sample": (lambda: bsdf_ops.sample_cuda(*s_args),
                        lambda: bsdf_ops.sample_plain(*s_args), device_ms),
        "bsdf_sample_eval": (
            lambda: bsdf_ops.sample_eval_cuda(*se_args),
            lambda: bsdf_ops.sample_eval_plain(*se_args), device_ms),
        "bsdf_f_bwd": (
            lambda: bsdf_ops.f_bwd_cuda(
                "sample", sa["desc"], sa["wo"], x1[1], sa["use_prime"],
                sa["eta_outer"], *cots, **bwd_kw),
            lambda: bsdf_ops.sample_bwd_plain(*s_args, *cots), stream_ms),
    }
    sets = {"bsdf_sample": sa, "bsdf_sample_eval": fused, "bsdf_f_bwd": sa}
    records = {}
    for k, (kern, plain, plain_timer) in fns.items():
        t = kernel_ms(kern, 20)
        tp = plain_timer(plain, launches=3)
        nbytes = bsdf_bytes(k, sets[k], x1)
        dense = bsdf_bytes_dense(k, n)
        bytes_ms = 1e3 * nbytes / PEAK_BYTES
        ops_ms, f32, f64 = bsdf_ops_ms(k, sets[k]["desc"])
        bound = max(bytes_ms, ops_ms)
        side = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"    {k} at macbeth's mid-trace call ({n} lanes): {fmt(t)}; "
            f"plain version {fmt(tp)} ({tp['method']}); library none (no "
            f"PyTorch call computes a BSDF); bound {bound:.6f} ms ({side}; "
            f"bytes {nbytes}: {bytes_ms:.6f} ms (every input tensor once: "
            f"{dense} B, {1e3 * dense / PEAK_BYTES:.6f} ms, "
            f"{100e3 * dense / PEAK_BYTES / t['ms']:.2f}% reached), "
            f"operations {f32:.0f} "
            f"float32 and {f64:.0f} float64: {ops_ms:.6f} ms), "
            f"{100 * bound / t['ms']:.2f}% reached")
        records[k] = dict(
            ms=t["ms"], ms_min=t["min"], ms_max=t["max"],
            ms_per_call=t["ms_per_call"], plain_ms=tp["ms"],
            plain_method=tp["method"], library_ms=None, bound_ms=bound,
            bound_by=side, bytes=nbytes, bytes_dense=dense, ops_f32=f32,
            ops_f64=f64, lanes=n,
            max_abs_err=errs if k == "bsdf_f_bwd" else 0.0,
            x3_tolerance_ratio=worst if k == "bsdf_f_bwd" else None,
            shape="macbeth 1280x720, mid-trace, " + (
                "strategy A's sample and strategy B's eval"
                if k == "bsdf_sample_eval" else "strategy A"))
    # X2's first design alone at strategy B's inputs (eval_f_pdf's kernel)
    t2 = kernel_ms(lambda: bsdf_ops.eval_cuda(*e_args), 20)
    log(f"    bsdf_eval (X2's first design) at macbeth's mid-trace call "
        f"({n} lanes): {fmt(t2)}")
    records["bsdf_sample_eval"]["first_design_ms"] = t2["ms"]

    # X1 and X3 against their first designs, the sample+eval launch against
    # X1 then X2 (65,536 lanes, and the same lanes four times over), in
    # turns
    x3_args = ("sample", sa["desc"], sa["wo"], x1[1], sa["use_prime"],
               sa["eta_outer"], *cots)
    big = testing.tiled(fused, 4)
    big_s = (big["desc"], big["wo"], big["u1"], big["u2"], big["use_prime"],
             big["eta_outer"], big["prev_flags"])

    def two_launches(a, wi_b):
        return (*bsdf_ops.sample_cuda(*a),
                *bsdf_ops.eval_cuda(a[0], a[1], wi_b, a[4], a[5]))

    pairs = {"bsdf_sample": (lambda: bsdf_ops.sample_ref_cuda(*s_args),
                             lambda: bsdf_ops.sample_cuda(*s_args), n),
             "bsdf_f_bwd": (lambda: bsdf_ops.f_bwd_ref_cuda(*x3_args,
                                                            **bwd_kw),
                            lambda: bsdf_ops.f_bwd_cuda(*x3_args, **bwd_kw),
                            n),
             "bsdf_sample_eval": (
                 lambda: two_launches(s_args, fused["wi_b"]),
                 lambda: bsdf_ops.sample_eval_cuda(*se_args), n),
             "bsdf_sample_eval x4": (
                 lambda: two_launches(big_s, big["wi_b"]),
                 lambda: bsdf_ops.sample_eval_cuda(*big_s, big["wi_b"]),
                 4 * n)}
    for k, (ref_fn, new_fn, lanes) in pairs.items():
        per_call = call_ms(ref_fn, 5)
        ms = {"reference": [], "new": []}
        for turn in ("reference", "new", "new", "reference"):
            fn = ref_fn if turn == "reference" else new_fn
            ms[turn].append(device_ms(fn, launches_for(per_call))["ms"])
        ref_ms = statistics.mean(ms["reference"])
        what = (" (reference: X1 then X2's first design, two launches; "
                "new: the sample+eval launch)" if "eval" in k else "")
        log(f"    turns {k}, macbeth's mid-trace call ({lanes} lanes)"
            f"{what}: reference {ms['reference'][0]:.4f}, new "
            f"{ms['new'][0]:.4f}, new {ms['new'][1]:.4f}, reference "
            f"{ms['reference'][1]:.4f} ms; reference / new "
            f"{ref_ms / statistics.mean(ms['new']):.3f}x")
        if k == "bsdf_sample_eval x4":
            dense = bsdf_bytes_dense("bsdf_sample_eval", lanes)
            records["bsdf_sample_eval"].update(
                lanes_x4=lanes, reference_ms_x4=ref_ms, turns_ms_x4=ms,
                bytes_dense_x4=dense,  # the same lanes: 4 times the bound
                bound_ms_x4=4 * records["bsdf_sample_eval"]["bound_ms"])
            continue
        records[k].update(reference_ms=ref_ms, turns_ms=ms,
                          reference_bound_share=records[k]["bound_ms"]
                          / ref_ms)
    return records



def _vol_args(s):
    """steps_cuda's tensor arguments of a lane set (testing.vol_lane_set's
    dict, or a captured round's): the state, the cells, the medium's six."""
    from nart_tpu_torch import vol_ops

    m = s["medium"]
    return [getattr(s["vs"], f).contiguous() for f in vol_ops.FIELDS] + [
        s["cells"], m.sigma_a, m.sigma_s, m.le, m.bounds_min, m.bounds_max,
        s["sigma_maj"]]


def _vol_sampled(s, k):
    """The lane-steps of the k steps that sample the medium (read a cell
    row), from the plain steps' records."""
    from nart_tpu_torch import vol_ops

    recs = []
    vol_ops.flight_steps_plain(s["vs"], k, s["cells"], s["medium"],
                               s["sigma_maj"], s["bounces"], recs=recs)
    return sum(int((r["absorb"] | r["scatter"] | r["null"]).sum())
               for r in recs)


def vol_bytes(kernel, n, k, sampled):
    """The bytes V1 or V2 must move for n lanes and k steps: each per-lane
    input and output once (VOL_LANE_BYTES), k cotangent rows of 8 and
    indices for V2, and a 32-byte cell row a sampling lane-step."""
    fixed, per_step = VOL_LANE_BYTES[kernel]
    return n * (fixed + k * per_step) + 32 * sampled


def _vol_off(label, names, got, want, whose):
    """Every output of got the same bits as want's on every lane, else an
    AssertionError naming the outputs off (lanes, some of them, values)."""
    import torch

    off = {}
    for name, a, b in zip(names, got, want):
        a, b = a.reshape(a.shape[0] if a.dim() else 1, -1), b.reshape(
            b.shape[0] if b.dim() else 1, -1)
        same = (a.view(torch.int32) == b.view(torch.int32)
                if a.dtype == torch.float32 else a == b)
        lanes = (~same).any(-1)
        if bool(lanes.any()):
            i = lanes.nonzero()[:3, 0]
            off[name] = (int(lanes.sum()), i.tolist(), a[i].tolist(),
                         b[i].tolist())
    if off:
        raise AssertionError(f"{label}: outputs off {whose} bits (lanes, "
                             f"e.g. lanes, got, want): {off}")


def _vol_set_checks(label, s, rng):
    """Phase 28 on one lane set, k = 1 and VOL_K: V1 against the plain
    steps and against its first design (nart_vol_steps_ref), V2 against
    its first design (nart_vol_steps_bwd_ref): every output, every lane,
    the same bits; V1's segment starts added into an accumulator that
    held a count already; and V2 against the float64 VJP of the plain
    steps (rtol VOL_RTOL / atol VOL_ATOL on every lane whose float64
    forward chose the float32 events; the others counted and named;
    finite everywhere), beside the plain float32 VJP's distance from it.
    Returns (V2's largest abs error, its largest error over the
    tolerance)."""
    import torch

    from nart_tpu_torch import vol_ops

    n = s["vs"].alive.shape[0]
    shape = tuple(s["medium"].density.shape)
    args = _vol_args(s)
    names = list(vol_ops.FIELDS) + ["died", "esc", "seg"]
    worst = ratio = 0.0
    for k in (1, VOL_K):
        got = vol_ops.steps_cuda(k, s["bounces"], shape, *args)
        out, died, esc, seg = vol_ops.flight_steps_plain(
            s["vs"], k, s["cells"], s["medium"], s["sigma_maj"],
            s["bounces"])
        want = [getattr(out, f) for f in vol_ops.FIELDS] + [died, esc, seg]
        _vol_off(f"V1 {label}, k = {k}", names, got, want,
                 "the plain steps'")
        _vol_off(f"V1 {label}, k = {k}", names, got,
                 vol_ops.steps_ref_cuda(k, s["bounces"], shape, *args),
                 "its first design's (nart_vol_steps_ref)")
        acc = torch.full((), 1000003, dtype=torch.int64, device=DEVICE)
        vol_ops.steps_cuda(k, s["bounces"], shape, *args, seg=acc)
        if int(acc) != 1000003 + int(seg):
            raise AssertionError(f"V1 {label}, k = {k}: the accumulator "
                                 f"holds {int(acc)}, not 1000003 + "
                                 f"{int(seg)}")
        g_beta = torch.from_numpy(rng.normal(size=(n, 3)).astype(
            np.float32)).to(DEVICE)
        g_l = torch.from_numpy(rng.normal(size=(n, 3)).astype(
            np.float32)).to(DEVICE)
        v2 = vol_ops.steps_bwd_cuda(k, s["bounces"], shape, *args, g_beta,
                                    g_l)
        _vol_off(f"V2 {label}, k = {k}", VOL_GRADS, v2,
                 vol_ops.steps_bwd_ref_cuda(k, s["bounces"], shape, *args,
                                            g_beta, g_l),
                 "its first design's (nart_vol_steps_bwd_ref)")
        vjp = (s["cells"], s["medium"], s["sigma_maj"], s["bounces"], g_beta,
               g_l)
        *ref, agree = vol_ops.flight_steps_vjp_reference(s["vs"], k, *vjp)
        *p32, _ = vol_ops.flight_steps_vjp_reference(
            s["vs"], k, *vjp, dtype=torch.float32)
        twin = vol_ops.flight_steps_vjp_plain(s["vs"], k, *vjp)
        other = int((~agree).sum())
        lines, outside32 = [], 0
        for j, name in enumerate(VOL_GRADS):
            if name == "idx":
                if not (torch.equal(v2[j], ref[j])
                        and torch.equal(v2[j], twin[j])):
                    raise AssertionError(f"V2 {label}, k = {k}: the rows' "
                                         "cells differ from the plain steps'")
                continue
            x, r = v2[j].double(), ref[j]
            if not bool(torch.isfinite(v2[j]).all()):
                raise AssertionError(f"V2 {label}, k = {k}: {name} not "
                                     "finite")
            lim = VOL_ATOL + VOL_RTOL * r.abs()
            over = (x - r).abs() / lim
            lanes = (agree[None, :, None] if name == "rows" else
                     agree[:, None] if x.dim() == 2 else agree)
            over_used = torch.where(lanes.expand_as(over), over, 0.0)
            ratio = max(ratio, float(over_used.max()))
            worst = max(worst, float(torch.where(
                lanes.expand_as(x), (x - r).abs(), 0.0).max()))
            bad = int((over_used > 1.0).sum())
            o32 = (p32[j].double() - r).abs() > lim
            outside32 += int(o32.reshape(-1, *o32.shape[-1:]).any(-1).sum()
                             if name == "rows" else o32.reshape(n, -1)
                             .any(-1).sum())
            tw = bool(torch.equal(v2[j], twin[j]))
            lines.append(f"{name} {float(over_used.max()):.3g} of the "
                         f"tolerance{'' if not bad else f' ({bad} outside)'}"
                         f"{', the twin bits' if tw else ''}")
            if bad:
                raise AssertionError(
                    f"V2 {label}, k = {k}: {name} outside rtol {VOL_RTOL} / "
                    f"atol {VOL_ATOL} of the float64 VJP on {bad} values")
        log(f"    {label} ({n} lanes), k = {k}: V1 the plain steps' and its "
            f"first design's bits on every lane ({int(seg)} segment starts, "
            f"also added into an accumulator); V2 its first design's bits on "
            f"every lane, within the float64 "
            f"VJP's tolerance on {n - other} lanes, {other} lanes whose "
            f"float64 forward chose other events (not held); "
            f"{'; '.join(lines)}; the plain float32 VJP outside the "
            f"tolerance on {outside32} lane rows")
    return worst, ratio


def vol_checks():
    """Phase 28: V1 and V2 (csrc/vol_step.cu) against their plain versions
    on the card.  Sets: volume_blob 1280x720 @ 4's static-machine states
    (32,768 lanes) at its first round and at round VOL_MID_ROUND of a
    per-round render (testing.vol_round_states), and testing.vol_lane_set
    at 32,768 lanes (every branch of a step, the null event at p_null = 0).
    For k = 1 and VOL_K (the machines' FUSE_STEPS): V1's every output the
    plain steps' bits on every lane; V2 within rtol 1e-5 / atol 1e-6 of
    the float64 VJP of the plain steps (vol_ops.flight_steps_vjp_reference)
    on every lane whose float64 forward chose the float32 events, finite
    everywhere, the plain float32 VJP's distance logged.  At the mid-render
    round, k = VOL_K: V1's, V2's and their plain versions' device ms (the
    plain steps, and V2's torch twin flight_steps_vjp_plain), the bound
    (bytes: each per-lane input and output once and a 32-byte cell row a
    sampling lane-step, over 3.35 TB/s; operations VOL_OPS; library none:
    no PyTorch call computes a flight step).  Returns the kernels'
    records."""
    import torch

    from nart_tpu_torch import cuda_build, testing, vol_ops

    rng = np.random.default_rng(28)
    cuda_build.reset_launch_counts()
    overrides = {"image_width": 1280, "image_height": 720, "spp": 4}
    rounds = testing.vol_round_states(
        lambda: volume_session(overrides, per_round=True)[1],
        {1, VOL_MID_ROUND})
    sets = {}
    for r, (vs, k, cells, medium, sigma_maj, bounces) in sorted(
            rounds.items()):
        if k != VOL_K:
            raise AssertionError(f"round {r}: {k} steps, not {VOL_K}")
        sets[f"volume_blob round {r}"] = dict(
            vs=vs, cells=cells, medium=medium, sigma_maj=sigma_maj,
            bounces=bounces)
    sets["edge set"] = testing.vol_lane_set(VOL_EDGE_LANES, 28, DEVICE)
    worst = ratio = 0.0
    for label, s in sets.items():
        w, r = _vol_set_checks(label, s, rng)
        worst, ratio = max(worst, w), max(ratio, r)

    s = sets[f"volume_blob round {VOL_MID_ROUND}"]
    n = s["vs"].alive.shape[0]
    shape = tuple(s["medium"].density.shape)
    args = _vol_args(s)
    g = [torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(
        DEVICE) for _ in range(2)]
    vjp = (s["cells"], s["medium"], s["sigma_maj"], s["bounces"], *g)
    sampled = _vol_sampled(s, VOL_K)
    acc = torch.zeros((), dtype=torch.int64, device=DEVICE)  # the rays'
    fns = {
        "vol_steps": (
            lambda: vol_ops.steps_cuda(VOL_K, s["bounces"], shape, *args,
                                       seg=acc),
            lambda: vol_ops.flight_steps_plain(
                s["vs"], VOL_K, s["cells"], s["medium"], s["sigma_maj"],
                s["bounces"])),
        "vol_steps_bwd": (
            lambda: vol_ops.steps_bwd_cuda(VOL_K, s["bounces"], shape, *args,
                                           *g),
            lambda: vol_ops.flight_steps_vjp_plain(s["vs"], VOL_K, *vjp)),
    }
    records = {}
    for kname, (kern, plain) in fns.items():
        t = kernel_ms(kern, 20)
        tp = device_ms(plain, launches=5)
        nbytes = vol_bytes(kname, n, VOL_K, sampled)
        f32, f64 = (x * n * VOL_K for x in VOL_OPS[kname])
        bytes_ms = 1e3 * nbytes / PEAK_BYTES
        ops_ms = 1e3 * (f32 / PEAK_FLOPS + f64 / PEAK_FLOPS64)
        bound = max(bytes_ms, ops_ms)
        side = "bytes" if bytes_ms >= ops_ms else "operations"
        log(f"    {kname} at volume_blob's round {VOL_MID_ROUND} ({n} lanes, "
            f"k = {VOL_K}, {sampled} sampling lane-steps): {fmt(t)}; plain "
            f"version {fmt(tp)}; library none (no PyTorch call computes a "
            f"flight step); bound {bound:.6f} ms ({side}; bytes {nbytes}: "
            f"{bytes_ms:.6f} ms; operations {f32:.0f} float32 and {f64:.0f} "
            f"float64: {ops_ms:.6f} ms), {100 * bound / t['ms']:.2f}% "
            f"reached; plain / kernel {tp['ms'] / t['ms']:.1f}x")
        records[kname] = dict(
            ms=t["ms"], ms_min=t["min"], ms_max=t["max"],
            ms_per_call=t["ms_per_call"], plain_ms=tp["ms"],
            plain_method=tp["method"], library_ms=None, bound_ms=bound,
            bound_by=side, bytes=nbytes, ops_f32=f32, ops_f64=f64, lanes=n,
            steps=VOL_K, sampled_lane_steps=sampled,
            max_abs_err=worst if kname == "vol_steps_bwd" else 0.0,
            tolerance_ratio=ratio if kname == "vol_steps_bwd" else None,
            shape=f"volume_blob 1280x720 @ 4, static machine, round "
                  f"{VOL_MID_ROUND}")
    for k, fields in _vol_turns(s, args, g, acc).items():
        records[k].update(fields)
    return records


def _vol_turns(s, args, g, acc):
    """Phase 28 at the mid-render round, k = VOL_K: V1 (with the rays'
    accumulator, as the machines call it) and V2 against their first
    designs (V1's with its zero-filled count, as the first design's
    machines called it) in turns (reference, new, new, reference), device
    ms each; the node floor (an empty kernel of V1's grid, a one-element
    fill) by the same timer; the graph nodes of a call; and the
    redesign's sine and cosine against sinf / cosf on every float in
    [-2 pi, 2 pi] (none may differ).  Returns {kernel: fields for its
    record}."""
    import torch

    from nart_tpu_torch import vol_ops

    n = s["vs"].alive.shape[0]
    shape = tuple(s["medium"].density.shape)
    b = s["bounces"]
    pairs = {
        "vol_steps": (
            lambda: vol_ops.steps_ref_cuda(VOL_K, b, shape, *args),
            lambda: vol_ops.steps_cuda(VOL_K, b, shape, *args, seg=acc)),
        "vol_steps_bwd": (
            lambda: vol_ops.steps_bwd_ref_cuda(VOL_K, b, shape, *args, *g),
            lambda: vol_ops.steps_bwd_cuda(VOL_K, b, shape, *args, *g))}
    one = torch.zeros((), dtype=torch.int64, device=DEVICE)
    floor = {"empty": lambda: vol_ops.node_floor_cuda(n, one.device),
             "fill": one.zero_}
    per_call = call_ms(pairs["vol_steps"][0], 5)
    floor_ms = {key: device_ms(fn, launches_for(per_call))
                for key, fn in floor.items()}
    log(f"    node floor ({n} lanes): an empty kernel of V1's grid "
        f"{fmt(floor_ms['empty'])}, a one-element fill "
        f"{fmt(floor_ms['fill'])}")
    out = {}
    for k, (ref_fn, new_fn) in pairs.items():
        per_call = call_ms(ref_fn, 5)
        ms = {"reference": [], "new": []}
        for turn in ("reference", "new", "new", "reference"):
            fn = ref_fn if turn == "reference" else new_fn
            ms[turn].append(device_ms(fn, launches_for(per_call))["ms"])
        nodes, nodes_ref = graph_nodes(new_fn), graph_nodes(ref_fn)
        ref_ms = statistics.mean(ms["reference"])
        log(f"    turns {k} at volume_blob's round {VOL_MID_ROUND} ({n} "
            f"lanes, k = {VOL_K}): reference {ms['reference'][0]:.4f}, new "
            f"{ms['new'][0]:.4f}, new {ms['new'][1]:.4f}, reference "
            f"{ms['reference'][1]:.4f} ms; reference / new "
            f"{ref_ms / statistics.mean(ms['new']):.3f}x; graph nodes a "
            f"call: new {nodes}, reference {nodes_ref}")
        if k == "vol_steps" and nodes != 1:
            raise AssertionError(f"V1 with an accumulator is {nodes} graph "
                                 "nodes a call, not 1")
        out[k] = dict(reference_ms=ref_ms, turns_ms=ms, graph_nodes=nodes,
                      reference_graph_nodes=nodes_ref,
                      node_floor_ms=floor_ms["empty"]["ms"],
                      fill_ms=floor_ms["fill"]["ms"])
    checked = bad = 0
    for lo in (0, 0x80000000):  # [0, 2 pi], then [-2 pi, -0]
        hi = lo | VOL_TWO_PI_BITS
        bad += int(vol_ops.trig_check_cuda(lo, hi, one.device))
        checked += hi - lo + 1
    log(f"    the redesign's sine and cosine against sinf / cosf on every "
        f"float in [-2 pi, 2 pi] ({checked} values): {bad} differ")
    if bad:
        raise AssertionError(f"sincos_small differs from sinf / cosf on {bad}"
                             " values in [-2 pi, 2 pi]")
    out["vol_steps"].update(trig_values_checked=checked, trig_mismatches=bad)
    return out

SIZES = {"camera_rays": 65536, "shadow_rays": 131072, "soup_tris": 40000,
         "soup_rays": 65536, "reps": 20}
# (first round, rounds) of the volume phases' profiled windows
VOLUME_WINDOW = (40, 20)
# phase 23's look-up shapes: lanes, table rows, row widths; the backward's
# tolerance against a float64 sum (float32 sums in another order)
LUT_LANES = (65536, 131072)
LUT_ROWS = (1, 3, 4, 16, 64)
LUT_WIDTHS = (1, 3)
# phase 23's many-table forward: the tables' row widths, read in one launch
LUT_MANY_WIDTHS = (1, 2, 3, 4, 5, 6, 7, 8, 3, 1, 4, 8, 2, 3, 1, 8)
# phase 23's many-table backward: 16 tables (rows, width) of rows 1 to 64
# and widths 1 to 4, and make_bsdf's five trainable per-mesh tables' widths
# (rho_d, rho_s, tau, eta, alpha)
LUT_BWD_MIX = ((1, 3), (3, 1), (64, 4), (16, 2), (4, 3), (33, 1), (64, 1),
               (2, 4), (7, 3), (48, 2), (5, 4), (64, 3), (1, 1), (20, 3),
               (12, 4), (9, 2))
MAKE_BSDF_WIDTHS = (3, 3, 3, 1, 1)
LUT_RTOL, LUT_ATOL = 1e-5, 1e-6
LUT_INT = 8  # integer cotangents in [-8, 8]: sums below 2^20, exact
# phase 24's shapes, the main path's: (label, lanes, rows, row width)
LARGE_SHAPES = (("macbeth env map", 65536, 64 * 128, 3),
                ("macbeth tex_data", 65536, 2525 * 3583, 3),
                ("volume_blob density cells", 32768, 31**3, 8))
# phase 24's table rows where both backward kernels are timed
S1_S2_ROWS = (3, 64, 1024, 4096, 8192, 16384, 65536)
# phase 27's lanes a LOBES set (testing.bsdf_lane_set); X3's tolerance
# against the float64 VJP of the plain version
BSDF_LANES = 65536
# the inputs a lobe of each code reads where a lane samples or evaluates it
# (csrc/bsdf.cu's lobe functions): (rho_d row, rho_s row, tau row, alpha
# with use_prime, eta and eta_outer, wo), and their bytes a lane
LOBE_READS = {0: (1, 0, 0, 0, 0, 0), 1: (0, 1, 0, 1, 1, 1),
              2: (0, 1, 1, 1, 1, 1), 3: (0, 1, 0, 0, 1, 1),
              4: (0, 1, 1, 0, 1, 1)}
LOBE_READ_BYTES = (12, 12, 12, 4 + 1, 4 + 4, 12)
BSDF_RTOL, BSDF_ATOL = 1e-5, 1e-6
# the float32 and float64 operations a lane of each BSDF kernel does, by
# the lane's (lobe 0, lobe 1): the mean over 4,096 lanes of the LOBES set
# of that pair (tests/test_torch_shading.py's inputs), counted by a host
# build of csrc/bsdf.cu whose float and double are counting types (an add,
# subtract, multiply, divide, compare, min, max, sqrt, sin, cos or floor
# one operation, an FMA two); X3 in "sample" mode
BSDF_OPS = {
    (0, -1): {"bsdf_sample": (27.0, 0), "bsdf_eval": (9.0, 0),
              "bsdf_f_bwd": (0, 24.0)},
    (0, 1): {"bsdf_sample": (263.0, 0), "bsdf_eval": (190.0, 0),
             "bsdf_f_bwd": (116.9, 1340.5)},
    (0, 3): {"bsdf_sample": (40.4, 0), "bsdf_eval": (9.0, 0),
             "bsdf_f_bwd": (21.9, 239.1)},
    (1, -1): {"bsdf_sample": (313.5, 0), "bsdf_eval": (186.0, 0),
              "bsdf_f_bwd": (116.9, 1318.2)},
    (2, -1): {"bsdf_sample": (384.3, 0), "bsdf_eval": (215.9, 0),
              "bsdf_f_bwd": (108.9, 1299.5)},
    (4, -1): {"bsdf_sample": (98.1, 0), "bsdf_eval": (5.0, 0),
              "bsdf_f_bwd": (89.0, 945.1)},
    (3, -1): {"bsdf_sample": (54.0, 0), "bsdf_eval": (5.0, 0),
              "bsdf_f_bwd": (44.0, 457.0)}}
PEAK_FLOPS64 = 34e12  # float64 outside the tensor cores, H100 SXM
# phase 28: the machines' steps a round, the mid-render round of
# volume_blob's states, the edge set's lanes, V2's tolerance against the
# float64 VJP
VOL_K = 4
VOL_MID_ROUND = 60
VOL_EDGE_LANES = 32768
VOL_RTOL, VOL_ATOL = 1e-5, 1e-6
VOL_GRADS = ("g_beta", "g_l", "rows", "idx", "p_sa", "p_ss", "p_le")
VOL_TWO_PI_BITS = 0x40C90FDB  # float32(2 pi)'s bits
# the bytes a lane of V1 / V2 moves besides its cell rows: (fixed, a step).
# V1: the state in (alive and new_ray 1 each, bounce and state 8, u_mode,
# t_cur, t_exit 4, o, d, beta, l_out 12: 78) and out, with died and esc
# (80).  V2: the state and the two cotangents in (78 + 24), the two
# incoming cotangents and the partials out (12 + 12 + 4 + 4 + 12); a step
# a row of 8 cotangents and an int64 index out
VOL_LANE_BYTES = {"vol_steps": (158, 0), "vol_steps_bwd": (146, 40)}
# the float32 and float64 operations of a lane-step (an add, subtract,
# multiply, divide, compare, min, max, conversion, log, acos, sin or cos
# one operation), counted from csrc/vol_step.cu's flight_step (~175: the
# slab clip 30, six draws' floats 18, the flight 5, the point and its
# inside test 12, the cell 27, its weights and sum 34, the event 8, the
# ratios 8, beta and l_out 18, the sphere 10 where it scatters) and
# step_back (a float64 density 15 and the reverse pass ~80)
VOL_OPS = {"vol_steps": (175, 0), "vol_steps_bwd": (175, 95)}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, HERE)
    from nart_tpu_torch import cuda_build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    t0 = time.perf_counter()
    sources = (SOURCE, LUT_SOURCE, LARGE_SOURCE, BVH_SOURCE, BSDF_SOURCE,
               VOL_SOURCE)
    reported = (BVH_SOURCE, BSDF_SOURCE, VOL_SOURCE)
    libs = [os.path.splitext(os.path.basename(f))[0] for f in sources]
    with ThreadPoolExecutor(len(libs) + len(reported) + 1) as pool:
        # one nvcc a source, all started together
        reports = [pool.submit(ptxas_report, f) for f in reported]
        host = pool.submit(cuda_build.build_host, "core")  # g++
        list(pool.map(cuda_build.build, libs))
        reports, host = [r.result() for r in reports], host.result()
    for lib in libs:
        cuda_build.load(lib)
    from nart_tpu_torch import native
    native.lib()
    log(f"build: {', '.join(sources)} and the host core {CORE_SOURCE} "
        f"({os.path.basename(host)}), together, in "
        f"{time.perf_counter() - t0:.2f} s")
    from nart_tpu_torch.kernel_variants import bsdf_design, ptxas_kernels
    vol_ptxas = {}  # the shipped V1's and V2's: no stack frame, no spills
    for source, report in zip(reported, reports):
        for kname, regs, frame, st, ld in ptxas_kernels(report):
            design = bsdf_design(kname)
            log(f"ptxas {source}: {kname}{design} {regs} registers, stack "
                f"frame {frame} B, spill stores {st} B, spill loads {ld} B")
            for k, tag in (("vol_steps", "vol_steps_kernel"),
                           ("vol_steps_bwd", "vol_steps_bwd_kernel")):
                if source == VOL_SOURCE and tag in kname:
                    vol_ptxas.setdefault(k, []).append(
                        dict(kernel=kname, registers=regs, frame=frame,
                             spill_stores=st, spill_loads=ld))
    bad = [r for rows in vol_ptxas.values() for r in rows
           if r["frame"] or r["spill_stores"] or r["spill_loads"]]
    if len(vol_ptxas) != 2 or bad:
        raise AssertionError(f"V1 / V2 in ptxas: {vol_ptxas}: want each "
                             "without a stack frame or spills")

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[{label}: {time.perf_counter() - t0:.1f} s]")
        return out

    records = phase("kernel checks", kernel_checks, DEVICE, SIZES)
    phase("golden", golden_check, DEVICE, (96, 96, 8))
    counts = phase("forward path", main_path, {"spp": 8})
    counts_tool = phase("counter tool", stats_path)
    for k in ("closest_hit_stats", "any_hit_stats"):
        counts[k] = counts_tool[k]
    counts_train = phase("training path", training_path, 4)
    phase("card against CPU", card_against_cpu)
    counts_modes = phase("spp and regen modes", modes_path, 4, 2)
    phase("volume golden", volume_golden)
    counts_vol = phase("volume forward", volume_forward, 8, VOLUME_WINDOW)
    counts_vol_train = phase("volume training path", volume_training, 4,
                             VOLUME_WINDOW)
    phase("volume card against CPU", volume_card_against_cpu, (32, 32, 2))
    counts_a, single = phase("sharded, virtual ranks", sharded_virtual, 2)
    counts_b = phase("two ranks, gloo", two_ranks, single)
    counts_c = phase("CLI, NCCL world of one", cli_world_of_one, 2)
    phase("checkpoint and resume", checkpoint_resume)
    records["bvh_hit"], counts_bvh = phase("bvh accel", bvh_accel,
                                          (1280, 720, 1))
    counts_bench = phase("bench subprocess", bench_subprocess, 128, 4)
    counts_cornell = phase("cornell golden", cornell_golden)
    phase("round sync check", round_sync_check, 1)
    rounds_records = phase("graphed rounds", graphed_rounds)
    phase("graphed replay", graphed_replay)
    records.update(phase("small-table look-ups", lut_checks, DEVICE))
    large = phase("large-table look-ups", large_lut_checks, DEVICE)
    fwd_large = large.pop("lut_gather_shapes")
    records["lut_gather"]["shapes"] = fwd_large["shapes"]
    records["lut_gather"]["max_abs_err"] = max(
        records["lut_gather"]["max_abs_err"], fwd_large["max_abs_err"])
    records.update(large)
    counts_large = phase("large mesh", large_mesh)
    phase("scaling evidence", scaling_phase)
    records.update(phase("BSDF kernels", bsdf_checks))
    records.update(phase("volume flight-step kernels", vol_checks))
    for k, rows in vol_ptxas.items():
        records[k]["ptxas"] = rows
    # the forward kernels a graphed macbeth path round with the BSDF calls
    # on their plain versions and on the kernels (phase 21)
    mac = rounds_records["macbeth 1280x720 @ 4 spp"]["graphed"]
    before, after = mac["plain_bsdf"]["kernels_a_round"], mac["kernels_a_round"]
    log(f"forward kernels and copies a graphed macbeth 1280x720 @ 4 spp "
        f"round (phase 21): {before:.1f} with the BSDF calls' plain "
        f"versions, {after:.1f} with X1 and the sample+eval launch "
        f"({before / after:.2f}x fewer)")
    for k in BSDF:
        records[k]["forward_kernels_a_round"] = {"before": before,
                                                 "after": after}
    # the same for a graphed volume_blob round with the flight steps on
    # their plain version and on V1 (phase 21)
    vol = rounds_records["volume_blob 1280x720 @ 4 spp"]["graphed"]
    before, after = (vol["plain_steps"]["kernels_a_round"],
                     vol["kernels_a_round"])
    log(f"forward kernels and copies a graphed volume_blob 1280x720 @ 4 spp "
        f"round (phase 21): {before:.1f} with the flight steps' plain "
        f"version, {after:.1f} with V1 ({before / after:.2f}x fewer); device "
        f"ms of the profiled render {vol['plain_steps']['device_ms']:.3f} -> "
        f"{vol['device_ms']:.3f}")
    for k in VOL:
        records[k]["forward_kernels_a_round"] = {"before": before,
                                                 "after": after}

    # `launches`: a traversal kernel's in the forward render (phase 5), a
    # look-up kernel's (small or large tables) in the fwd+bwd (phase 6),
    # whose backward the look-ups are on, B1's in the graphed "bvh" render
    # (phase 17), the path of the accel kind it serves
    runs = {k: (counts, "forward") if k in TRAVERSAL + BSDF[:2] else
            (counts_bvh, "bvh render") if k == "bvh_hit" else
            (counts_vol, "volume forward") if k == "vol_steps" else
            (counts_vol_train, "volume fwd+bwd") if k == "vol_steps_bwd" else
            (counts_train, "fwd+bwd") for k in KERNELS}
    for k, (run, label) in runs.items():
        if run[k] <= 0:
            raise AssertionError(f"{k} was not launched in the {label}")
    kernels = [dict(name=k, route="cuda", source=SOURCES[k],
                    replaces=REPLACES[k],
                    launches=runs[k][0][k], launches_of=runs[k][1],
                    launches_forward=counts[k],
                    launches_training=counts_train[k],
                    launches_modes=counts_modes.get(k, 0),
                    launches_volume=counts_vol[k] + counts_vol_train[k],
                    launches_sharded=counts_a[k] + counts_b[k] + counts_c[k],
                    launches_bench=counts_bench[k],
                    launches_cornell=counts_cornell[k],
                    launches_large_mesh=counts_large[k],
                    **records[k])
               for k in KERNELS]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--turn"]:
        sys.path.insert(0, sys.argv[2])
        turn(sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--vol-witness"]:
        sys.path.insert(0, HERE)
        log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
        vol_leaf_witness()
        sys.exit(0)
    if sys.argv[1:2] == ["--witness"]:
        sys.path.insert(0, HERE)
        log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
        leaf_witness()
        sys.exit(0)
    if sys.argv[1:2] == ["--turns"]:
        sys.path.insert(0, HERE)
        from nart_tpu_torch import cuda_build as _cb  # noqa: F401

        log(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
        turns(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
