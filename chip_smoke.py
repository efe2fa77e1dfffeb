"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card and
check it. Run from the repository root with no arguments:

  python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:

1. build   — compile every kernel from the repository's sources with
             nvcc for sm_90a; print the build time and the ptxas lines.
2. kernels — each kernel against its plain PyTorch version, on the card,
             at the main paths' shapes and at edge shapes, each against
             its stated bound (K3, flash attention, fp32 and bf16 at the
             DiT's and the planning shapes, fp32 at the served closed
             loop's (32, 4, 4, 8, 32), GQA with a causal window, a
             ragged S = 75 with true_len 50, D = 256, gemma3-12b's prefill
             shapes (1, 16, 4096, 256) over (1, 8, 4096, 256) causal with
             window 1024 ("L") and causal ("A"), fp32 and bf16 (phase 9d;
             bf16 held element by element, and the kernel run with a mask
             one key tile off must exceed that bound), the MoE LMs' causal
             prefill shapes (phase 7d), llama-3.2-vision-90b's (1, 64, 8,
             4096, 128) and musicgen-medium's (4, 24, 24, 1500, 64) causal
             (phase 7e), each the same bits
             on a second call; GroupNorm → SiLU at all 17 shapes of a
             TRAJ_UNET forward at 128 and at 32 rows (phase 6e's served
             slots), fp32 and bf16, and at x = 1e3 + N(0, 1),
             on the register kernel the wrapper picks there and on the
             general kernel, forced, each the same bits on a second call;
             K1 at the DiT state, planning's (64, 736), B = 1 and two
             3072-column tiles a row, on operands off 16 bytes (bitwise
             the aligned call), every sub-batch of a B = 64 call bitwise
             its rows,
             one CUDA kernel a call (the kernel nodes of a captured graph
             of 8 calls, read through the driver API; torch.profiler's
             trace may hold no more, nor any other kernel), and a
             replayed CUDA graph bitwise the eager call;
             K5 at the DiT, Table-2 and planning states, ragged D, the
             tables' (4096, 2) and (2048, 2), (5, 3), B = 70,000 and the
             selection race's (512, 8), fp32
             and bf16, each also off 16 bytes (bitwise the aligned call),
             with the launch ``em_kernel_config`` gives, and a
             non-contiguous view, which must raise; K7,
             the SSD scan, at mamba2-2.7b's prefill shape (4, 2048, 80,
             64, 1, 128), a ragged S = 1000, several groups (1, 100, 8,
             32, 2, 32), prefill_32k's length (1, 32768, 80, 64, 1, 128)
             a shape split into ranges with a ragged last range (1,
             5000, 8, 64, 1, 128) and jamba-v0.1-52b's "M" layers at
             d_state 16 (1, 2048, 128, 64, 1, 16), each with the range count the wrapper
             picks: against the plain version, y and the final state
             against the sequential oracle, bitwise equal on a second
             call; y and the final state against the oracle at a small
             shape, and bf16 at three shapes, mamba2-2.7b's prefill shape
             among them (phase 9e), each the same bits twice); K1 at
             HIGHRES_DIT's state (8, 196,608) with bf16 state (phase 9),
             against the plain version, the same bits twice, and off 16
             bytes bitwise the aligned call; K1 at the tables' states
             (4096, 2) and (2048, 2) and the trained DIT_100M's (8, 3072),
             and in fp32 at the zoo's and planning service's states (the
             selection race's (512, 8), the served closed loop's (16, 768),
             the OU service's (4, 32)) and the diffusion LM's (4, 4096);
             K2 (the
             solver step with ε per row) at the DiT state with the three
             tiers' ε_rel in one call, within K1's bounds, the same bits
             twice, each row bitwise its uniform-ε call's; P1
             (``philox_normal``, the per-slot noise draw) at the DiT
             state, planning's, Table 1's, a ragged row and the served
             states of phases 6d and 6e: the words
             exactly, z within 2e-6·(1 + |z|) of ``ref.py``, an idle row
             0, permuted rows bitwise; P2 (``horizon_cond``) on
             hand-built masks against ``ref.horizon_cond``, exactly,
             the same state on a second call (a horizon ending by its
             length, every row done, the budget spent mid-horizon,
             wait_all and compaction, an idle slot); K1 at (70,000, 2) and K3 at
             (17,500, 4, 8, 32), past one launch's 65,535 rows of
             gridDim.y (two launches each), against their plain
             versions; and the autograd guard: under grad mode K1, K5,
             K4's partial mode, K3, K6 and K7 each refuse an input that
             requires grad, launching nothing.
3. main    — the first main path, ``repro_torch.launch.sample.run``:
             the 256×256 DiT (HIGHRES_DIT, weights from a seed, zero-init
             leaves livened), VP SDE, batch 8, eps_rel 0.05, fused solver
             step and flash attention, fp32, at most MAIN_MAX_ITERS
             iterations. Launch counts are set to 0 just before and read
             just after; every kernel must have run. Then one DiT forward
             and one Algorithm-1 iteration with the kernels, against the
             same weights on the plain paths. Then the graphed solve
             (``graphed_vs_host``): ``sample()`` four times at a new key
             under the one-shot rule (the first call runs the host-driven
             chain and records the key, the second captures the cached
             driver's horizon, the others replay it, the last with CUDA
             events around the WHILE-node window) against the
             host-driven ``solve_chunk`` chain on the same streams: x,
             nfe, accepted, rejected, iterations and the telemetry ring
             bitwise, the chain's host reads on the first call and one
             read a graphed solve, captures 0, 1, 0, the replay's
             K1/K3/K6/P1 launches exactly the iterations' (the chain's
             less its last group's masked tail; the second call's plus
             one warm-up body iteration), P2 the iterations + 1 (a
             condition after every iteration); the walls of each call and
             the chain, and the window share from the events: the
             window's elapsed time on the device over the call's wall
             (elapsed, not busy: CUPTI cannot trace the WHILE node, so
             gaps inside the window are not seen).
3b. guided — controlled generation from HIGHRES_DIT (``run_guided``;
             the same seeded, livened weights, flash, fused step, fp32,
             batch 8, eps_rel 0.05): classifier-free guidance at scale
             GUIDED_CFG on the net made class-conditional (labels cycling
             0..9, one forward over 16 rows an evaluation) and inpainting
             of the launcher's checkerboard (``launch.sample.guidance``),
             each through ``sample()`` with its conditioner and payload in
             phase 3's graphed gates (``graphed_vs_host``: the first call
             host-driven, the second captures, the replay bitwise the
             host-driven chain, ring included); then a replay with another
             payload (labels shifted by 5; the complementary mask with the
             observed values negated): bitwise a host-driven solve with
             that payload, no capture, one host read, and not the first
             payload's sample (a payload baked into the capture would
             replay it); observed pixels exactly the observed values on
             both payloads; a replayed call's launches K1 one a body
             iteration, K3 num_layers·(2·body iterations + 1), P1 1 +
             draws·body iterations (1 CFG, 2 inpainting), the body
             iterations exactly the iterations, P2 the iterations + 1.
             Then ``launch.serve.serve_diffusion`` with each
             conditioner (GUIDED_SERVE_SLOTS slots, GUIDED_SERVE_REQUESTS
             requests, horizon SERVE_HORIZON) host-driven and
             device-resident: the two drains bitwise, the host-driven one
             K1 one and K3 2·num_layers a body iteration, observed pixels
             exact, and GUIDED_SOLO requests each bitwise its solo run
             (``uids=[u]``). K3 at CFG's (16, 12, 256, 64) (phase 2 holds
             it against its plain version) timed beside its plain version,
             SDPA and its 3xTF32 bound.
             ``--only-guided`` runs the build and this phase alone and
             prints no result line.
4. plan    — the second main path, ``repro_torch.planning.plan``: the
             temporal UNet TRAJ_UNET (attention, flash, fused GroupNorm →
             SiLU; weights from seed 0, zero-init leaves livened), VP SDE,
             64 plans with obs (64, 17) and returns bins from seed 0,
             returns CFG 1.5 (one forward over 128 rows), eps_rel 0.05,
             fp32, fused solver step, at most MAIN_MAX_ITERS iterations.
             Launch counts are set to 0 just before and read just after;
             all three kernels must have run. The pinned coordinates must
             equal obs exactly. Then one UNet forward and one guided,
             projected Algorithm-1 iteration with the kernels, against
             the same weights on the plain paths. Then phase 3's graphed
             gates on ``plan()`` (conditioner, projection draws, K6).
4b. baselines — the paper's comparison on the card, every update of the
             stochastic baselines through K5 (``em_step``): EM, DDIM and PC
             from HIGHRES_DIT (the same livened weights, flash on, fp32,
             batch 8) through ``repro_torch.launch.sample.run``, EM and
             DDIM at n_steps = round(phase 3's adaptive mean NFE) and PC
             at half that (two evaluations a step); K5 counts set to 0
             before each solve and read after, and they must equal the
             steps exactly (each run builds its own net, so its solve is
             its key's first: host-driven, no capture). Then each
             baseline graphed (``graphed_baseline``, GRAPHED_BASELINES:
             EM-60, DDIM-60, PC-30, PC-HMC-21 (L = 2) and the ODE at rtol = atol
             = 1e-3 capped at 40 attempts, from the same weights): four
             ``sample()`` calls at a new key, x and nfe bitwise and
             iterations equal on each, captures 0, 1, 0, one host read a
             graphed solve, the replay's K5/K3/P1 launches the
             host-driven loop's less its masked tail (a grid has none;
             the ODE's host-driven groups of SYNC_EVERY attempts do: its
             replay's K3 is exactly 12·(6·attempts + 2)), P2 one a unit
             + 1, and the capturing call's the replay's plus one step's
             (one attempt's); Algorithm 2 graphed at (4096, 2)
             with g = 0.2·x (``forward_graphed``: bitwise, captures 0, 1,
             0, one window and one read a graphed solve). Then the
             Table-2 analog at its full size
             (``repro_torch.benchmarks.table2_highdim``: D 3072, N 256, VE
             σ_max 30, every row, each row's key warmed up by two cheap
             solves first), every timed row at 0 captures, 1 host read
             and K5 exactly its steps, and EM-1000 and PC-500 on the
             closed-form Gaussian score, VP and VE, against the gates of
             the reference's conformance table (W2 < 0.08 for EM, < 0.25
             for the PC family).
5. check   — the first path's samples are finite and of the expected
             shape, and a small adaptive solve on the closed-form Gaussian
             score through the fused kernel passes the reference's
             conformance gate (W2 to the exact marginal < 0.08).
6. timing  — each kernel at the main paths' shapes, device time from a
             replayed CUDA graph of 40 calls (and, for the host's share,
             an eager loop), beside its bound, its plain version and, for
             attention,
             ``torch.nn.functional.scaled_dot_product_attention`` (a
             yardstick only; the port never calls it), K3 in fp32 and
             bf16 at the DiT's shape against both fp32 bounds (CUDA cores,
             3xTF32 tensor cores) and the bf16 one, and ptxas's registers
             and spills for K3's instantiations with their shared
             memory; the launch floor (a one-element zero_() in the same
             harness); K6 at each distinct (H, C) of a forward on both
             kernels, the sum of a forward's 17 launches, and
             F.group_norm + F.silu as a two-call yardstick; K1 at the
             planning state; ptxas's registers, spills and shared memory
             for K6's and K1's kernels; one TRAJ_UNET
             forward at 128 rows, eager and as a replayed graph; K5 at
             the DiT state, the Table-2 state and the tables' (4096, 2) and
             (2048, 2), fp32 and bf16, with ptxas's registers for its
             instantiations; K7 at the prefill shape
             and at (1, 32768, 80, 64, 1, 128) against both fp32 bounds
             (CUDA cores, 3xTF32 tensor cores) and against itself on one
             range a sequence, and ptxas's registers and spills for K7's
             kernels with their shared memory.
6a. serve  — the serving path, ``serving.DiffusionBatcher`` (the
             continuous-batching server) on HIGHRES_DIT (seeded, livened),
             VP, fp32, fused step and flash attention, 8 slots, sync
             horizon 4, 16 requests cycling the draft / standard /
             high_fidelity tiers under EDF admission, the telemetry ring
             (4096) and the tracer on. K1/K2, K3 and P1 counts set to 0
             just before and read just after: exactly one solver-step
             launch (its per-row-ε form, K2), 24 flash launches and one P1
             (the per-slot noise) a body iteration, and one P1 an
             admission (the admitted priors). Gates: every request finite at (256, 256, 3); nfe
             = 2·(accepted + rejected); the ring reconciles with the
             per-request counts; mean NFE draft < standard < high_fidelity;
             requests 0 and 2 each bitwise their solo run in an idle
             server; compaction off bitwise the same samples; 4 requests
             with telemetry on bitwise the same run off. Printed: wall,
             requests/s, per-tier NFE and deadline misses, wasted and
             passenger NFE with and without compaction, host transfers and
             solver syncs, the device idle share (torch.profiler), K2's
             time at (8, 196,608) with the tiers' ε per row.
6c. device — the device-resident serve loop on the same setup: a
             CUDA-graph WHILE node a driver window around one body
             iteration captured once per server, P2 after each (P1, P2,
             K2, K3). Bitwise the
             host-driven serve, with compaction on and off; fewer host
             reads; ≥ 5× fewer device→host reads a request on the
             reference's bench workload at sync horizon 2; no
             synchronising call inside a window; one capture per server;
             the ring reconciles; a run with arrivals over time (4, then 2
             after every second step) bitwise the drain in both modes.
             K2, K3, P1 and P2 counts set to 0 just before the first
             device-resident drain and read just after: the captured
             unit holds K2 once, K3 24 times and P1 once (one body
             iteration), the driver runs exactly the iterations with a
             sample active, and each count is exactly the unit's times
             the units the device ran (the driver charges them when the
             host reads the window's state) plus the eager calls (the
             capture's warm-up iteration, P1 once an admission); P2 once
             a unit and once a window. Printed: walls, reads, windows,
             the share of the wall outside the solver windows in both
             modes (CUDA events around each window or chunk), the
             host-driven idle share (torch.profiler, whose CUPTI tracing
             of WHILE-node graphs loses records and can fault, so it has
             no device-resident counterpart), and P1's and P2's device
             times.
6d. zoo    — the solver zoo (``run_zoo``): momentum and Heun through
             ``launch.sample.run`` from HIGHRES_DIT (batch 8, eps_rel 0.05,
             K1 and K3, exact launches, nfe = 2·(accepted + rejected) + 1);
             every ``analysis.solver_select.ZOO`` row on the closed-form
             score, VP and VE, with exact K1/K5 launches, momentum and Heun
             under their W2 gates, the selection report; each family served
             host-driven and device-resident, every delivery bitwise its
             batch-1 solve, Heun's captured unit without P1. Then
             phase 3's graphed gates on ``sample(method="momentum")`` and
             ``sample(method="heun")``. (A first call at a new key runs
             host-driven and a second captures its graph, whose warm-up
             runs one body iteration eagerly: every exact launch gate of a
             graphed solve adds ``adaptive.captures``' rise, here and in
             6b, 7c, 9a.)
6e. plan service — ``launch.plan.serve_planning`` at the reference's
             defaults and its steering gate (bin 2 above bin 4); the
             receding-horizon planner at TRAJ_UNET's width (transition 24,
             PointMassEnv(dim=8)), 32 environments, 3 rounds, 16 slots,
             CFG 1.5, host-driven, K1/K3/K6/P1 exact a body iteration; the
             first round drained host-driven and device-resident in turns,
             bitwise the planner's deliveries (``run_plan_service``).
6b. train and tables — the training slice, its memory freed before
             phase 7: DIT_100M (32×32, patch 2, d_model 768, 12 layers)
             trained DIT_STEPS steps at batch DIT_BATCH in fp32 with TF32
             off and plain attention (``examples.train_diffusion.train``),
             loss finite and its last value below its first; checkpointed,
             reloaded (the same bits) and sampled, 8 adaptive samples at
             eps_rel 0.05 with flash attention and the fused step, K1 and
             K3 counts set to 0 just before and read just after, each ≥ the
             iterations; the two TOY_MLP nets (600 steps); Tables 1, 3 and
             4–5 (``repro_torch.benchmarks``), every row printed with its
             launches: K5 exactly one a step on EM rows and two on PC rows,
             0 on DDIM, ODE and adaptive rows, K1 exactly one an iteration
             (the timed row replays its graph, so exactly the
             iterations: no masked group tail) on the fused (ℓ2)
             adaptive rows and 0 elsewhere, each row's replayed and
             host-driven walls; ``sample_chunked`` at
             N 4096 in chunks of 1024 with exactly its chunks' launches
             and bits. Gates: (a) every row
             finite; (b) the reference's end-to-end rule
             (``tests/test_e2e_diffusion.py``) on its own setting, adaptive
             no worse than EM at half its NFE in steps + 0.15 in
             w2_gaussianized and both under 0.35 (Table 1's own eps 0.05
             pair is printed, not gated: the reference misses the rule
             there itself); (c) adaptive at eps_rel 0.05 at most 500 NFE;
             (d) each adaptive row's mean NFE within NFE_BAND of the
             reference's CPU run (REF_TABLE1_NFE); every timed row a
             replay (``common.warm_up`` solves its key twice first): 0
             captures, 1 host read. Last, K1 timed at (4096, 2) (K5
             there is timed in phase 6), one Table-1 EM-1000 solve (VP,
             N 4096) graphed (wall, driver window by CUDA events) and
             host-driven (wall, device busy time and idle share by
             torch.profiler), and the phase's wall time.
7. lm      — the third main path, last, after the DiT and UNet memory is
             freed: mamba2-2.7b at full width (2.83 B parameters, fp32,
             weights from a generator seeded 0). ``make_prefill_step``
             as a caller calls it (its default routes the scan through
             K7) on prompts (4, 2048) from seed 0 (K7 counts set to 0
             just before and read just after: one launch per layer), its
             last-position logits against the plain ``ssd_chunked`` path;
             ``launch.serve.serve_batch`` for 4 requests, prompt 16, gen
             16, called three times at one key (the pooled decode state
             and step: eager, a capture, a replay; captures 0, 1, 0 and
             the tokens the same bits; the third call timed), whose first
             tokens must equal ``make_prefill_step``'s on
             the same prompts (the chunked scan against the recurrence),
             logits close; prefill and decode times, the decode's device
             idle share and K7's share of a prefill's device time
             (torch.profiler). Every LM phase's timed ``serve_batch`` call
             replays the graphed serve step (two warm-up calls at its key
             before it: eager, then the capture), and ``decode_gate`` holds it
             against its eager step (7, 7b, 7d's deepseek and jamba, 7e's
             llama period and musicgen): tokens and the final decode
             state bitwise, each state in place, one capture; ms a step
             of each, the graphed step's elapsed ms from CUDA events,
             and each step's profiled busy time (torch.profiler traces
             the plain graph's replays) and idle share. 7b and 7d drain the
             ``ContinuousBatcher`` graphed and eager, request for request
             equal.
7b. attention lm — gemma3-12b at full width (12.77 B parameters, fp32,
             seeded weights, TF32 off), after phase 7 has freed
             mamba2-2.7b. First K3 at the prefill's shapes, "L" and "A",
             timed against its 3xTF32 bound (the visible (query, key)
             pairs), the plain version and SDPA. Then ``make_prefill_step``
             on a (1, 4096) prompt from seed 0 (K3 counts set to 0 just
             before and read just after: exactly 48, one a layer; the
             peak allocated memory), its last-position logits against the
             ``use_flash=False`` prefill within LM_LOGIT_TOL·max|logit|,
             the greedy token equal unless the top-2 gap is within that
             bound; ``serve_batch`` for 4 requests of 16 + 16 (ms a decode
             step; its first tokens against the prefill's, gap-gated); and
             ``serving.ContinuousBatcher``: 8 requests of mixed (prompt,
             gen) through 4 slots (steps, ``wasted_step_fraction``,
             tokens/s), each request's tokens equal to its solo
             ``serve_batch`` run, or differing first where the solo top-2
             gap is within the bound.
7c. diffusion lm — ``models.diffusion_lm`` on olmo-1b's backbone at full
             width (16 layers, d_model 2048, vocab 50,304; embed_dim 64;
             seeded, ``out_proj`` livened), VP, batch 4 × 64 tokens,
             adaptive at eps_rel 0.05 with the fused step: K1 counts set to
             0 just before and read just after, exactly 8·⌈iterations/8⌉
             host-driven (the iterations graphed, + a capture's warm-up);
             nfe = 2·(accepted + rejected) + 1, the sample finite, the
             tokens in range; then K1 timed at the solve's state (4, 4096)
             beside its bytes bound and its plain version.
7d. moe lm — the mixture-of-experts LMs, seeded, fp32, TF32 off, after
             the earlier phases have freed their memory (< 1 GiB still
             allocated, else it fails). First K3 at the three prefill
             shapes (causal fp32: (1, 16, 16, 4096, 128), (1, 24, 8, 4096,
             64), (1, 32, 8, 2048, 128)) and K7 at jamba's (1, 2048, 128,
             64, 1, 16), timed beside their bounds, the plain versions and
             SDPA. (a) deepseek-moe-16b at full width and depth
             (16,879,568,896 parameters, checked; init's peak allocated
             memory < 70 GiB): the (1, 4096) prefill through
             ``make_prefill_step`` with exactly 28 K3 launches, its
             last-position logits against the plain attention at
             LM_LOGIT_TOL (where they miss, the first differing routing
             decisions must be near ties, each margin printed), einsum
             against gather dispatch the same way, the prefill's device
             time split by torch.profiler (K3, expert products, dispatch
             and combine, router, rest); ``serve_batch`` 4 × (16 + 16),
             a decode step's device ms and idle share; the dropped share
             of routing decisions (capacity) in the prefill and in a
             decode step; ``ContinuousBatcher`` (8 requests, 4 slots)
             twice, the same tokens, and the tokens that differ from the
             requests' solo runs counted, not gated (capacity is shared
             by seatmates). (b) granite-moe-3b-a800m at full width: the
             (1, 4096) prefill, 32 K3 launches, against the plain path;
             ``serve_batch``. (c) jamba-v0.1-52b at full width, one
             8-layer period (7 "M", 1 "A", 4 "D", 4 "E"; the whole stack
             is 205.84 GB): the (1, 2048) prefill with 7 K7 and 1 K3
             launches against the plain SSD and attention;
             ``serve_batch``.
7e. vlm, audio, training — the last two architectures and LM training,
             seeded, fp32, TF32 off, < 1 GiB allocated before (else it
             fails). First K3 at their prefill shapes (causal fp32:
             (1, 64, 8, 4096, 128), GQA 8:1, and (4, 24, 24, 1500, 64), a
             ragged S) beside its bound, the plain version and SDPA.
             (a) llama-3.2-vision-90b at full width, its depth cut to one
             period (4 "A" + 1 "X", 6,378,577,920 parameters, checked; the
             100 layers fit across cards only), on seeded image embeddings
             (B, 1601, 7680), the reference's stubbed vision tower: the
             (1, 4096) prefill through ``make_prefill_step`` with exactly 4
             K3 launches (the "X" layer takes the plain path), its
             last-position logits against ``use_flash=False`` within
             LM_LOGIT_TOL·max|logit|, the greedy token equal unless the
             top-2 gap is within that bound; the peak allocated memory;
             ``serve_batch`` 4 × (16 + 16) with the embeddings: ms and
             device ms a decode step, the idle share. (b) musicgen-medium
             at full width and depth (1,384,418,304 parameters, checked):
             the (4, 1500, 4) prefill (30 s of audio at 50 frames a
             second) with exactly 48 K3 launches, the logits held the same
             way in each of the 4 codebooks; ``serve_batch`` on (4, 16, 4)
             prompts. (c) musicgen-medium trained through
             ``launch.train.train_loop``: 20 steps of 2 × 512 frames × 4
             codebooks (delay pattern), AdamW at lr 3e-4 (warmup_cosine):
             every cross-entropy finite, the last below the first, every
             parameter leaf moved; ms a step, the peak allocated memory;
             then one step under remat "full" against "none" from the same
             weights and batch: the loss within 1e-6 relative, the peak
             lower.
8. sharded — the fourth main path, data-parallel adaptive sampling
             (``sample(mesh=)`` over torch.distributed). First K4, the
             sharded solver step, in process at HIGHRES_DIT's state
             (8, 196,608), fp32 and bf16: ``sharded_error_step`` on each
             batch half (a one-rank mesh) bitwise equal to K1's rows, and
             its partial mode on 1, 2 and 4 column ranges (views, in
             place) with x'' bitwise equal to K1's columns, the sums
             against the plain ``ref.error_step_sums`` and, added in range
             order, e2 against K1's. Then
             ``python -m repro_torch.launch.sharded_selftest --device cuda
             --arch highres_dit`` as a subprocess at world 1 over NCCL (a
             real process group on the card; the HIGHRES_DIT solve sharded
             must equal the unsharded one bitwise; its K4 and flash launch
             counts are set to 0 just before the sharded solve and read
             just after) and at world 2 over gloo with both ranks on this
             card (NCCL refuses two ranks on one GPU): the closed-form
             checks bitwise, K4's feature combine, and the DiT solve
             finite, converged and within 4 NFE of the unsharded one per
             sample. The same selftest serves on the mesh (checks 3, 4
             and 6 of ``sharded_selftest``): the reference's sharded
             ``DiffusionBatcher`` check on the Gaussian (bitwise an
             unsharded batcher at horizon 1, per-device refill) and its
             device-resident twin (bitwise the host-driven mesh server,
             equal iterations, fewer reads; at world 2 over gloo, that
             asking for it raises: a gloo collective cannot be captured);
             then phase 6a's tiered HIGHRES_DIT serve (8 slots, 16
             requests over the tiers under EDF, horizon 4) on the mesh.
             World 1 (NCCL): host-driven and device-resident (the NCCL
             all-reduce captured in the WHILE node's body, P2 reading the
             agreed flags), each per request bitwise the unsharded serve,
             with K4 (per-row tolerances), K3, P1 and, device-resident, P2
             launches counted from 0 over the mesh serve, its reads,
             windows and walls; and EM at 59 steps from HIGHRES_DIT under
             ``mesh=`` (K5, 59 launches), bitwise the unsharded EM. World
             2 (gloo, host-driven): every request delivered finite, NFE
             within 4 of the unsharded serve per request, bitwise
             reported, the refills per rank. Last, K4's device time at
             (8, 196,608) and at a (8, 98,304) feature half, one NCCL
             all_reduce of 9 floats, and the sharded solve's wall times
             against the unsharded solve's, warm and in turns, and against
             phase 3's. The same two selftests run checks 7 and 8 (no
             further spawn): HIGHRES_DIT's forward pipelined over "pod"
             (batch 8, 4 microbatches; one stage of 12 layers at world 1,
             two of 6 at world 2), every rank's output bitwise the whole
             model's with its blocks run microbatch by microbatch, K3 48
             launches at world 1 and 24 a rank at world 2, the stage
             handoffs booked; at world 1 an adaptive solve through
             ``make_sample_step(forward_fn=pipelined)`` as ``sample(mesh=)``,
             finite, converged, within 4 NFE of the unpipelined solve, K4
             and K3 launched, and graphed (below); and its tensor-parallel
             forward at mesh 1x1 (bitwise) and 1x2 (6 of 12 heads a rank;
             within 1e-4·(1 + max) of the unsharded forward), K3 12
             launches a rank, its collectives by kind, and the same
             forward counted on meta tensors for that rank
             (``collectives.counting``) equal to those books, and at world
             1 a solve through it as check 7's. K3 is timed at their
             shapes, (2, 12, 256, 64) and (8, 6, 256, 64), beside its plain
             version, SDPA and the 3xTF32 bound. Check 9 (the graphed
             sharded solves): HIGHRES_DIT's ``sample(mesh=)`` adaptive at
             eps_rel 0.05, EM-60, PC-30 and the ODE at rtol 1e-3, each
             called three times under the one-shot rule. World 1 (NCCL):
             the first host-driven, the second captures (the flags'
             all-reduce, the RK45's error sum in the graph), the third
             replays; each graphed call bitwise the first (x, nfe,
             accepted, rejected, iterations), drivers built and captures
             0, 1, 0, at most 2 host reads (the branch's agreement and the
             window), the replay's K4, K3, K5 and P1 launches the first
             call's and P2 once a horizon plus one; the walls (host-driven,
             capturing, replayed) and each call's device span over its
             wall. Checks 7 and 8's world-1 solves are gated the same way.
             World 2 (gloo): the adaptive solve twice, host-driven (gloo
             collectives cannot be captured), its record saying so.
             Last, in process, the agreement that ends a horizon under a
             world-1 NCCL mesh (``MeshFlags.update``, captured and
             replayed, eager, and its all-reduce alone) timed with CUDA
             events (``benchmarks.loop_condition.mesh_flags_times``).
9. precision — the precision seams in bf16 at full width, after the LM
             phases have freed their memory (< 1 GiB held at its start and
             before each LM): (a) HIGHRES_DIT, batch 8, phase 3's seeded
             weights, through ``launch.sample.run`` under ``bf16`` and
             ``bf16_full``: finite, delivered in fp32, mean NFE ≤ 1.25×
             phase 3's, K1 8·⌈iterations/8⌉ host-driven, the iterations
             graphed (bf16 state under
             ``bf16_full``) and K3 12 a forward, TF32 off, the carry's x, t,
             h dtypes; a forward's device time under each preset and fp32;
             (b) the reference's analytic precision gate on the port's RNG
             (VP, VE × both presets: W2 ≤ 2 × fp32's + 3·s/√(B·D), mean NFE
             ≤ 1.25×); (c) phase 6a's tiered serve of 16 requests under
             ``bf16_full`` (K2 with bf16 state, K3 in bf16, P1): K2 one and
             K3 24 a body iteration, two requests served alone bitwise the
             mixed run's; K1/K2 with bf16 state, K3 at gemma3's "L" and "A"
             and K7 at (4, 2048, 80, 64, 1, 128) in bf16 timed beside their
             bounds, plain versions and SDPA; (d) gemma3-12b and (e)
             mamba2-2.7b in bf16 (``ModelConfig.dtype``): the prefill (K3 48
             / K7 64, in bf16), each of those calls held against its
             plain version on the inputs the model gave it (phase 2's
             bounds, element by element), its last-position logits
             against phases 7b's / 7's fp32 logits of the same seeded
             weights within 4·sqrt(2·layers)·2^-8·max|logit| with the same
             greedy token wherever the top-2 gap exceeds it, and beside
             the bf16 plain path's (a reading), the prefill's wall, device
             time by kernel and peak, serve_batch 4 × (16 + 16), a decode
             step's wall and device time, the idle share; (f) the share of
             the card's peak (bf16 989, fp32 67 TFLOP/s) reached by (a)'s
             forward and (d)'s and (e)'s prefills, bf16 and fp32: the dry
             run's FLOPs counted on meta tensors in the phase (K3's layers
             by their visible pairs) over the measured device time, the
             plain path's dense count beside it, each line with the card's
             name and power limit; a share above 1.05 fails.
10. LM mesh — the language models served under a ("data", "model")
             mesh (fp32, TF32 off, seed 0; ``run_lm_mesh``): gemma3-12b's
             6-layer period (5 "L" + 1 "A"; prefill (1, 4096), 16 greedy
             decode steps of 4), mamba2-2.7b's first 8 layers ((4, 2048),
             16 × 4), deepseek-moe-16b's first 2 layers and
             llama-3.2-vision-90b's 5-layer period ((1, 4096), 8 × 4); the
             depths of LM_MESH_RUNS: (a) each unsharded here, its record
             written, the model freed before any spawn; (b) world 1 over
             NCCL in this process (``run_world1``), mesh 1×1, every record
             bitwise the unsharded one; (c)
             world 2 over gloo, both ranks on this card, mesh 1×2, in one
             spawn that builds and frees the models in turn (gemma3-12b
             decoded again with ``decode_flash_shard="model"``), and (d)
             gemma3-12b at 12 layers on mesh 2×1 (rows split): logits
             within LM_LOGIT_TOL·max|logit| of the unsharded run's (teacher
             forced on its tokens), greedy tokens equal except below the
             top-2 gap, deepseek's prefill by ``hold_moe_logits``; K3 and
             K7 launched on every rank once a layer (gemma3 6, deepseek 2,
             llama 4, mamba2 K7 8); every rank's residual and tokens the
             same bits; every greedy pick over the rank's vocab columns
             (``collectives.vocab_parallel_argmax``, the steps' pick at
             1×2) bitwise the argmax of the gathered logits; the walls,
             collectives and bytes a prefill and a
             decode step, and the peaks a rank printed with the card; in
             (b), (c) and (d) every rank's count of the dry run's prefill
             and decode step (``specs.build_dryrun`` on meta tensors for
             its coordinate, ``sharded_selftest.meta_books``) equal to the
             real run's books, call for call and byte for byte. In (b)
             each model's serve step under the mesh
             (``make_serve_step(mesh=)``: a ``GraphedServeStep`` on NCCL)
             against its eager step over the decode's steps
             (``sharded_selftest.graphed_decode``): tokens and state
             bitwise, one capture, a replayed step's books equal to the
             dry run's meta count, ms a step of each.
             ``--only-lm-mesh`` runs the build and this phase alone and
             prints no result line.
11. training mesh — LM training under a ("data", "model") mesh (fp32,
             TF32 off, seed 0, the plain attention and SSD, AdamW at
             phase 7e's lr 3e-4; ``run_train_mesh``): (a) world 1 over
             NCCL in this process, mesh 1×1, musicgen-medium at 6 layers,
             ``train_loop`` 3 steps of 2 × 512 unsharded and under the
             mesh: every loss and the final parameters bitwise; (b) world
             2 over gloo, both ranks on this card, one spawn
             (``sharded_selftest --train-plan``, ``train_mesh_plan``):
             musicgen-medium at 6 layers on 1×2 "tp" and "tp" with remat
             "full", at 2 layers on 2×1 data parallel, "fsdp" and "zero1",
             3 steps each; gemma3-12b's 6-layer period, mamba2-2.7b's first 8
             layers and deepseek-moe-16b's first 2 one step each at 1×2;
             each rank trains the unsharded port first, the ranks at once,
             as the record: every gradient and new block
             within the CPU tests' bounds (2e-4·(1 + max|g|); the update's,
             or 2·lr where ill-conditioned), every step's loss within 1e-5
             relative, the clip scale the same bits on every rank, remat
             the same bits as "tp" with a lower peak, fsdp's and zero1's
             peak a rank below data parallelism's, K3 and K7 launched 0
             times, every rank's count of the dry run's train step of its
             layout on meta tensors equal to its first step's books ((a)
             has no collective to compare); at 1×2 the loss is the
             vocab-parallel cross-entropy
             (``collectives.vocab_parallel_cross_entropy``) and the first
             step books no all-gather (the logits are never gathered), its
             peak a rank printed beside the peak when they were
             (``TRAIN_MESH_GATHER_PEAK_GIB``); the walls, peaks,
             collectives and MB a step by kind printed with the card.
             ``--only-train-mesh`` runs the build
             and this phase alone and prints no result line.

The last lines are the card's name and power limit (nvidia-smi), one
JSON object naming each kernel, and ``{"ok": true, "device": ...}``.
"""

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
#: the script's start, for the total it prints
T0 = time.perf_counter()
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.analysis import roofline  # noqa: E402  (the port's package, from the checkout)

#: iteration cap of the main path's solve
MAIN_MAX_ITERS = 400
#: published H100 SXM peaks (``analysis/roofline.py``: NVIDIA data sheet,
#: dense, 700 W): HBM, fp32 on the CUDA cores, TF32 and bf16 on the tensor cores
HBM_BYTES_PER_S = roofline.HBM_BW
FP32_FLOPS = roofline.PEAK_FLOPS["float32"]
TF32_FLOPS = roofline.PEAK_FLOPS["tf32"]
BF16_FLOPS = roofline.PEAK_FLOPS["bfloat16"]
#: flops per element of the fused solver step (x̃ 6, x'' 2, δ 5, r² and sum 4)
STEP_FLOPS_PER_ELEMENT = 17
#: flops per element of GroupNorm → SiLU (sum 1; deviation² and sum 3;
#: normalise, affine 4; SiLU's exp, add, divide 3)
GN_FLOPS_PER_ELEMENT = 11
#: flops per element of K5, x' = c0·x + c1·s + c2·z (three products, two sums)
EM_FLOPS_PER_ELEMENT = 5
#: the planning path: batch, observation width, returns-CFG scale
PLAN_BATCH, PLAN_OBS, PLAN_CFG = 64, 17, 1.5
#: the closed-form Gaussian of the conformance gates
MU0, S00 = 0.3, 0.5
#: K7's shapes (B, S, H, P, G, N): mamba2-2.7b's prefill, a ragged S,
#: several groups, prefill_32k's sequence length, 8 heads over 5000
#: rows, which the wrapper splits into ranges (79 chunks, a ragged last one),
#: and jamba-v0.1-52b's "M" layers at d_state 16 (phase 7d)
SSD_SHAPES = [(4, 2048, 80, 64, 1, 128), (4, 1000, 80, 64, 1, 128),
              (1, 100, 8, 32, 2, 32), (1, 32768, 80, 64, 1, 128),
              (1, 5000, 8, 64, 1, 128), (1, 2048, 128, 64, 1, 16)]
#: the chunk of K7's yardstick (``ssd_work``), whatever chunk the kernel runs
SSD_WORK_CHUNK = 64
#: K7 against its plain version: each is within the reference's 3e-4 of the
#: sequential oracle (tests/test_kernels_ssd.py) and they chunk differently
SSD_TOL = 6e-4
#: phase 10, the LMs under a ("data", "model") mesh: (arch, layers (None: all), prefill
#: (B, S), decode (B, steps)); each also decoded with decode_flash_shard="model"
#: where the last field is set. gemma3-12b runs one period (5 "L" + 1 "A") and
#: mamba2-2.7b its first 8 layers: whole (48 and 64 layers) the phase took
#: 130.9-148.3 s of a 946.5 s run (an H100 80GB HBM3 at 700 W), 101.6 s of it
#: the world-2 gloo spawn
#: (gemma3's 1x2 prefill 10.7 s and flash-decode 14.8 s a rank, each collective
#: staged through the host), so the depth is cut to make room for phase 3b, and
#: deepseek-moe-16b's from 4 layers to 2 ("A" + "E" each)
LM_MESH_RUNS = (("gemma3-12b", 6, (1, 4096), (4, 16), True),
                ("mamba2-2.7b", 8, (4, 2048), (4, 16), False),
                ("deepseek-moe-16b", 2, (1, 4096), (4, 8), False),
                ("llama-3.2-vision-90b", 5, (1, 4096), (4, 8), False))
#: phase 10 (d): gemma3-12b with the rows split over "data", mesh (2, 1), cut to 12
#: layers (two whole replicas, 2 x 51 GB, do not fit one card)
LM_ROWS_RUN = ("gemma3-12b", 12, (2, 1024), (4, 16), False)
#: seconds the phase-10 selftests may take
LM_MESH_TIMEOUT_S = 420
#: the LM phase: prefill prompts, (requests, prompt, gen) of serve_batch,
#: decode steps of the idle-share measurement
LM_PREFILL = (4, 2048)
LM_SERVE = (4, 16, 16)
LM_IDLE_STEPS = 8
#: logits of two fp32 paths through 64 layers that sum in another order
#: (K7 against ssd_chunked; the recurrence against the chunked scan),
#: relative to the largest logit
LM_LOGIT_TOL = 1e-3
#: K4's e2 from column ranges' sums against K1's on the whole state: the
#: same tile sums, added in another grouping
K4_E2_RTOL = 1e-6
#: what the solver step's plain version (K1, K4) computes: its x-tilde
#: rounds as the kernel's fused multiply-adds, which it emulates in fp64,
#: so its time is not comparable with an all-fp32 formulation's
PLAIN_STEP = "ref.py, x-tilde as three fused multiply-adds emulated in fp64"
#: seconds one run of the sharded selftest may take
SELFTEST_TIMEOUT_S = 300
#: K3's shapes in phase 8's checks 7 and 8 of HIGHRES_DIT (B, Hq, Hkv, S, Dh): a
#: microbatch of 2 of the pipelined forward (batch 8, 4 microbatches) and a
#: rank's 6 of 12 heads at mesh 1x2
PIPE_ATTN = (2, 12, 12, 256, 64)
TP_ATTN = (8, 6, 6, 256, 64)
#: the training phase: DIT_100M's training steps and batch
DIT_STEPS, DIT_BATCH = 20, 32
#: the reference's Table 1 on the CPU (``PYTHONPATH=src python -m
#: benchmarks.table1_solver_grid``, N 4096, key 42): adaptive mean NFE by
#: eps_rel, and w2_gaussianized of adaptive and of EM at the matched NFE
#: at eps_rel 0.05 (PERF.md §6)
REF_TABLE1_NFE = {"vp": {0.01: 278.66, 0.02: 184.18, 0.05: 98.65, 0.1: 61.58, 0.5: 19.75},
                  "ve": {0.01: 348.92, 0.02: 219.61, 0.05: 118.33, 0.1: 74.81, 0.5: 28.93}}
REF_TABLE1_W2G = {"vp": (0.5384, 0.3641), "ve": (1.2221, 0.1476)}
#: gate (d): the port's adaptive mean NFE within this share of the
#: reference's (other nets and draws: the RNGs differ; the port's own CPU
#: run lands within 3.2 % of it)
NFE_BAND = 0.15
#: the serving phase: slots, sync horizon, requests (cycling the tiers),
#: telemetry ring capacity, each request's deadline, the requests also
#: served alone
SERVE_SLOTS, SERVE_HORIZON, SERVE_REQUESTS = 8, 4, 16
SERVE_TELEMETRY, SERVE_DEADLINE_MS, SERVE_SOLO = 4096, 4000.0, (0, 2)
SERVE_TIERS = ("draft", "standard", "high_fidelity")
#: P1 against its plain version, times (1 + |z|): both round each add and
#: product once; logf, sqrtf, sinf and cosf differ from torch's by an ulp or two
P1_TOL = 2e-6
#: P1's shapes in phase 2: the DiT state, planning's, Table 1's, a ragged row,
#: and the served states of phases 6d and 6e (the zoo's 8 slots of 3072, the
#: closed loop's 16 slots of 32 · 24, the OU service's 4 slots of 8 · 4)
P1_SHAPES = ((8, 196_608), (64, 736), (4096, 2), (5, 7), (8, 3072), (16, 768), (4, 32))
#: operations per element of P1: a quarter of a Philox4x32-10 call (ten
#: rounds of two 32-bit multiplies, their high halves, three xors and two
#: key adds) and half of a Box–Muller pair (log, sqrt, sin, cos, four products)
P1_OPS_PER_ELEMENT = 32
#: P2's hand-built (occupied, done) masks in phase 2: rows running, one
#: occupied row done (an event under compaction), every row done, no slot
#: occupied, a running row beside idle slots (unoccupied, done), and an
#: idle slot not done (the inner condition reads every row)
P2_MASKS = (([1, 1, 0, 1], [0, 0, 1, 0]), ([1, 1, 0, 1], [1, 0, 1, 0]),
            ([1, 1, 0, 1], [1, 1, 1, 1]), ([0, 0, 0, 0], [1, 1, 1, 1]),
            ([1, 0, 0, 0, 0, 0, 0, 0], [0, 1, 1, 1, 1, 1, 1, 1]),
            ([1, 1, 0, 0], [1, 1, 0, 1]))
#: P2's hand-built loop state in phase 2: the carry's iterations (below,
#: then at the budget: spent mid-horizon), the units a horizon holds, the
#: budget and the horizons a window may run, and the evaluations in a row
#: (the first before any unit, then one after each of four units: the
#: horizon ends by its length after two)
P2_ITERATIONS, P2_HORIZON, P2_MAX_ITERS, P2_MAX_HORIZONS, P2_STEPS = (0, 3), 2, 3, 3, 5
#: K1 and K3 past one launch's 65,535 rows (gridDim.y): B 70,000 of
#: Table 1's width; B·Hq 70,000
K1_BIG, K3_BIG = (70_000, 2), (17_500, 4, 8, 32)
#: the zoo's served families: state width (CIFAR's), slots, requests
ZOO_SERVE_D, ZOO_SERVE_SLOTS, ZOO_SERVE_REQUESTS = 3072, 8, 12
#: planning served at TRAJ_UNET's width: PointMassEnv's dim (obs 2·dim + act
#: dim = 24 columns for TRAJ_UNET's 23), slots, environments, control rounds
PLAN_SERVE_DIM, PLAN_SERVE_SLOTS, PLAN_SERVE_ENVS, PLAN_SERVE_ROUNDS = 8, 16, 32, 3
#: the solver-step states of phases 6d and 6e, (rows, columns): the
#: selection race (solver_select's BATCH x DIM), the closed loop at
#: TRAJ_UNET's width (slots x horizon 32 · 24 columns) and the OU service
#: at the reference's defaults (4 slots x horizon 8 · 4 columns)
SERVED_STEP_SHAPES = ((512, 8), (PLAN_SERVE_SLOTS, 32 * 3 * PLAN_SERVE_DIM), (4, 8 * 4))
#: the reference's bench workload (benchmarks/bench_device_serving.py)
REQUESTS_PER_SLOT = 3
#: K3 in fp32 against its plain version, times (1 + max|out|): online
#: against two-pass softmax, sums in another order (bf16: ``attn_share``)
ATTN_TOL = {torch.float32: 3e-5}
#: K3's key tile in bf16 at head_dim 256: a mask this many keys off is the
#: fault phase 2's bf16 bound must see
K3_BF16_TILE_256 = 32
#: the attention LM phase (7b): gemma3-12b's prefill (B, S) and its K3 shape
#: (B, Hq, Hkv, S, D), the "L" layers' window; serve_batch's (requests,
#: prompt, gen); the continuous batcher's slots, cache and (prompt, gen) a
#: request
GEMMA_PREFILL = (1, 4096)
GEMMA_ATTN = (1, 16, 8, 4096, 256)
GEMMA_WINDOW = 1024
GEMMA_SERVE = (4, 16, 16)
BATCHER_SLOTS, BATCHER_CACHE = 4, 128
BATCHER_REQUESTS = ((5, 12), (16, 4), (9, 9), (3, 16), (12, 6), (7, 10), (14, 3), (4, 8))
#: the diffusion LM (phase 7c) on olmo-1b's backbone: (batch, tokens,
#: embed_dim) and eps_rel; the solver state is (batch, tokens · embed_dim)
DLM_SHAPE, DLM_EPS_REL = (4, 64, 64), 0.05
#: the mixture-of-experts LMs (phase 7d): each one's prefill (B, S) (jamba's
#: cut with its depth), serve_batch's (requests, prompt, gen)
MOE_PREFILL = {"deepseek-moe-16b": (1, 4096), "granite-moe-3b-a800m": (1, 4096),
               "jamba-v0.1-52b": (1, 2048)}
MOE_SERVE = (4, 16, 16)
#: deepseek-moe-16b's parameters (the reference's ``init_model``, counted
#: with ``jax.eval_shape``), and the peak allocated memory its init may reach
DEEPSEEK_PARAMS = 16_879_568_896
INIT_PEAK_GIB = 70
#: a routing decision that two fp32 paths make differently must be a near
#: tie: a top-k margin below this share of the token's largest probability
NEAR_TIE = 1e-4
#: phase 7e: llama-3.2-vision-90b cut to one period (4 "A" + 1 "X") and
#: musicgen-medium whole: their parameters (the reference's ``init_model``,
#: counted with ``jax.eval_shape``), prefills (B, S) (musicgen's 30 s of
#: audio at EnCodec's 50 frames a second, arXiv:2306.05284), serve_batch's
#: (requests, prompt, gen); musicgen's training run: steps, batch, frames,
#: peak learning rate
VLM_PARAMS, MUSICGEN_PARAMS = 6_378_577_920, 1_384_418_304
VLM_PREFILL, MUSICGEN_PREFILL = (1, 4096), (4, 1500)
VLM_AUDIO_SERVE = (4, 16, 16)
MUSICGEN_TRAIN = dict(steps=20, batch=2, seq=512, lr=3e-4)
#: phase 11, LM training under a ("data", "model") mesh: musicgen-medium at full
#: width, steps of (batch, seq) at phase 7e's lr (constant in the world-2 runs)
TRAIN_MESH_ARCH, TRAIN_MESH_STEPS, TRAIN_MESH_SHAPE, TRAIN_MESH_LR = (
    "musicgen-medium", 3, (2, 512), MUSICGEN_TRAIN["lr"])
#: the depths of phase 11's world-2 musicgen runs (of its 48 layers): the 1×2
#: "tp" runs, and the 2×1 runs (data parallel, fsdp, zero1). Every collective of
#: a world-2 run is staged through the host by gloo (0.74-0.83 GB/s a rank in
#: phase 10) and every unsharded record through host memory, so the phase's
#: wall grows with depth: at 48 and 12 layers it took 157-243 s of the script's
#: 1200 (whole runs 884-1091 s), at 24 and 4 120.5 s of a 901 s run (the
#: 24-layer "tp" runs 27.3 and 12.7 s of it, their unsharded record 7.3 s), so
#: the "tp" runs were cut to 12 layers to make room for phases 8 and 10's graphs;
#: at 12 layers they took 19.4 and 6.9 s of a 100.5 s phase (the same card), and
#: they are cut to 6 to make room for phase 3b, the 2×1 runs from 4 layers (4.5-8.1
#: s each) to 2, and the world-1 train_loop from all 48 layers to the "tp" depth
TRAIN_MESH_TP_LAYERS, TRAIN_MESH_DATA_LAYERS = 6, 2
#: phase 11's other mixers at full width, one step at 1×2: (arch, layers); gemma3's
#: one period of 5 "L" and an "A", mamba2's first 8 "M" layers, deepseek's first 2
#: ("A" + "E", 64 experts, 32 a rank; at 4 layers its run took 12.9 s, 6.6 s of it
#: each rank's unsharded record)
TRAIN_MESH_MIXERS = (("gemma3-12b", 6), ("mamba2-2.7b", 8), ("deepseek-moe-16b", 2))
#: seconds each phase-11 selftest may take
TRAIN_MESH_TIMEOUT_S = 360
#: the peak allocated GiB a rank of phase 11's 1×2 runs (arch, layers, remat)
#: when the train step still gathered the logits over "model" (the version
#: of this script before the vocab-parallel loss, on an H100 80GB HBM3 at
#: 700 W), printed beside the vocab-parallel loss's peak, for the runs whose
#: depth has one
TRAIN_MESH_GATHER_PEAK_GIB = {("gemma3-12b", 6, "none"): 25.22,
                              ("mamba2-2.7b", 8, "none"): 6.53}
#: one train step under remat "full" against "none": the same products on
#: the same inputs, so the same loss up to this relative difference
REMAT_LOSS_RTOL = 1e-6

#: phase 3b, controlled generation from HIGHRES_DIT: the classifier-free
#: guidance scale; the served drains' slots and requests, and the requests
#: also served alone (GUIDED_SOLO)
GUIDED_CFG = 1.5
GUIDED_SERVE_SLOTS, GUIDED_SERVE_REQUESTS, GUIDED_SOLO = 8, 12, (0, 5, 11)
#: K3's shape in CFG's forward of HIGHRES_DIT at batch 8, (2·8, Hq, Hkv, S, Dh)
CFG_ATTN = (16, 12, 12, 256, 64)

#: phase 4b's graphed baselines from HIGHRES_DIT (batch 8): (name, method,
#: kwargs), each about 60 evaluations (VP grids of more than β_max = 20
#: steps: below it the discrete β_i passes 1 and the PC predictor is NaN);
#: the ODE loosened and capped so that its four solves stay a few seconds
GRAPHED_BASELINES = (("EM-60", "em", dict(n_steps=60)), ("DDIM-60", "ddim", dict(n_steps=60)),
                     ("PC-30", "pc", dict(n_steps=30)),
                     ("PC-HMC-21", "pc_hmc", dict(n_steps=21, hmc_leapfrog=2)),
                     ("ODE", "ode", dict(rtol=1e-3, atol=1e-3, max_iters=40)))
#: phase 9: the bf16 presets the port runs end to end, the NFE they may
#: spend against fp32's (the reference's precision gate), the bf16 LM
#: bound's constant (4 standard deviations of the largest of V logits'
#: rounding errors: c·sqrt(2·layers)·2^-8 of max|logit|, two rounded
#: residual updates a layer), and the share of the peak a count may reach
#: before it is taken as wrong
PRESETS_BF16 = ("bf16", "bf16_full")
PRECISION_NFE_RATIO = 1.25
BF16_LOGIT_C = 4.0
MAX_SHARE = 1.05

def ulp(dtype, mag: float) -> float:
    """One ulp of ``dtype`` at magnitude ``mag`` (fp32: 23 fraction bits,
    bf16: 7)."""
    bits = 23 if dtype == torch.float32 else 7
    return 2.0 ** (math.floor(math.log2(max(mag, 1e-30))) - bits)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: (name, seconds) of every phase that ended, in order
PHASE_SECONDS: list = []
_current_phase: list = []


def phase(name: str | None) -> None:
    """Start phase ``name``, ending the one before: its seconds are printed
    and kept in ``PHASE_SECONDS``."""
    now = time.perf_counter()
    if _current_phase:
        prev, t0 = _current_phase.pop()
        PHASE_SECONDS.append((prev, now - t0))
        print(f"  ({now - t0:.1f} s)", flush=True)
    if name is not None:
        _current_phase.append((name, now))
        print(f"== {name}", flush=True)


def held_below_1gib(dev, what: str) -> None:
    """Fail unless less than 1 GiB is still allocated when ``what`` starts.
    cuBLAS keeps a workspace for each (handle, stream) in the caching
    allocator, and every timing captured on a side stream
    (``device_ms``) leaves one behind: they are freed first, since the
    next GEMM on a stream allocates its workspace again. The graph cache
    (``core.solvers.adaptive.graph_driver``) holds its score functions
    weakly, so the drivers of earlier phases' score nets, their graphs
    and their pools went with those nets; the cycle collector runs
    first, for nets held in reference cycles, and the drivers still
    cached are counted."""
    from repro_torch.core.solvers import adaptive as ad

    gc.collect()
    before = torch.cuda.memory_allocated(dev) / 2 ** 30
    torch._C._cuda_clearCublasWorkspaces()
    held = torch.cuda.memory_allocated(dev) / 2 ** 30
    print(f"  allocated before {what}: {held:.3f} GiB ({before:.3f} GiB with cuBLAS's "
          f"workspaces; {len(ad._drivers)} graph drivers cached)")
    if held >= 1:
        fail(f"{held:.2f} GiB still allocated from earlier phases (want < 1 GiB)")


def timed_ms(fn, sets, reps: int) -> float:
    """Mean ms per call of an eager loop of ``reps`` calls, between two
    CUDA events: device time plus any gap the host leaves between
    launches. Rotates through ``sets`` of inputs."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, sets, reps: int = 40, replays: int = 5) -> float:
    """Mean device ms per call: ``reps`` calls captured in one CUDA graph
    and replayed, rotating through ``sets`` of inputs
    (``repro_torch.benchmarks.kernel_times.device_ms``, imported once
    ``main`` has put the repository's ``src`` on the path)."""
    from repro_torch.benchmarks import kernel_times
    return kernel_times.device_ms(fn, sets, reps, replays)


def flash_build_summary(log: str) -> None:
    """K3's instantiations as ptxas built them (registers, spills) with the
    dynamic shared memory and launch shape the library reports for S = 256."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    if not log:
        print("  flash_fwd_kernel: no ptxas log (the library was built before this run)")
        return
    lib = _build.library()
    cur = None
    for line in log.splitlines() + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in line:
            if cur:
                dtype, dp = cur["dtype"], cur["dp"]
                w, keys, smem = (ctypes.c_int() for _ in range(3))
                lib.flash_attention_config(256, dp, int(dtype == "bf16"), ctypes.byref(w),
                                           ctypes.byref(keys), ctypes.byref(smem))
                print(f"  flash_fwd_kernel<{dtype}, {dp}>: {cur['regs']} registers, spill "
                      f"stores/loads {cur['st']}/{cur['ld']} bytes, {smem.value:,} bytes of "
                      f"dynamic shared memory ({w.value} warps, {keys.value}-key tiles)")
            m = re.search(r"flash_fwd_kernelI(13__nv_bfloat16|f)Li(\d+)E", line)
            cur = m and {"dtype": "fp32" if m[1] == "f" else "bf16", "dp": int(m[2]),
                         "regs": "?", "st": 0, "ld": 0}
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["st"], cur["ld"] = max(cur["st"], int(m[1])), max(cur["ld"], int(m[2]))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            cur["regs"] = int(m[1])


def ssd_build_summary(log: str) -> None:
    """K7's kernels as ptxas built them (registers, spills) with the
    dynamic shared memory and blocks an SM holds that the library reports."""
    import re

    from repro_torch.kernels.ssd import ops as ssd_ops
    if not log:
        print("  ssd_scan: no ptxas log (the library was built before this run)")
        return
    cfg = {dt: ssd_ops.kernel_config(torch.cuda.current_device(), code)
           for dt, code in (("fp32", 0), ("bf16", 1))}
    cur = None
    for line in log.splitlines() + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in line:
            if cur:
                c = cfg[cur["dtype"]]
                smem = {"cb": c["smem_cb"], "pass 1": c["smem_states"],
                        "pass 3": c["smem_chunks"]}[cur["kind"]]
                per_sm = {"cb": "", "pass 1": f", {c['states_per_sm']} blocks an SM",
                          "pass 3": f", {c['chunks_per_sm']} blocks an SM"}[cur["kind"]]
                print(f"  ssd_scan {cur['kind']} ({cur['name']}, {cur['dtype']}): {cur['regs']} "
                      f"registers, spill stores/loads {cur['st']}/{cur['ld']} bytes, {smem:,} "
                      f"bytes of dynamic shared memory{per_sm}")
            m = re.search(r"(ssd_scan_cb|ssd_scan_chunks)I(13__nv_bfloat16|f)(Lb[01])?E", line)
            cur = m and {"name": m[1], "dtype": "fp32" if m[2] == "f" else "bf16",
                         "kind": "cb" if m[1] == "ssd_scan_cb" else
                         ("pass 3" if m[3] == "Lb1" else "pass 1"),
                         "regs": "?", "st": 0, "ld": 0}
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["st"], cur["ld"] = max(cur["st"], int(m[1])), max(cur["ld"], int(m[2]))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            cur["regs"] = int(m[1])


def small_kernels_build_summary(log: str) -> list:
    """K6's, K1's and K5's kernels as ptxas built them: registers, spills
    and static shared memory of each instantiation (printed, and returned
    for the kernels line)."""
    import re

    if not log:
        print("  gn_silu_*, error_step_kernel, em_step_kernel: no ptxas log (the library was "
              "built before this run)")
        return []
    rows, cur = [], None
    for line in log.splitlines() + ["Compiling entry function 'end'"]:
        if "Compiling entry function" in line:
            if cur:
                rows.append(cur)
            m = re.search(r"(gn_silu_regs|gn_silu_block|error_step_kernel)"
                          r"I(13__nv_bfloat16|f)(?:Li(\d+)E)?E", line)
            cur = m and {"kernel": m[1] + (f"<{'fp32' if m[2] == 'f' else 'bf16'}"
                                           + (f", {m[3]}>" if m[3] else ">")),
                         "registers": None, "spill_bytes": 0, "smem_bytes": 0}
            if (k5 := re.search(r"em_step_kernelI(13__nv_bfloat16|f)([jx])Lb([01])E", line)):
                cur = {"kernel": f"em_step_kernel<{'fp32' if k5[1] == 'f' else 'bf16'}, "
                                 f"{'32' if k5[2] == 'j' else '64'}-bit index, "
                                 f"{'evict-first' if k5[3] == '1' else 'plain'}>",
                       "registers": None, "spill_bytes": 0, "smem_bytes": 0}
        elif cur and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_bytes"] = max(cur["spill_bytes"], int(m[1]), int(m[2]))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m[1])
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s[1]) if s else 0
    for r in rows:
        extra = " (+ the slab, H·C/g·4 bytes, dynamic)" if "block" in r["kernel"] else ""
        print(f"  {r['kernel']}: {r['registers']} registers, {r['spill_bytes']} bytes of "
              f"spills, {r['smem_bytes']} bytes of static shared memory{extra}")
    return rows


def check_solver_step_edges(dev, gen) -> dict:
    """Phase 2's K1 checks beyond the DiT shape: planning's (64, 736), B = 1,
    two tiles a row (3073) and the trained DIT_100M's sample state (8, 3072)
    in fp32 and bf16, and in fp32 the zoo's and the planning service's
    states (phases 6d and 6e: the selection race's (512, 8), the served
    closed loop's (16, 768), the OU service's (4, 32)), within the bounds
    and the same bits twice;
    operands off 16 bytes (single-element loads) bitwise equal to aligned
    copies; a row's bits at B = 64 equal to any sub-batch's; one CUDA kernel
    a call (the kernel nodes of a captured graph of 8 calls; torch.profiler's
    trace of 8 eager calls may hold no more, nor any other kernel); the eager
    bits on every replay of a captured CUDA graph. Returns the CUDA kernels a
    call at each shape."""
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref

    def inputs(b, d, dtype=torch.float32):
        states = [torch.randn(b, d, generator=gen, device=dev).to(dtype) for _ in range(5)]
        coeffs = [torch.rand(b, generator=gen, device=dev) for _ in range(3)]
        eps = (torch.rand(b, generator=gen, device=dev) * 0.1 + 1e-3,
               torch.rand(b, generator=gen, device=dev) * 0.5 + 0.01)
        return states, coeffs, eps

    def step(states, coeffs, eps):
        return step_ops.error_step(*states, *coeffs, eps_abs=eps[0], eps_rel=eps[1])

    per_call = {}
    served = [(b, d, torch.float32) for b, d in SERVED_STEP_SHAPES]
    served.append((DLM_SHAPE[0], DLM_SHAPE[1] * DLM_SHAPE[2], torch.float32))  # phase 7c
    for (b, d, dtype) in ((64, 736, torch.float32), (64, 736, torch.bfloat16),
                          (1, 196_608, torch.float32), (3, 3_073, torch.float32),
                          (8, 3_072, torch.float32), (8, 3_072, torch.bfloat16), *served):
        states, coeffs, eps = inputs(b, d, dtype)
        xh, e2 = step(states, coeffs, eps)
        again = step(states, coeffs, eps)
        xr, e2r = step_ref.error_step(*states, *coeffs, *eps)
        views = []
        for t in states:
            views.append(torch.empty(b * d + 1, dtype=dtype, device=dev)[1:].view(b, d))
            views[-1].copy_(t)
        vx, ve = step(views, coeffs, eps)
        torch.cuda.synchronize()
        x_err = (xh.float() - xr.float()).abs().max().item()
        x_bound = (1e-5 if dtype == torch.float32 else 1e-2) * (1 + xr.float().abs().max().item())
        e_rel = ((e2 - e2r).abs() / e2r.abs()).max().item()
        same = torch.equal(again[0], xh) and torch.equal(again[1], e2)
        unaligned = torch.equal(vx, xh) and torch.equal(ve, e2)
        ok = x_err <= x_bound and e_rel <= 1e-5 and same and unaligned
        cfg = step_ops.kernel_config(b, d, d, dtype, True)
        print(f"  solver_step {str(dtype)[6:]:8s} {(b, d)} ({cfg['tiles']} tile(s) a row, "
              f"{cfg['design']}): max|x''-plain| {x_err:.3e} (bound {x_bound:.1e}), max rel e2 "
              f"{e_rel:.3e} (bound 1e-5), same bits twice {same}, off 16 bytes (single-"
              f"element loads) bitwise the aligned call's {unaligned} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("solver_step kernel disagrees with its plain version or itself")
    for b, d in ((64, 736), (64, 4_999), (64, 196_608)):
        states, coeffs, eps = inputs(b, d)
        xh, e2 = step(states, coeffs, eps)
        for rows in (slice(0, 1), slice(5, 6), slice(3, 40), slice(1, 64)):
            for copy in (False, True):
                part = [t[rows].contiguous() if copy else t[rows] for t in states]
                bx, be = step(part, [c[rows] for c in coeffs], [e[rows] for e in eps])
                if not (torch.equal(bx, xh[rows]) and torch.equal(be, e2[rows])):
                    fail(f"solver_step at D={d}: rows {rows} alone give other bits than at B=64")
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(states, coeffs, eps)
        torch.cuda.current_stream().wait_stream(side)
        # the CUDA kernels of 8 calls, read from a graph that captured them
        # (every node it holds), then from torch.profiler, whose CUPTI
        # trace may lose records: it fails only on a kernel too many or
        # one of another name
        held = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(held):
            [step(states, coeffs, eps) for _ in range(8)]
        nodes = graph_nodes(held)
        del held
        kernels = {n: c for n, c in nodes.items() if n != "other nodes"}
        per_call[f"{b}x{d}"] = sum(kernels.values()) / 8
        if (per_call[f"{b}x{d}"] != 1 or "other nodes" in nodes
                or not all("error_step_kernel" in n for n in kernels)):
            fail(f"solver_step at {(b, d)}: a graph of 8 calls holds {nodes}, "
                 f"not 8 error_step_kernel")
        names, _ = profile_device(lambda: [step(states, coeffs, eps) for _ in range(8)])
        traced = {n: c for n, (c, _) in names.items()
                  if "memcpy" not in n.lower() and "memset" not in n.lower()}
        if sum(traced.values()) > 8 or not all("error_step_kernel" in n for n in traced):
            fail(f"solver_step at {(b, d)}: the profiled 8 calls ran {traced}")
        if sum(traced.values()) < 8:
            print(f"  solver_step at {(b, d)}: the profiler's trace holds "
                  f"{sum(traced.values())} of the 8 calls' kernel records (CUPTI lost the rest)")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [step(states, coeffs, eps) for _ in range(3)]
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(o[0], xh) and torch.equal(o[1], e2) for o in outs):
                fail(f"solver_step at {(b, d)} in a replayed CUDA graph differs from eager")
        del graph, outs
    print(f"  solver_step at B = 64: every sub-batch (views and copies) gives its rows' bits "
          f"at D = 736, 4999, 196,608; CUDA kernels a call (graph nodes) {per_call}; a captured "
          f"graph of 3 calls gives the eager bits on 3 replays")
    return per_call


def check_k1_bf16_state(dev, gen, B: int, D: int) -> float:
    """K1 and K2 with bf16 state, the dtype ``bf16_full`` gives x and
    x_prev (phase 9), at the DiT state (B, D) and the precision gate's
    (512, 8), with a scalar ε and with ε per row: against the plain
    version at phase 2's bf16 bound, the same bits on a second call, and
    operands 2 bytes off a 16-byte boundary (element loads) bitwise the
    aligned call, the fp32 error sums included. Returns the max abs error
    of x'' at (B, D), scalar ε."""
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref

    worst = None
    for b, d in ((B, D), (512, 8)):
        states = [torch.randn(b, d, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(5)]
        coeffs = [torch.rand(b, generator=gen, device=dev) for _ in range(3)]
        views = []
        for t in states:  # contiguous, one bf16 element off a 16-byte boundary
            views.append(torch.empty(b * d + 1, dtype=torch.bfloat16, device=dev)[1:].view(b, d))
            views[-1].copy_(t)
        for vector in (False, True):
            if vector:
                ea = torch.rand(b, generator=gen, device=dev) * 0.1 + 1e-3
                er = torch.rand(b, generator=gen, device=dev) * 0.5 + 0.01
            else:
                ea, er = 0.0078, 0.05
            before = step_ops.launches
            xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
            xh2, e22 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
            xo, eo = step_ops.error_step(*views, *coeffs, eps_abs=ea, eps_rel=er)
            xr, e2r = step_ref.error_step(*states, *coeffs,
                                          step_ops.per_sample_tolerance(ea, b, dev),
                                          step_ops.per_sample_tolerance(er, b, dev))
            torch.cuda.synchronize()
            x_err = (xh.float() - xr.float()).abs().max().item()
            x_bound = 1e-2 * (1 + xr.float().abs().max().item())
            e_rel = ((e2 - e2r).abs() / e2r.abs()).max().item()
            twice = torch.equal(xh, xh2) and torch.equal(e2, e22)
            off = torch.equal(xo, xh) and torch.equal(eo, e2)
            loads = (step_ops.kernel_config(b, d, d, torch.bfloat16, True)["load_bytes"],
                     step_ops.kernel_config(b, d, d, torch.bfloat16, False)["load_bytes"])
            ok = (x_err <= x_bound and e_rel <= 1e-5 and twice and off
                  and xh.dtype == torch.bfloat16 and e2.dtype == torch.float32
                  and step_ops.launches == before + 3)
            print(f"  solver_step bf16 state {(b, d)} {'vector' if vector else 'scalar'} eps: "
                  f"max|x''-plain| {x_err:.3e} (bound {x_bound:.1e}), max rel e2 {e_rel:.3e} "
                  f"(bound 1e-5; e2 {str(e2.dtype)[6:]}), same bits twice {twice}, off 16 "
                  f"bytes bitwise the aligned call {off} ({loads[0]}- and {loads[1]}-byte "
                  f"loads) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail("solver_step with bf16 state disagrees with its plain version, itself "
                     "or its unaligned call")
            if worst is None:
                worst = x_err
    return worst


def check_k2_tiers(dev, gen, D: int) -> float:
    """Phase 2's K2 check: the solver step with ε per row at the DiT's state
    (8, D) fp32, the rows cycling the tiers' ε_rel (draft 0.5, standard 0.05,
    high_fidelity 0.01) at the VP SDE's ε_abs, as a tiered serve calls it.
    Within K1's bounds of the plain version (x'' 1e-5·(1 + max|x''|), e2
    1e-5 relative), the same bits on a second call, and each row bitwise the
    same row of a call at that row's ε for every row. Returns max|x''-plain|."""
    from repro_torch.configs.diffusion import TOLERANCE_CLASSES
    from repro_torch.core.sde import VPSDE
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref

    B = 8
    tiers = [TOLERANCE_CLASSES[n].eps_rel for n in SERVE_TIERS]
    rel = torch.tensor([tiers[i % 3] for i in range(B)], device=dev)
    atol = torch.full((B,), VPSDE().abs_tolerance, device=dev)
    states = [torch.randn(B, D, generator=gen, device=dev) for _ in range(5)]
    coeffs = [torch.rand(B, generator=gen, device=dev) for _ in range(3)]
    xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=atol, eps_rel=rel)
    again = step_ops.error_step(*states, *coeffs, eps_abs=atol, eps_rel=rel)
    xr, e2r = step_ref.error_step(*states, *coeffs, atol, rel)
    uniform_same = True
    for eps in tiers:
        ux, ue = step_ops.error_step(*states, *coeffs, eps_abs=atol, eps_rel=eps)
        rows = rel == eps
        uniform_same &= torch.equal(ux[rows], xh[rows]) and torch.equal(ue[rows], e2[rows])
    torch.cuda.synchronize()
    x_err = (xh - xr).abs().max().item()
    x_bound = 1e-5 * (1 + xr.abs().max().item())
    e_rel = ((e2 - e2r).abs() / e2r.abs()).max().item()
    same = torch.equal(again[0], xh) and torch.equal(again[1], e2)
    ok = x_err <= x_bound and e_rel <= 1e-5 and same and uniform_same
    print(f"  solver_step K2 (8, {D}) fp32, eps_rel per row {[round(e, 2) for e in tiers]} "
          f"cycling, eps_abs {VPSDE().abs_tolerance}: max|x''-plain| {x_err:.3e} (bound "
          f"{x_bound:.1e}), max rel e2 {e_rel:.3e} (bound 1e-5), same bits twice {same}, each "
          f"row bitwise its uniform-eps call's {uniform_same} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("K2 with per-row tolerances disagrees with its plain version or with K1")
    return x_err


def run_serve(dev, card: str) -> dict:
    """Phase 6a, the serving path: ``serving.DiffusionBatcher`` on
    HIGHRES_DIT (weights from seed 0, zero-init leaves livened), VP, fp32,
    fused step and flash attention, SERVE_SLOTS slots, sync horizon
    SERVE_HORIZON, SERVE_REQUESTS requests cycling the three tiers under EDF
    admission, telemetry ring SERVE_TELEMETRY and the tracer on. Gates:
    every request delivered finite at (256, 256, 3); nfe == 2·(accepted +
    rejected); the ring reconciles exactly with the per-request counts; K1/K2
    exactly one launch a body iteration, K3 24, and P1 (the per-slot noise)
    one a body iteration and one an admission (the port runs whole groups
    of SERVE_HORIZON iterations a chunk, so body iterations = SERVE_HORIZON ·
    chunks); mean NFE rising draft < standard < high_fidelity; two requests
    bitwise their solo runs in an otherwise idle server; the same requests with
    compaction off bitwise the same samples; 4 requests with telemetry on
    bitwise the same run off. Returns the numbers for the kernels line."""
    from repro_torch.configs.diffusion import HIGHRES_DIT, TOLERANCE_CLASSES
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.models.dit import init_dit, liven_zero_init
    from repro_torch.observability.telemetry import telemetry_history
    from repro_torch.observability.tracing import StageTracer
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest
    from repro_torch.serving.scheduler import EdfPriorityAdmission

    t_phase = time.perf_counter()
    net = dataclasses.replace(HIGHRES_DIT, use_flash=True)
    model = init_dit(net, torch.Generator(device=dev).manual_seed(0))
    liven_zero_init(model, torch.Generator(device=dev).manual_seed(0))
    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True)
    step = make_sample_step(sde, cfg)
    shape = (net.image_size, net.image_size, net.channels)

    def serve(uids, *, compaction=True, telemetry=0, tracer=None):
        b = DiffusionBatcher(sde, step, model, shape, slots=SERVE_SLOTS, cfg=cfg,
                             sync_horizon=SERVE_HORIZON, compaction=compaction,
                             tolerance_classes=True,
                             admission=EdfPriorityAdmission(aging_s=5.0),
                             telemetry=telemetry, tracer=tracer, device=dev)
        for u in uids:
            b.submit(ImageRequest(uid=u, seed=u, tier=SERVE_TIERS[u % 3],
                                  deadline_ms=SERVE_DEADLINE_MS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = b.run_to_completion()
        torch.cuda.synchronize()
        return b, done, time.perf_counter() - t0

    uids = list(range(SERVE_REQUESTS))
    tracer = StageTracer()
    step_ops.launches = 0
    flash_ops.launches = 0
    ph.launches = 0
    b, done, wall = serve(uids, telemetry=SERVE_TELEMETRY, tracer=tracer)
    launches = {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches}
    p1_launches = ph.launches
    body_iters = SERVE_HORIZON * b.horizon_windows
    stats = b.class_stats
    means = [stats[t]["mean_nfe"] for t in SERVE_TIERS]
    print(f"  [{card}] served {len(done)}/{len(uids)} requests in {wall:.3f} s "
          f"({len(done) / wall:.2f} requests/s), {b.total_iterations} iterations with a "
          f"sample active, {body_iters} body iterations ({b.horizon_windows} chunks of "
          f"{SERVE_HORIZON}), {wall / body_iters * 1e3:.2f} ms a body iteration")
    for t in SERVE_TIERS:
        print(f"    tier {t:>13}: {stats[t]['delivered']} delivered, mean NFE "
              f"{stats[t]['mean_nfe']:.2f}, deadline misses {stats[t]['deadline_misses']} "
              f"(deadline {SERVE_DEADLINE_MS:.0f} ms), mean wait {stats[t]['mean_wait_s']:.3f} s")
    stages = tracer.stage_histograms()
    print("  host clock by stage (tracer): " + ", ".join(
        f"{k} {v['count']} spans {v['total_s'] * 1e3:.1f} ms (max {v['max_s'] * 1e3:.1f})"
        for k, v in sorted(stages.items())))
    admissions = stages["serve/admission"]["count"]
    print(f"  launches: {launches} (want solver_step = {body_iters}, flash_attention = "
          f"{2 * net.num_layers * body_iters}); serve-loop host transfers "
          f"{b.host_transfers}, solver syncs {b.solver_syncs}; per-slot noise (P1, "
          f"SlotStreams): {p1_launches} launches (want one a body iteration and one an "
          f"admission: {body_iters + admissions})")
    if p1_launches != body_iters + admissions:
        fail(f"serve: {p1_launches} P1 launches, not one a body iteration and one an admission")
    bad = [u for u in uids if u not in done or not np.isfinite(done[u].result).all()
           or done[u].result.shape != shape]
    if bad:
        fail(f"serve: requests {bad} missing, not finite or of the wrong shape")
    if any(done[u].nfe != 2 * (done[u].accepted + done[u].rejected) for u in uids):
        fail("serve: a request's nfe != 2·(accepted + rejected)")
    hist = telemetry_history(b._carry.telemetry)
    active = hist["t"] > np.float32(sde.t_eps + 1e-12)
    ring = (int(hist["accept"].sum()), int((active & ~hist["accept"]).sum()))
    books = (sum(done[u].accepted for u in uids), sum(done[u].rejected for u in uids))
    print(f"  telemetry ring: {hist['records']} records of {hist['iterations']} iterations, "
          f"accepted/rejected {ring} against the requests' {books}")
    if (ring != books or hist["records"] != hist["iterations"]
            or hist["iterations"] != b.total_iterations):
        fail("serve: the telemetry ring does not reconcile with the per-request counts")
    if launches != {"solver_step": body_iters,
                    "flash_attention": 2 * net.num_layers * body_iters}:
        fail(f"serve: launch counts {launches} are not one K1/K2 and 24 K3 a body iteration")
    if not means[0] < means[1] < means[2]:
        fail(f"serve: mean NFE does not rise draft < standard < high_fidelity: {means}")

    b_off, done_off, wall_off = serve(uids, compaction=False)
    same_off = all(np.array_equal(done_off[u].result, done[u].result)
                   and done_off[u].nfe == done[u].nfe for u in uids)
    print(f"  compaction on: wasted NFE {b.wasted_nfe_fraction:.4f}, passenger "
          f"{b.passenger_nfe_fraction:.4f}, {wall:.3f} s; off: wasted "
          f"{b_off.wasted_nfe_fraction:.4f}, passenger {b_off.passenger_nfe_fraction:.4f}, "
          f"{b_off.total_iterations} iterations, {wall_off:.3f} s; samples bitwise equal "
          f"{same_off}")
    if not same_off:
        fail("serve: compaction off delivers other samples than compaction on")
    solo_same = {}
    for u in SERVE_SOLO:
        _, solo, _ = serve([u])
        solo_same[u] = (np.array_equal(solo[u].result, done[u].result)
                        and solo[u].nfe == done[u].nfe)
    print(f"  solo runs (one request in an idle server) bitwise the mixed run's: {solo_same}")
    if not all(solo_same.values()):
        fail("serve: a request served alone differs from the same request in the mixed run")
    short = [u for u in uids if SERVE_TIERS[u % 3] != "high_fidelity"][:4]
    _, t_on, _ = serve(short, telemetry=SERVE_TELEMETRY)
    _, t_off, _ = serve(short)
    tel_same = all(np.array_equal(t_on[u].result, t_off[u].result)
                   and t_on[u].nfe == t_off[u].nfe for u in short)
    print(f"  telemetry on vs off, requests {short}: bitwise equal {tel_same}")
    if not tel_same:
        fail("serve: telemetry on changes the samples")

    # the device's idle share of the serve loop: busy time of a profiled
    # run of the same requests over the unprofiled run's wall
    by_name, busy_us = profile_device(lambda: serve(uids, telemetry=SERVE_TELEMETRY))
    idle = 1 - busy_us * 1e-6 / wall
    n_kernels = sum(c for c, _ in by_name.values())
    print(f"  [{card}] device busy {busy_us / 1e3:.1f} ms of the {wall * 1e3:.1f} ms serve: "
          f"idle share {idle:.3f}; {n_kernels} device operations, "
          f"{n_kernels / body_iters:.0f} a body iteration; by device time:")
    for name, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"    {us / 1e3:8.1f} ms {c:6d}x  {name[:90]}")

    # K2 at the serving state with the tiers' per-row eps, timed
    B, D = SERVE_SLOTS, int(np.prod(shape))
    gen = torch.Generator(device=dev).manual_seed(3)
    rel = torch.tensor([TOLERANCE_CLASSES[SERVE_TIERS[i % 3]].eps_rel for i in range(B)],
                       device=dev)
    atol = torch.full((B,), sde.abs_tolerance, device=dev)
    sets = [(*[torch.randn(B, D, generator=gen, device=dev) for _ in range(5)],
             *[torch.rand(B, generator=gen, device=dev) for _ in range(3)], atol, rel)
            for _ in range(4)]
    k2 = lambda *a: step_ops.error_step(*a[:8], eps_abs=a[8], eps_rel=a[9])
    k2_ms, k2_plain = device_ms(k2, sets), device_ms(lambda *a: step_ref.error_step(*a), sets)
    nbytes = 6 * B * D * 4 + 5 * B * 4 + B * 4
    nops = STEP_FLOPS_PER_ELEMENT * B * D
    k2_bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOPS) * 1e3
    print(f"  [{card}] solver_step K2 (8, {D}) fp32, the tiers' eps per row: "
          f"{k2_ms * 1e3:.2f} us on the device, bound {k2_bound * 1e3:.2f} us; plain "
          f"{k2_plain * 1e3:.1f} us")
    phase_s = time.perf_counter() - t_phase
    print(f"  [{card}] serve phase {phase_s:.1f} s")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches["solver_step"], flash_launches=launches["flash_attention"],
                ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_FLOPS
                else "operations",
                wall_s=wall, requests_per_s=len(done) / wall, idle_share=idle,
                mean_nfe=dict(zip(SERVE_TIERS, means)),
                host_transfers=b.host_transfers, solver_syncs=b.solver_syncs,
                wasted_nfe_fraction=b.wasted_nfe_fraction,
                passenger_nfe_fraction=b.passenger_nfe_fraction,
                wasted_nfe_fraction_no_compaction=b_off.wasted_nfe_fraction,
                iterations=b.total_iterations, body_iterations=body_iters,
                phase_s=phase_s)


class TickClock:
    """1 s a read: the serve loop's clock in runs compared with each
    other, so the per-class books (waits, deadlines) are equal exactly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def timed_windows(b):
    """CUDA events around each of server ``b``'s solver windows: a
    device-resident driver window's graph launch (the driver, its capture
    and WHILE graph, is built here, before the run), or a host-driven chunk
    (``step_fn``, whose host gaps fall inside). torch.profiler cannot take
    the device-resident busy time: its CUPTI tracing of a WHILE-node graph
    lost kernel records (864 of 1,920 K3 launches seen) and faulted with an
    illegal address after ~90 horizons on this card (§7 of PERF.md)."""
    times = []

    def timing(fn):
        def timed(*args):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args)
            end.record()
            times.append((start, end))
            return out
        return timed

    if b.device_resident:
        drv = b._device_driver()
        drv.window = timing(drv.window)
    else:
        b.step_fn = timing(b.step_fn)
    return times


def span_ms(times) -> float:
    """Device ms inside the windows ``timed_windows`` recorded."""
    torch.cuda.synchronize()
    return sum(st.elapsed_time(en) for st, en in times)


def check_streams_and_grids(dev, gen) -> dict:
    """Phase 2's checks of the device-resident slice. P1 (``philox``)
    against its plain version (``ref.py``, run on the card) at the DiT
    state, planning's and Table 1's, and a ragged row: the uint32 words
    exactly, z within P1_TOL·(1 + |z|) (both sides round each add and
    product once; the logarithm, square root, sine and cosine are library
    versions that differ by an ulp or two), an idle row (seed < 0) zero,
    and the rows permuted (the output permuted bit for bit). P2
    (``horizon_cond``) on hand-built masks against its plain version,
    exactly. K1 at (70,000, 2) and K3 at B·Hq = 70,000 (17,500, 4, 8, 32),
    past one launch's 65,535 rows of ``gridDim.y``: two launches each,
    against their plain versions at phase 2's bounds, and the first
    range's rows bitwise a call on those rows alone."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.graph_loop import ops as loop_ops
    from repro_torch.kernels.graph_loop import ref as loop_ref
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.philox import ref as ph_ref
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref

    p1_err = {}
    for b, d in P1_SHAPES:
        seed = torch.randint(0, 2**62, (b,), generator=gen, device=dev)
        seed[0] = -1
        ctr = torch.randint(0, 2**40, (b,), generator=gen, device=dev)
        words_ok = torch.equal(ph.words(seed, ctr, d), ph_ref.philox_words(seed, ctr, d))
        z, want = ph.normal(seed, ctr, d), ph_ref.philox_normal(seed, ctr, d)
        perm = torch.randperm(b, generator=gen, device=dev)
        perm_ok = torch.equal(ph.normal(seed[perm], ctr[perm], d), z[perm])
        torch.cuda.synchronize()
        err = ((z - want).abs() / (1 + want.abs())).max().item()
        idle_ok = not z[0].any().item()
        ok = words_ok and perm_ok and idle_ok and err <= P1_TOL and torch.isfinite(z).all()
        print(f"  philox_normal ({b}, {d}): words exact {words_ok}, max |z - plain|/(1+|z|) "
              f"{err:.3e} (bound {P1_TOL:.0e}), permuted rows bitwise {perm_ok}, idle row 0 "
              f"{idle_ok} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("philox_normal disagrees with its plain version")
        p1_err[(b, d)] = (z - want).abs().max().item()
    p2_err, p2_again, p2_cases, seen = 0, True, 0, set()
    n_state = len(loop_ops.STATE)
    for occ, done in P2_MASKS:
        o = torch.tensor(occ, dtype=torch.bool, device=dev)
        dn = torch.tensor(done, dtype=torch.bool, device=dev)
        for wait_all in (False, True):
            for its in P2_ITERATIONS:
                it = torch.full((), its, dtype=torch.int32, device=dev)
                state = torch.zeros(n_state, dtype=torch.int32, device=dev)
                plain = torch.zeros(n_state, dtype=torch.int32, device=dev)
                kw = dict(wait_all=wait_all, horizon=P2_HORIZON, max_iters=P2_MAX_ITERS,
                          max_horizons=P2_MAX_HORIZONS)
                for k in range(P2_STEPS):
                    before = state.clone()
                    loop_ops.horizon_cond(o, dn, it, state, first=k == 0, **kw)
                    again = before.clone()  # a second call on the same state
                    loop_ops.horizon_cond(o, dn, it, again, first=k == 0, **kw)
                    go = loop_ref.horizon_cond(o, dn, it, plain, first=k == 0, **kw)
                    p2_err = max(p2_err, (state - plain).abs().max().item())
                    p2_again &= torch.equal(again, state)
                    p2_cases += 1
                    s_ = state.tolist()
                    if not go and s_[1] == P2_MAX_HORIZONS and its >= P2_MAX_ITERS:
                        seen.add("budget spent: empty horizons to max_horizons")
                    if go and k > 1 and s_[2] == 0:
                        seen.add("a horizon ended by its length")
                    if not go and not any(a and not b for a, b in zip(occ, done)) and any(occ):
                        seen.add("every occupied row done")
                    if s_[0] and not wait_all:
                        seen.add("an event (compaction)")
                    if s_[0] and wait_all:
                        seen.add("an event (wait_all)")
                    if go and not any(a and not b for a, b in zip(occ, done)):
                        seen.add("an idle slot not done runs the inner condition")
    print(f"  horizon_cond on {len(P2_MASKS)} hand-built masks x both event forms x "
          f"iterations {P2_ITERATIONS} (budget {P2_MAX_ITERS}, horizon {P2_HORIZON}, "
          f"{P2_MAX_HORIZONS} horizons), {p2_cases} evaluations: max |state - plain| {p2_err}, "
          f"the same state on a second call {p2_again}; cases seen {sorted(seen)} "
          f"{'ok' if p2_err == 0 and p2_again and len(seen) == 6 else 'FAIL'}")
    if p2_err or not p2_again or len(seen) != 6:
        fail("horizon_cond disagrees with its plain version, or a hand-built case is missing")

    b, d = K1_BIG
    states = [torch.randn(b, d, generator=gen, device=dev) for _ in range(5)]
    coeffs = [torch.rand(b, generator=gen, device=dev) for _ in range(3)]
    step_ops.launches = 0
    xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=0.0078, eps_rel=0.05)
    k1_launches = step_ops.launches
    xr, e2r = step_ref.error_step(*states, *coeffs,
                                  step_ops.per_sample_tolerance(0.0078, b, dev),
                                  step_ops.per_sample_tolerance(0.05, b, dev))
    first = step_ops.MAX_GRID_ROWS
    xa, ea = step_ops.error_step(*(a[:first] for a in states + coeffs), eps_abs=0.0078,
                                 eps_rel=0.05)
    torch.cuda.synchronize()
    k1_err = (xh - xr).abs().max().item()
    k1_rel = ((e2 - e2r).abs() / e2r.abs()).max().item()
    k1_same = torch.equal(xa, xh[:first]) and torch.equal(ea, e2[:first])
    ok = (k1_err <= 1e-5 * (1 + xr.abs().max().item()) and k1_rel <= 1e-5
          and k1_launches == 2 and k1_same)
    print(f"  solver_step {K1_BIG}: {k1_launches} launches, max|x''-plain| {k1_err:.3e}, max "
          f"rel e2 {k1_rel:.3e}, first {first} rows bitwise a call on them alone {k1_same} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("solver_step past 65,535 rows disagrees with its plain version")
    q, k, v = (torch.randn(*K3_BIG, generator=gen, device=dev) for _ in range(3))
    flash_ops.launches = 0
    out = flash_ops.attention(q, k, v, causal=False)
    k3_launches = flash_ops.launches
    want = flash_ref.attention(q, k, v, causal=False)
    nb = flash_ops.batch_ranges(K3_BIG[0], K3_BIG[1])[0][1]
    part = flash_ops.attention(q[:nb], k[:nb], v[:nb], causal=False)
    torch.cuda.synchronize()
    k3_err = (out - want).abs().max().item()
    k3_bound = ATTN_TOL[torch.float32] * (1 + want.abs().max().item())
    k3_same = torch.equal(part, out[:nb])
    ok = k3_err <= k3_bound and k3_launches == 2 and k3_same
    print(f"  flash_attention {K3_BIG} (B·Hq {K3_BIG[0] * K3_BIG[1]}): {k3_launches} launches, "
          f"max abs err {k3_err:.3e} (bound {k3_bound:.1e}), first {nb} batches bitwise a call "
          f"on them alone {k3_same} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("flash attention past 65,535 (b, h) pairs disagrees with its plain version")
    return dict(p1_err=p1_err, p2_err=p2_err,
                k1_big={"shape": K1_BIG, "launches": k1_launches, "max_abs_err": k1_err},
                k3_big={"shape": K3_BIG, "launches": k3_launches, "max_abs_err": k3_err})


def run_device_serve(dev, card: str, floor_ms: float) -> dict:
    """Phase 6c, the device-resident serve loop on HIGHRES_DIT: phase 6a's
    setup (seeded, livened, VP, fp32, SERVE_SLOTS slots, sync horizon
    SERVE_HORIZON, SERVE_REQUESTS mixed-tier requests under EDF, telemetry
    ring and tracer on), each server on a tick clock (TickClock) so that
    runs compare exactly. Gates: the device-resident drain is bitwise the
    host-driven one (samples, nfe, accepted, rejected, delivery order,
    total_iterations, class_stats, wasted and passenger NFE), also with
    compaction off; it reads the host less (host transfers plus solver
    syncs); on the reference's bench workload (``benchmarks.
    device_serving``, D 2) ≥ 5× fewer device→host reads a request at sync
    horizon 2; under ``torch.cuda.set_sync_debug_mode("warn")`` no
    synchronising call inside any driver window (a read of the flag, the
    control, warns); one unit capture per server; the ring reconciles
    with the per-request counts; the captured unit, one body iteration,
    holds K2 once, K3 2·num_layers times and P1 once, the driver runs
    exactly the iterations with a sample active (no masked iteration),
    and the drain's launches are exactly the unit's times the units the
    device ran, plus the capture's eager warm-up iteration and P1 once an
    admission; P2 once a unit and once a window. A second
    run admits 4 requests, then 2 after every second ``step()``, 16 in
    all, in both modes: every sample bitwise the drain's. Prints wall,
    requests/s, host transfers, windows, events, admission-only visits
    and masked body iterations of both modes and runs, and P1's and P2's
    device times. Two device shares, which are different metrics: in both
    modes the share of the wall outside the solver windows (CUDA events
    around each driver window's graph launch, or each host-driven chunk:
    the serve loop's own time; a chunk's host gaps count as inside), and
    for the host-driven runs only the idle share (torch.profiler's kernel
    time over the wall; the profiler cannot trace the WHILE-node graph).
    Returns the numbers for the kernels line."""
    import warnings

    from repro_torch.benchmarks import device_serving
    from repro_torch.configs.diffusion import HIGHRES_DIT
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.graph_loop import ops as loop_ops
    from repro_torch.kernels.graph_loop import ref as loop_ref
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.philox import ref as ph_ref
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.models.dit import init_dit, liven_zero_init
    from repro_torch.observability.telemetry import telemetry_history
    from repro_torch.observability.tracing import StageTracer
    from repro_torch.serving.diffusion_server import MAX_HORIZONS, DiffusionBatcher, ImageRequest
    from repro_torch.serving.scheduler import EdfPriorityAdmission

    t_phase = time.perf_counter()
    rt, drv = loop_ops.cuda_versions()
    print(f"  CUDA runtime of the kernel library {rt}, driver {drv} (conditional WHILE nodes "
          f"need {loop_ops.MIN_CUDA} in both)")
    net = dataclasses.replace(HIGHRES_DIT, use_flash=True)
    model = init_dit(net, torch.Generator(device=dev).manual_seed(0))
    liven_zero_init(model, torch.Generator(device=dev).manual_seed(0))
    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True)
    step = make_sample_step(sde, cfg)
    shape = (net.image_size, net.image_size, net.channels)
    uids = list(range(SERVE_REQUESTS))
    H = SERVE_HORIZON

    def server(device_resident, compaction=True, telemetry=SERVE_TELEMETRY, tracer=None):
        return DiffusionBatcher(sde, step, model, shape, slots=SERVE_SLOTS, cfg=cfg,
                                sync_horizon=H, compaction=compaction,
                                device_resident=device_resident, tolerance_classes=True,
                                admission=EdfPriorityAdmission(aging_s=5.0), clock=TickClock(),
                                telemetry=telemetry, tracer=tracer, device=dev)

    def request(u):
        return ImageRequest(uid=u, seed=u, tier=SERVE_TIERS[u % 3],
                            deadline_ms=SERVE_DEADLINE_MS)

    def drain(b):
        for u in uids:
            b.submit(request(u))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = b.run_to_completion()
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0

    def arrivals(b):
        """4 requests, then 2 more after every second step()."""
        pending = [request(u) for u in uids]
        for r in pending[:4]:
            b.submit(r)
        pending = pending[4:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while pending or b.queue or any(r is not None for r in b._slot_req):
            b.step()
            steps += 1
            if steps % 2 == 0 and pending:
                for r in pending[:2]:
                    b.submit(r)
                pending = pending[2:]
            if steps > 10_000:
                fail("serve with arrivals: no progress")
        done = b.run_to_completion()
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0

    def same(d1, d2):
        return list(d1) == list(d2) and all(
            np.array_equal(d1[u].result, d2[u].result) and
            (d1[u].nfe, d1[u].accepted, d1[u].rejected) ==
            (d2[u].nfe, d2[u].accepted, d2[u].rejected) for u in d1)

    def books(b):
        return (b.total_iterations, b.class_stats, b.wasted_nfe_fraction,
                b.passenger_nfe_fraction)

    def describe(tag, b, wall, span=None):
        body = b.device_units if b.device_resident else b.horizon_windows * H
        if b.device_resident:
            mode = (f"{b.horizon_windows} driver windows, {b.event_visits} events, "
                    f"{b.admission_visits} admission-only visits, {b.device_horizons} horizons, "
                    f"{b.graph_captures} capture ({b._driver.build_s:.3f} s, "
                    f"{'before the timed run' if span is not None else 'in the wall'})")
        else:
            mode = f"{b.horizon_windows} chunks"
        if span is not None:
            mode += (f"; the solver windows {span:.1f} ms on the device (CUDA events), share "
                     f"of the wall outside them {1 - span / 1e3 / wall:.4f}")
        print(f"  [{card}] {tag}: {len(b.finished)} requests in {wall:.3f} s "
              f"({len(b.finished) / wall:.2f} requests/s), host transfers {b.host_transfers} + "
              f"solver syncs {b.solver_syncs} = {b.host_transfers + b.solver_syncs} reads; "
              f"{mode}; {b.total_iterations} iterations with a sample active of {body} body "
              f"iterations ({body - b.total_iterations} masked)")
        return dict(wall_s=wall, requests_per_s=len(b.finished) / wall,
                    host_transfers=b.host_transfers, solver_syncs=b.solver_syncs,
                    windows=b.horizon_windows, iterations=b.total_iterations,
                    body_iterations=body, masked_iterations=body - b.total_iterations,
                    events=b.event_visits, admission_visits=b.admission_visits,
                    build_s=b._driver.build_s if b.device_resident else 0.0,
                    **({} if span is None else dict(
                        window_ms=span, outside_windows_share=1 - span / 1e3 / wall)))

    # the drain in both modes, in turns (host, device, device, host); the
    # counts at 0 just before the first device-resident run, read after it
    b_host = server(False, tracer=StageTracer())
    t_host = timed_windows(b_host)
    done_host, wall_host = drain(b_host)
    step_ops.launches = flash_ops.launches = ph.launches = 0
    loop_ops.launches = loop_ops.windows = 0
    b_dev = server(True, tracer=StageTracer())
    t_dev = timed_windows(b_dev)
    done_dev, wall_dev = drain(b_dev)
    launches = {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches,
                "philox_normal": ph.launches, "horizon_cond": loop_ops.launches,
                "windows": loop_ops.windows}
    b_dev2 = server(True)
    t_dev2 = timed_windows(b_dev2)
    done_dev2, wall_dev2 = drain(b_dev2)
    b_host2 = server(False)
    t_host2 = timed_windows(b_host2)
    done_host2, wall_host2 = drain(b_host2)
    rec = {"host": describe("host-driven drain", b_host, wall_host, span_ms(t_host)),
           "device": describe("device-resident drain", b_dev, wall_dev, span_ms(t_dev)),
           "device_2": describe("device-resident drain, again", b_dev2, wall_dev2,
                                span_ms(t_dev2)),
           "host_2": describe("host-driven drain, again", b_host2, wall_host2,
                              span_ms(t_host2))}
    rec["device"]["captures"] = b_dev.graph_captures
    bitwise = (same(done_host, done_dev) and books(b_host) == books(b_dev)
               and same(done_host, done_dev2) and same(done_host, done_host2)
               and books(b_dev2) == books(b_host2) == books(b_host))
    print(f"  device-resident drains bitwise the host-driven ones (samples, nfe, accepted, "
          f"rejected, order, iterations, class_stats, wasted/passenger NFE): {bitwise}")
    if not bitwise:
        fail("device-resident serve differs from the host-driven serve")
    if b_dev2.graph_captures != 1:
        fail(f"device-resident server captured {b_dev2.graph_captures} horizons, not 1")
    if b_dev.graph_captures != 1:
        fail(f"device-resident server captured {b_dev.graph_captures} horizons, not 1")
    reads = lambda b: b.host_transfers + b.solver_syncs
    if not reads(b_dev) < reads(b_host):
        fail("device-resident serve reads the host no less than the host-driven serve")
    # the device-resident drain's launches: what the captured unit (one body
    # iteration) holds, times the units the device ran, plus the eager calls
    names = {step_ops: "solver_step", flash_ops: "flash_attention", ph: "philox_normal"}
    recorded = {names[m]: n for (m, c), n in b_dev._driver.graph.recorded.items()
                if m in names and c == "launches"}
    per_iter = dict(recorded)
    eager = {k: launches[k] - recorded[k] * b_dev.device_units for k in recorded}
    admits = b_dev.tracer.stage_histograms()["serve/admission"]["count"]
    want_iter = {"solver_step": 1, "flash_attention": 2 * net.num_layers, "philox_normal": 1}
    want_eager = dict(want_iter, philox_normal=1 + admits)
    launches["per_body_iteration_in_graph"] = per_iter
    launches["eager"] = eager
    print(f"  device-resident drain launches {launches}: the captured unit holds "
          f"{recorded} (one body iteration; want {want_iter}), replayed "
          f"{b_dev.device_units} times ({b_dev.total_iterations} iterations with a sample "
          f"active, in {b_dev.device_horizons} horizons); eager {eager} (want the capture's "
          f"warm-up iteration {want_iter} and P1 once an admission, {admits}: {want_eager}); "
          f"P2 one a unit and one a window")
    if per_iter != want_iter or eager != want_eager:
        fail(f"device-resident drain launched {launches}, not {want_iter} a body iteration "
             f"in the graph and {want_eager} eagerly")
    if b_dev.device_units != b_dev.total_iterations:
        fail(f"the device-resident driver ran {b_dev.device_units} units for "
             f"{b_dev.total_iterations} iterations with a sample active")
    if launches["windows"] != b_dev.horizon_windows or \
            launches["horizon_cond"] != b_dev.device_units + b_dev.horizon_windows:
        fail(f"P2 launches {launches} do not match the driver's windows and units")
    hist = telemetry_history(b_dev._carry.telemetry)
    active = hist["t"] > np.float32(sde.t_eps + 1e-12)
    ring = (int(hist["accept"].sum()), int((active & ~hist["accept"]).sum()))
    req_books = (sum(done_dev[u].accepted for u in uids), sum(done_dev[u].rejected for u in uids))
    print(f"  telemetry ring (device-resident): {hist['records']} records of "
          f"{hist['iterations']} iterations, accepted/rejected {ring} against the requests' "
          f"{req_books}")
    if ring != req_books or hist["iterations"] != b_dev.total_iterations:
        fail("device-resident serve: the ring does not reconcile with the per-request counts")

    # compaction off, both modes
    b_off_h, b_off_d = server(False, compaction=False), server(True, compaction=False)
    off_h, wall_off_h = drain(b_off_h)
    off_d, wall_off_d = drain(b_off_d)
    rec["host_no_compaction"] = describe("host-driven drain, compaction off", b_off_h, wall_off_h)
    rec["device_no_compaction"] = describe("device-resident drain, compaction off", b_off_d,
                                           wall_off_d)
    off_ok = (same(off_h, off_d) and books(b_off_h) == books(b_off_d)
              and all(np.array_equal(off_d[u].result, done_dev[u].result) for u in uids)
              and b_off_d.graph_captures == 1)
    print(f"  compaction off: device-resident bitwise host-driven and the compacted drain "
          f"{off_ok}")
    if not off_ok:
        fail("device-resident serve with compaction off differs")

    # no synchronising call inside a driver window
    b_sync = server(True, telemetry=0)
    for u in uids:
        b_sync.submit(request(u))
    b_sync.step()  # the first window builds the driver (capture, instantiation)
    window, seen = b_sync._driver.window, {"windows": 0, "syncs": 0, "control": 0}

    def sync_warnings(fn):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out, sum("synchroniz" in str(w.message) for w in caught)

    def checked_window():
        state, n = sync_warnings(window)
        seen["windows"] += 1
        seen["syncs"] += n
        return state

    b_sync._driver.window = checked_window
    done_sync = b_sync.run_to_completion()
    _, seen["control"] = sync_warnings(lambda: b_sync._driver.state.cpu())
    del b_sync._driver.window
    print(f"  sync debug mode: {seen['syncs']} synchronising calls inside "
          f"{seen['windows']} driver windows; the flag read alone warns {seen['control']} "
          f"time(s) (the control)")
    if seen["syncs"] or not seen["windows"] or not seen["control"]:
        fail("a driver window synchronises, or the sync check saw nothing")
    if not all(np.array_equal(done_sync[u].result, done_dev[u].result) for u in uids):
        fail("the sync-checked device-resident serve differs")

    # arrivals spread over time, both modes
    b_arr_h, b_arr_d = server(False), server(True)
    t_arr_h, t_arr_d = timed_windows(b_arr_h), timed_windows(b_arr_d)
    arr_h, wall_arr_h = arrivals(b_arr_h)
    arr_d, wall_arr_d = arrivals(b_arr_d)
    rec["host_arrivals"] = describe("host-driven, arrivals over time", b_arr_h, wall_arr_h,
                                    span_ms(t_arr_h))
    rec["device_arrivals"] = describe("device-resident, arrivals over time", b_arr_d, wall_arr_d,
                                      span_ms(t_arr_d))
    arr_ok = all(np.array_equal(arr_h[u].result, done_host[u].result)
                 and np.array_equal(arr_d[u].result, done_host[u].result)
                 and arr_h[u].nfe == arr_d[u].nfe == done_host[u].nfe for u in uids)
    print(f"  arrivals over time: every sample bitwise the drain's in both modes {arr_ok}")
    if not arr_ok:
        fail("a request served with arrivals over time differs from the drain's")

    # the device's idle share: busy time of a profiled run over the
    # unprofiled run's wall, both modes and both runs
    del b_host, b_dev, b_dev2, b_host2, b_off_h, b_off_d, b_sync, b_arr_h, b_arr_d
    # the host-driven runs' idle share: kernel busy time of a profiled run
    # of the same requests over the unprofiled runs' walls
    for key, fn, walls in (("host", drain, (wall_host, wall_host2)),
                           ("host_arrivals", arrivals, (wall_arr_h,))):
        by_name, busy_us = profile_device(lambda: fn(server(False)))
        flash = sum(c for n, (c, _) in by_name.items() if "flash_fwd_kernel" in n)
        idle = [1 - busy_us * 1e-6 / w for w in walls]
        rec[key]["idle_share"] = idle
        rec[key]["device_busy_ms"] = busy_us / 1e3
        rec[key]["profiled_flash_kernels"] = flash
        print(f"  [{card}] {key}: device busy {busy_us / 1e3:.1f} ms of the "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms run(s), idle share "
              f"{', '.join(f'{i:.3f}' for i in idle)}; the profiler saw {flash} K3 kernels "
              f"({2 * net.num_layers} a body iteration: "
              f"{2 * net.num_layers * rec[key]['body_iterations']} ran)")

    # the reference's gate on its bench workload (D 2, 8 slots, 3 requests
    # a slot): ≥ 5× fewer device→host reads a request at sync horizon 2
    row = device_serving.bench_serving(SERVE_SLOTS, dev, horizons=(2,))[2]
    per_req = lambda r: (r["transfers"] + r["solver_syncs"]) / (REQUESTS_PER_SLOT * SERVE_SLOTS)
    ratio = per_req(row["host"]) / per_req(row["device"])
    print(f"  bench workload, sync horizon 2: device→host reads a request host-driven "
          f"{per_req(row['host']):.2f} (serve loop {row['host']['per_request']:.2f} + solver "
          f"syncs), device-resident {per_req(row['device']):.2f}: {ratio:.1f}x (gate 5x); serve "
          f"loop alone {row['ratio']:.1f}x; samples/s {row['host']['samples_per_s']:.1f} and "
          f"{row['device']['samples_per_s']:.1f}")
    if ratio < 5:
        fail("device-resident serve does not cut device→host reads 5x at sync horizon 2")
    rec["bench_h2"] = {"reads_per_request_host": per_req(row["host"]),
                       "reads_per_request_device": per_req(row["device"]), "ratio": ratio,
                       "serve_loop_ratio": row["ratio"],
                       "samples_per_s": {"host": row["host"]["samples_per_s"],
                                         "device": row["device"]["samples_per_s"]}}

    # P1 and P2 device times
    B, D = SERVE_SLOTS, int(np.prod(shape))
    gen = torch.Generator(device=dev).manual_seed(5)
    sets = [(torch.randint(0, 2**62, (B,), generator=gen, device=dev),
             torch.randint(0, 2**40, (B,), generator=gen, device=dev)) for _ in range(4)]
    p1_ms = device_ms(lambda s, c: ph.normal(s, c, D), sets)
    p1_plain = device_ms(lambda s, c: ph_ref.philox_normal(s, c, D), sets)
    randn_ms = device_ms(lambda: torch.randn(B, D, device=dev), [()])
    p1_bytes, p1_ops = 4 * B * D + 16 * B, P1_OPS_PER_ELEMENT * B * D
    p1_bound = max(p1_bytes / HBM_BYTES_PER_S, p1_ops / FP32_FLOPS) * 1e3
    occ = torch.ones(B, dtype=torch.bool, device=dev)
    dn = torch.zeros(B, dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    st = torch.zeros(len(loop_ops.STATE), dtype=torch.int32, device=dev)
    p2_kw = dict(wait_all=False, horizon=H, max_iters=cfg.max_iters,
                 max_horizons=MAX_HORIZONS, first=False)
    p2 = lambda o, d_, i, s: loop_ops.horizon_cond(o, d_, i, s, **p2_kw)
    p2_ms = device_ms(p2, [(occ, dn, it, st)])
    p2_plain = timed_ms(lambda o, d_, i, s: loop_ref.horizon_cond(o, d_, i, s, **p2_kw),
                        [(occ, dn, it, st)], 50)
    # the masks and the counter read, the state read and written
    p2_bytes, p2_ops = 2 * B + 4 + 2 * 4 * len(loop_ops.STATE), 4 * B
    p2_bound = max(p2_bytes / HBM_BYTES_PER_S, p2_ops / FP32_FLOPS) * 1e3
    print(f"  [{card}] philox_normal ({B}, {D}): {p1_ms * 1e3:.2f} us on the device, bound "
          f"{p1_bound * 1e3:.2f} us ({p1_bytes / 1e6:.2f} MB written); plain {p1_plain * 1e3:.1f} "
          f"us; torch.randn of the shape (another generator, for scale) {randn_ms * 1e3:.2f} us")
    print(f"  [{card}] horizon_cond (B {B}): {p2_ms * 1e3:.2f} us on the device, launch floor "
          f"{floor_ms * 1e3:.2f} us, bound {p2_bound * 1e3:.5f} us; plain (reads the host) "
          f"{p2_plain * 1e3:.1f} us")
    phase_s = time.perf_counter() - t_phase
    print(f"  [{card}] device-resident serve phase {phase_s:.1f} s")
    del model
    torch.cuda.empty_cache()
    return dict(rec=rec, launches=launches, cuda_versions=(rt, drv),
                p1=dict(ms=p1_ms, plain_ms=p1_plain, bound_ms=p1_bound, randn_ms=randn_ms,
                        bound_by="bytes" if p1_bytes / HBM_BYTES_PER_S >= p1_ops / FP32_FLOPS
                        else "operations"),
                p2=dict(ms=p2_ms, plain_ms=p2_plain, bound_ms=p2_bound,
                        bound_by="bytes" if p2_bytes / HBM_BYTES_PER_S >= p2_ops / FP32_FLOPS
                        else "operations"),
                sync_check=seen, phase_s=phase_s)


def ssd_inputs(B, S, H, P, G, N, *, gen, dtype=torch.float32):
    """K7's operands in the model's layout, as the reference's kernel test
    draws them: x, B, C normal, dt = softplus(normal), A = −exp(normal)."""
    dev = gen.device
    x = torch.randn(B, S, H, P, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    A = -torch.exp(torch.randn(H, generator=gen, device=dev))
    Bm, C = (torch.randn(B, S, G, N, generator=gen, device=dev).to(dtype) for _ in range(2))
    return x, dt, A, Bm, C


def excess(got, want, tol: float) -> tuple:
    """(max |got − want|, max of |got − want| / (tol·(1 + |want|))): the
    second is ≤ 1 when every element is within the bound."""
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (diff / (tol * (1 + want.float().abs()))).max().item()


def bf16_ulp(got, want):
    """One bf16 ulp of the larger of |got| and |want|, element by element:
    what two roundings of nearby values may differ by beyond their gap."""
    mag = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def attn_share(q, k, v, out, want, **kw) -> float:
    """K3's output against its plain version ``want`` on the same inputs,
    as the largest share of its bound (≤ 1: every element within it).
    fp32: ATTN_TOL·(1 + max|want|). bf16, element by element: the kernel
    rounds each p to bf16 as PV's operand (relative 2^-9), so it differs
    by at most 2^-9·Σp|v|/l, and as much again where l sums the rounded
    p: 2^-8·Σp|v|/l (Σp|v|/l is the plain attention of |v|); the sums'
    order adds fp32's 3e-5 of it; both round the output once (one bf16 ulp)."""
    from repro_torch.kernels.flash_attention import ref as flash_ref

    diff = (out.float() - want.float()).abs()
    if out.dtype == torch.float32:
        return diff.max().item() / (ATTN_TOL[torch.float32] * (1 + want.abs().max().item()))
    absv = flash_ref.attention(q.float(), k.float(), v.float().abs(), **kw)
    bound = bf16_ulp(out, want) + (2.0 ** -8 + ATTN_TOL[torch.float32]) * absv
    return (diff / bound).max().item()


def ssd_share(y, want) -> float:
    """K7's y against its plain version (``ssd_chunked``) as the largest
    share of phase 2's bound: SSD_TOL·(1 + |want|), and in bf16 one bf16
    ulp more (both round y once)."""
    diff = (y.float() - want.float()).abs()
    bound = SSD_TOL * (1 + want.float().abs())
    if y.dtype == torch.bfloat16:
        bound = bound + bf16_ulp(y, want)
    return (diff / bound).max().item()


def held_kernel_calls(fn):
    """``fn()`` with K3's and K7's wrappers replaced by ones that also hold
    each call against its plain version on the very inputs the model gave
    it (``attn_share``, ``ssd_share``); the wrappers are restored after.
    (fn's result, {"K3": (calls, worst share), "K7": (calls, worst share)})."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    attn, scan = flash_ops.attention, ssd_ops.ssd_scan
    seen = {"K3": (0, 0.0), "K7": (0, 0.0)}

    def note(name, share):
        calls, worst = seen[name]
        seen[name] = (calls + 1, max(worst, share))

    def attn_held(q, k, v, **kw):
        out = attn(q, k, v, **kw)
        note("K3", attn_share(q, k, v, out, flash_ref.attention(q, k, v, **kw), **kw))
        return out

    def scan_held(x, dt, A, Bm, C, **kw):
        res = scan(x, dt, A, Bm, C, **kw)
        y = res[0] if isinstance(res, tuple) else res
        note("K7", ssd_share(y, ssd_ref.ssd_chunked(x, dt, A, Bm, C)))
        return res

    flash_ops.attention, ssd_ops.ssd_scan = attn_held, scan_held
    try:
        result = fn()
    finally:
        flash_ops.attention, ssd_ops.ssd_scan = attn, scan
    return result, seen


def ssd_work(B, S, H, P, G, N) -> tuple:
    """(flops, bytes) of one SSD scan in the chunked formulation at chunk
    Q = SSD_WORK_CHUNK: per chunk, C·Bᵀ once per group on the causal half
    (Q(Q+1)/2·N), and per head the masked scores times x (Q(Q+1)/2·P),
    C·state and the state update (Q·N·P each), two flops a multiply-add;
    each input read once and y written once."""
    Q = SSD_WORK_CHUNK
    nc = -(-S // Q)
    tri = Q * (Q + 1) // 2
    fma = B * nc * (G * tri * N + H * (tri * P + 2 * Q * N * P))
    nbytes = 4 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * G * N)
    return 2 * fma, nbytes


def dit_train_flops(cfg, batch: int) -> float:
    """Flops of one DiT training step (forward + backward, 3× the forward,
    two flops a multiply-add): the per-token products (q, k, v, o, the
    gated MLP, patch in and out) on batch·tokens rows, the per-sample
    products (the time MLP, every adaLN and the final one) on batch rows,
    and attention's QKᵀ and PV."""
    E, L, S, P = cfg.d_model, cfg.num_layers, cfg.tokens, cfg.patch_dim
    per_token = L * (4 * E * E + 3 * E * cfg.d_ff) + 2 * P * E
    per_sample = 256 * E + E * E + L * 6 * E * E + 2 * E * E
    attention = L * 4 * batch * S * S * E
    return 3 * (2 * batch * S * per_token + 2 * batch * per_sample + attention)


def profile_device(fn, attempts: int = 3, required: bool = True) -> tuple:
    """Run ``fn`` under torch.profiler (CUDA activity): (device µs by
    kernel name → (count, µs), total device µs). Every caller's ``fn``
    runs device work, so a trace with no device record at all is one
    CUPTI lost: it is taken again, up to ``attempts`` traces, and the
    run fails if none holds a record, unless ``required`` is False: then
    ({}, None), which the caller prints as "not measured"."""
    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.device_time_total)
        if by_name:
            return by_name, sum(us for _, us in by_name.values())
        print(f"  torch.profiler: trace {attempt} of {attempts} holds no device record")
    if not required:
        return {}, None
    fail(f"torch.profiler recorded no device activity in {attempts} traces")


GRAPH_FIELDS = ("x", "nfe", "accepted", "rejected", "iterations")
#: the ring the graphed-solve gates compare (their configs turn it on)
GRAPH_RING = 64


def kernel_counts() -> dict:
    """The launch counts of the kernels a graphed solve runs: K1, K3, K6, P1."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.groupnorm_silu import ops as gn_ops
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.solver_step import ops as step_ops
    return {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches,
            "groupnorm_silu": gn_ops.launches, "philox_normal": ph.launches}


def zero_kernel_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.groupnorm_silu import ops as gn_ops
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.solver_step import ops as step_ops
    step_ops.launches = flash_ops.launches = gn_ops.launches = ph.launches = 0


def host_chain(sde, score, shape, seed: int, cfg, dev, cond=None) -> tuple:
    """The host-driven ``solve_chunk`` chain on ``sample(seed=)``'s streams
    (the prior at counter 0, the noise from counter 1): (SolveResult,
    final carry). One host read a group of SYNC_EVERY iterations."""
    from repro_torch.core.sampling import seed_streams
    from repro_torch.core.solvers import adaptive as ad

    st = seed_streams(seed, shape[0], dev)
    carry = ad.init_carry(sde, sde.prior_sample(shape, st), st.advanced(1), config=cfg,
                          cond=cond)
    carry = ad.solve_chunk(sde, score, carry, max_sync_iters=cfg.max_iters, config=cfg)
    return (ad.finalize(sde, score, carry, precision=cfg.precision,
                        conditioner=cfg.conditioner), carry)


def graphed_vs_host(label: str, card: str, call, host) -> dict:
    """Phases 3, 4, 6d: ``call()`` (an entry point of the graphed solve:
    ``sample()`` or ``plan()``, its config with a GRAPH_RING ring, at a key
    no solve has used yet) four times against ``host()`` (``host_chain``
    on the same streams and config) once, each with the counts at 0. The
    one-shot rule: the first call runs the host-driven chain and records
    the key, the second captures the cached driver's horizon, the third
    replays it, the fourth replays it with CUDA events around the driver's
    window (the window share: the window's elapsed device time over the
    call's wall; elapsed, not busy, since CUPTI cannot trace a WHILE
    node). Gates: x, nfe, accepted, rejected, iterations (and the ring of
    the replay) bitwise the host chain's on every call; the first call's
    host reads, launches and P2 the chain's and no capture; one host read
    a graphed solve (``adaptive.host_syncs``); one capture on the second
    call, none on the others; the replay's K1, K3, K6 and P1 launches
    exactly the iterations' (the captured unit, one body iteration, times
    the iterations: no iteration after the last sample converged), the
    host chain's those plus its masked tail (whole groups of SYNC_EVERY),
    the second call's the replay's plus one body iteration's (the
    capture's warm-up); P2 the iterations + 1."""
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.kernels.graph_loop import ops as loop_ops

    runs = {}
    for name, fn in (("first", call), ("second", call), ("replay", call), ("host", host)):
        zero_kernel_counts()
        c0, s0, p0 = ad.captures, ad.host_syncs, loop_ops.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res, carry = got if name == "host" else (got, None)
        if name == "replay":  # the cached driver's carry holds the replayed solve's ring
            drv = next(reversed(ad._drivers.values()))
            carry = drv.carry
        runs[name] = dict(res=res, ring=carry and carry.telemetry, wall_s=wall,
                          launches=kernel_counts(), p2=loop_ops.launches - p0,
                          syncs=ad.host_syncs - s0, captures=ad.captures - c0)
    # the device's share of a replayed call: events around the driver's window
    from repro_torch.benchmarks.kernel_times import window_events
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with window_events() as spans:
        call()
    torch.cuda.synchronize()
    window_wall = time.perf_counter() - t0
    window_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
    first, second, replay, hostr = (runs[k] for k in ("first", "second", "replay", "host"))
    names = {"solver_step": "solver_step", "flash_attention": "flash_attention",
             "groupnorm_silu": "groupnorm_silu", "philox": "philox_normal"}
    per_iter = {names[getattr(m, "__name__", "").split(".")[-2]]: n
                for (m, c), n in drv.graph.recorded.items()
                if c == "launches" and getattr(m, "__name__", "").split(".")[-2] in names}
    same = {k: all(torch.equal(getattr(runs[k]["res"], f), getattr(hostr["res"], f))
                   for f in GRAPH_FIELDS) for k in ("first", "second", "replay")}
    ring = all(torch.equal(getattr(replay["ring"], f.name), getattr(hostr["ring"], f.name))
               for f in dataclasses.fields(hostr["ring"]))
    its = int(hostr["res"].iterations)
    masked = ad.SYNC_EVERY * -(-its // ad.SYNC_EVERY) - its  # the host chain's group tail
    want_replay = {k: hostr["launches"][k] - per_iter.get(k, 0) * masked
                   for k in hostr["launches"]}
    warm = {k: want_replay[k] + per_iter.get(k, 0) for k in want_replay}
    print(f"  [{card}] {label} graphed: first call {first['wall_s']:.3f} s (host-driven, the "
          f"one-shot rule), second {second['wall_s']:.3f} s (capture included), replayed "
          f"{replay['wall_s']:.3f} s, host-driven chain {hostr['wall_s']:.3f} s "
          f"({hostr['wall_s'] / replay['wall_s']:.2f}x); {its} iterations; bitwise the host "
          f"chain: first {same['first']}, second {same['second']}, replayed {same['replay']}, "
          f"ring {ring}; host reads {first['syncs']}, {second['syncs']}, {replay['syncs']} "
          f"(host-driven {hostr['syncs']}); captures {first['captures']}, "
          f"{second['captures']}, {replay['captures']} (build {drv.build_s:.3f} s); launches "
          f"replayed {replay['launches']} (want {want_replay}: {per_iter} an iteration; "
          f"host-driven {hostr['launches']}, {masked} masked iterations in its last group; "
          f"first {first['launches']}; second {second['launches']}, want {warm}), P2 "
          f"{replay['p2']} (the iterations + 1; host-driven {hostr['p2']}); the "
          f"driver's window {window_ms:.1f} ms elapsed on the device of a "
          f"{window_wall * 1e3:.1f} ms call (window share {window_ms / (window_wall * 1e3):.2f}, "
          f"CUDA events)")
    if not all(same.values()) or not ring:
        fail(f"{label}: the graphed solve is not bitwise the host-driven chain")
    if second["syncs"] != 1 or replay["syncs"] != 1 or first["syncs"] != hostr["syncs"]:
        fail(f"{label}: host reads {first['syncs']}, {second['syncs']}, {replay['syncs']}; "
             f"want the chain's {hostr['syncs']}, then 1 a graphed solve")
    if (first["captures"], second["captures"], replay["captures"]) != (0, 1, 0):
        fail(f"{label}: captures {first['captures']}, {second['captures']}, "
             f"{replay['captures']}, not 0, 1, 0")
    if replay["p2"] != its + 1 or hostr["p2"] != 0 or first["p2"] != 0:
        fail(f"{label}: P2 ran {replay['p2']} times in the replayed solve (want the "
             f"{its} iterations + 1), {first['p2']} and {hostr['p2']} host-driven")
    if (replay["launches"] != want_replay or first["launches"] != hostr["launches"]
            or second["launches"] != warm):
        fail(f"{label}: launches first {first['launches']}, second {second['launches']}, "
             f"replayed {replay['launches']}; want the host chain's {hostr['launches']}, "
             f"the iterations' {want_replay}, plus the warm-up {warm}")
    return {"first_s": first["wall_s"], "second_s": second["wall_s"],
            "replay_s": replay["wall_s"], "host_s": hostr["wall_s"],
            "iterations": its, "mean_nfe": float(hostr["res"].mean_nfe),
            "launches": replay["launches"], "first_launches": first["launches"],
            "second_launches": second["launches"], "horizon_cond": replay["p2"],
            "host_reads": replay["syncs"], "host_driven_reads": hostr["syncs"],
            "build_s": drv.build_s, "window_ms": window_ms, "window_call_s": window_wall,
            "window_share": window_ms / (window_wall * 1e3), "result": replay["res"]}


def guided_launches(guided: dict, kernel: str, what: str) -> dict:
    """A kernel's launches in phase 3b: a replayed graphed call of each
    conditioner, the host-driven one, and each served drain."""
    return {"launched_as": what + ": a replayed graphed call, the host-driven chain, the "
                                  "served drains (host-driven, device-resident)",
            **{k: guided[k]["graphed"]["launches"][kernel] for k in ("cfg", "inpaint")},
            "host_driven": {k: guided[k]["graphed"]["first_launches"][kernel]
                            for k in ("cfg", "inpaint")},
            "served": {k: {d: v["launches"][kernel] for d, v in guided[k]["served"].items()}
                       for k in ("cfg", "inpaint")}}


def run_guided(dev, card: str) -> dict:
    """Phase 3b: controlled generation from HIGHRES_DIT (module docstring):
    CFG and inpainting through ``sample()`` graphed against the
    host-driven chain, a replay with another payload, the launch counts,
    then ``serve_diffusion`` with each conditioner on both drivers and
    solo runs, and K3 at CFG's shape timed. Returns the numbers of the
    kernels line."""
    from repro_torch.configs.diffusion import HIGHRES_DIT
    from repro_torch.core.sampling import sample
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.launch import sample as launcher
    from repro_torch.launch.serve import serve_diffusion
    from repro_torch.models.dit import make_score_fn

    t_phase = time.perf_counter()
    sde, B = VPSDE(), 8
    out = {}
    for kind in ("cfg", "inpaint"):
        guide = dict(cfg_scale=GUIDED_CFG) if kind == "cfg" else dict(inpaint=True)
        net = dataclasses.replace(HIGHRES_DIT, use_flash=True, num_classes=(
            launcher.DEMO_CLASSES if kind == "cfg" else 0))
        model = launcher.seeded_dit(net, seed=0, liven_seed=0, device=dev)
        score = make_score_fn(model, sde)
        conditioner, cond, name = launcher.guidance(B, net, **guide)
        if kind == "cfg":
            other = {"label": (cond["label"] + 5) % launcher.DEMO_CLASSES}
        else:
            other = {"mask": 1.0 - cond["mask"], "observed": -cond["observed"]}
        gcfg = ad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, max_iters=MAIN_MAX_ITERS,
                                 telemetry_capacity=GRAPH_RING, conditioner=conditioner)
        shape = (B, net.image_size, net.image_size, net.channels)
        call = lambda c=cond: sample(sde, score, shape, seed=0, config=gcfg, cond=c, device=dev)
        host = lambda c=cond: host_chain(sde, score, shape, 0, gcfg, dev, cond=c)
        g = graphed_vs_host(f"HIGHRES_DIT {name}", card, call, host)
        # the counts of a replayed call: K1 one an iteration (no masked
        # iteration after the last sample converged), K3 a forward's layers
        # for each of 2 an iteration and the denoise (CFG: one forward over
        # 2B rows), P1 the prior and the draws of each iteration
        its = g["iterations"]
        body = its
        draws = ad.draws_per_iteration(gcfg)
        want = {"solver_step": body, "flash_attention": net.num_layers * (2 * body + 1),
                "groupnorm_silu": 0, "philox_normal": 1 + draws * body}
        print(f"  [{card}] {name}: {its} iterations, {body} body iterations replayed "
              f"(host-driven {ad.SYNC_EVERY * -(-its // ad.SYNC_EVERY)}); a replayed call's "
              f"launches {g['launches']} (want {want}), P2 {g['horizon_cond']} (the "
              f"{its} iterations + 1); mean NFE {g['mean_nfe']:.2f}; "
              f"replayed {g['replay_s']:.3f} s, host-driven {g['host_s']:.3f} s")
        if g["launches"] != want:
            fail(f"{name}: a replayed call launched {g['launches']}, want {want}")
        # the cached driver fed another payload: a replay reads the payload
        # from the driver's buffers, so its sample is the host-driven
        # solve's with that payload, not the first payload's
        zero_kernel_counts()
        c0, s0 = ad.captures, ad.host_syncs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        swapped = call(other)
        torch.cuda.synchronize()
        swap_s = time.perf_counter() - t0
        swap = dict(captures=ad.captures - c0, syncs=ad.host_syncs - s0,
                    launches=kernel_counts())
        host_other, _ = host(other)
        same = all(torch.equal(getattr(swapped, f), getattr(host_other, f))
                   for f in GRAPH_FIELDS)
        moved = not torch.equal(swapped.x, g["result"].x)
        exact = {}
        if kind == "inpaint":
            for label, res, c in (("first", g["result"], cond), ("other", swapped, other)):
                m = c["mask"].to(dev) > 0
                exact[label] = bool(torch.equal(res.x[m], c["observed"].to(dev)[m]))
        print(f"  [{card}] {name} replayed with another payload: {swap_s:.3f} s, bitwise the "
              f"host-driven solve with it {same}, another sample than the first payload's "
              f"{moved}; captures {swap['captures']}, host reads {swap['syncs']}, launches "
              f"{swap['launches']}" + (f"; observed pixels exact {exact}" if exact else ""))
        if not same or not moved:
            fail(f"{name}: a replay with another payload is not the host-driven solve with it")
        if swap["captures"] != 0 or swap["syncs"] != 1:
            fail(f"{name}: the payload swap captured {swap['captures']} graphs and read the "
                 f"host {swap['syncs']} times (want a replay: 0 and 1)")
        if exact and not all(exact.values()):
            fail(f"{name}: observed pixels are not the observed values exactly")
        del model, score, swapped, host_other
        gc.collect()

        # served: both drivers, then GUIDED_SOLO requests each alone
        served = {}
        for resident in (False, True):
            zero_kernel_counts()
            rec = serve_diffusion(slots=GUIDED_SERVE_SLOTS, requests=GUIDED_SERVE_REQUESTS,
                                  arch="highres_dit", sync_horizon=SERVE_HORIZON,
                                  device_resident=resident, device=dev, **guide)
            served["device_resident" if resident else "host"] = dict(
                rec=rec, launches=kernel_counts())
            gc.collect()
        hrec, drec = served["host"]["rec"], served["device_resident"]["rec"]
        done, ddone = hrec["delivered"], drec["delivered"]
        body_s = SERVE_HORIZON * hrec["horizon_windows"]
        got = served["host"]["launches"]
        want_s = {"solver_step": body_s, "flash_attention": 2 * net.num_layers * body_s}
        resident_same = sorted(done) == sorted(ddone) and all(
            np.array_equal(done[u].result, ddone[u].result) and done[u].nfe == ddone[u].nfe
            for u in done)
        exact_s = all(np.array_equal(r.result[np.asarray(r.cond["mask"]) > 0],
                                     np.asarray(r.cond["observed"])[np.asarray(r.cond["mask"]) > 0])
                      for r in done.values()) if kind == "inpaint" else None
        finite = all(np.isfinite(r.result).all() and r.result.shape == shape[1:]
                     for r in done.values())
        solo = {}
        for u in GUIDED_SOLO:
            one = serve_diffusion(slots=GUIDED_SERVE_SLOTS, requests=GUIDED_SERVE_REQUESTS,
                                  arch="highres_dit", sync_horizon=SERVE_HORIZON, uids=[u],
                                  device=dev, **guide)["delivered"]
            solo[u] = (np.array_equal(one[u].result, done[u].result)
                       and one[u].nfe == done[u].nfe)
            gc.collect()
        print(f"  [{card}] {name} served ({GUIDED_SERVE_SLOTS} slots, "
              f"{GUIDED_SERVE_REQUESTS} requests, horizon {SERVE_HORIZON}): host-driven "
              f"{hrec['wall_s']:.3f} s ({hrec['completed']} delivered, mean NFE "
              f"{hrec['mean_nfe']:.2f}, {body_s} body iterations, host transfers "
              f"{hrec['host_transfers']}), device-resident {drec['wall_s']:.3f} s (host "
              f"transfers {drec['host_transfers']}, windows {drec['horizon_windows']}); "
              f"launches host-driven {got} (want K1 {want_s['solver_step']}, K3 "
              f"{want_s['flash_attention']}; P1 {got['philox_normal']}: {draws} a body "
              f"iteration and one an admission round), device-resident "
              f"{served['device_resident']['launches']}; device-resident bitwise the "
              f"host-driven drain {resident_same}; finite at {shape[1:]} {finite}; "
              + (f"observed pixels exact {exact_s}; " if exact_s is not None else "")
              + f"solo runs bitwise the drain's {solo}")
        if {k: got[k] for k in want_s} != want_s:
            fail(f"{name} served: launches {got}, want {want_s}")
        if not draws * body_s < got["philox_normal"] <= draws * body_s + GUIDED_SERVE_REQUESTS:
            fail(f"{name} served: {got['philox_normal']} P1 launches, not {draws} a body "
                 f"iteration plus at most one an admission")
        if not (resident_same and finite and all(solo.values()) and exact_s is not False
                and hrec["completed"] == GUIDED_SERVE_REQUESTS):
            fail(f"{name} served: a request differs between the drivers or from its solo run, "
                 f"is not finite, or misses its observed pixels")
        g = {k: v for k, v in g.items() if k != "result"}
        out[kind] = {"graphed": g, "body_iterations": body, "swap_s": swap_s,
                     "served": {k: {"wall_s": v["rec"]["wall_s"],
                                    "mean_nfe": v["rec"]["mean_nfe"],
                                    "host_transfers": v["rec"]["host_transfers"],
                                    "windows": v["rec"]["horizon_windows"],
                                    "launches": v["launches"]} for k, v in served.items()}}
        del served, done, ddone, hrec, drec
        gc.collect()
        torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(11)
    out["k3"] = k3_times(dev, gen, card, {"cfg": CFG_ATTN})["cfg"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [{card}] guided phase {out['phase_s']:.1f} s")
    return out


def graphed_baseline(label: str, card: str, solve, per_draw: int = 1) -> dict:
    """Phase 4b: a fixed-grid baseline or the ODE (``solve()``, a
    ``sample()`` call at a key no solve has used yet) four times, each
    with the counts at 0: the first runs the host-driven loop (the
    one-shot rule), the second captures the cached driver, the third and
    fourth replay it (the fourth with CUDA events around the driver's
    window: the window share). Gates: x and nfe bitwise and iterations
    equal on every call; captures 0, 1, 0; one host read a graphed solve;
    the replay's K5, K3 and P1 launches the host-driven loop's less its
    masked tail (none on a grid; the ODE's last group of SYNC_EVERY
    attempts past the last, six forwards each: the replay's K3 is
    12·(6·attempts + 2)), the second call's the replay's plus one unit
    (the capture's warm-up: one grid step or one RK45 attempt); P2 one a
    unit + 1."""
    from repro_torch.configs.diffusion import HIGHRES_DIT
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.kernels.graph_loop import ops as loop_ops
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.benchmarks.kernel_times import window_events

    runs = []
    for _ in range(3):
        zero_kernel_counts()
        step_ops.em_launches = 0
        c0, s0, w0, p0 = ad.captures, ad.host_syncs, loop_ops.windows, loop_ops.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        runs.append(dict(res=res, wall_s=time.perf_counter() - t0,
                         launches={**kernel_counts(), "em_step": step_ops.em_launches},
                         captures=ad.captures - c0, syncs=ad.host_syncs - s0,
                         windows=loop_ops.windows - w0, p2=loop_ops.launches - p0))
    drv = next(reversed(ad._drivers.values()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with window_events() as spans:
        solve()
    torch.cuda.synchronize()
    window_wall = time.perf_counter() - t0
    window_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
    host, second, replay = runs
    its = int(host["res"].iterations)
    # the host-driven ODE runs whole groups of SYNC_EVERY attempts; a grid
    # runs its steps, a unit each, on both paths
    ode = drv.max_horizons != ad.UNBOUNDED
    masked = ad.SYNC_EVERY * -(-its // ad.SYNC_EVERY) - its if ode else 0
    names = {"solver_step": "em_step", "flash_attention": "flash_attention",
             "philox": "philox_normal"}
    recorded = {names[m.__name__.split(".")[-2]] if c == "launches" else "em_step": n
                for (m, c), n in drv.graph.recorded.items()
                if c == "em_launches" or (c == "launches"
                                          and m.__name__.split(".")[-2] in ("flash_attention",
                                                                            "philox"))}
    want_replay = {k: host["launches"][k] - recorded.get(k, 0) * masked
                   for k in host["launches"]}
    warm = {k: want_replay[k] + recorded.get(k, 0) for k in host["launches"]}
    if ode:  # the acceptance form: 6 forwards an attempt, the FSAL seed and the denoise
        want_replay["flash_attention"] = HIGHRES_DIT.num_layers * (6 * its + 2)
    same = [all(torch.equal(getattr(r["res"], f), getattr(host["res"], f)) for f in ("x", "nfe"))
            and int(r["res"].iterations) == int(host["res"].iterations) for r in runs]
    print(f"  [{card}] {label}: host-driven {host['wall_s']:.3f} s, captured "
          f"{second['wall_s']:.3f} s (build {drv.build_s:.3f} s), replayed "
          f"{replay['wall_s']:.3f} s ({host['wall_s'] / replay['wall_s']:.2f}x); "
          f"{int(host['res'].iterations)} iterations, mean NFE "
          f"{float(host['res'].mean_nfe):.0f}; bitwise {same}; captures "
          f"{[r['captures'] for r in runs]}; host reads {[r['syncs'] for r in runs]}; "
          f"windows {[r['windows'] for r in runs]}; P2 {[r['p2'] for r in runs]} (want "
          f"{its + 1} replayed); launches host-driven {host['launches']} ({masked} masked "
          f"units), replayed {replay['launches']} (want {want_replay}), second "
          f"{second['launches']} (want {warm}); window "
          f"{window_ms:.1f} ms of a {window_wall * 1e3:.1f} ms call (share "
          f"{window_ms / (window_wall * 1e3):.2f})")
    if not all(same) or not torch.isfinite(host["res"].x).all():
        fail(f"{label}: a graphed solve is not bitwise the host-driven loop ({same}) or "
             f"the samples are not finite")
    if [r["captures"] for r in runs] != [0, 1, 0] or second["syncs"] != replay["syncs"] != 1:
        fail(f"{label}: captures {[r['captures'] for r in runs]}, host reads "
             f"{[r['syncs'] for r in runs]}; want 0, 1, 0 and one read a graphed solve")
    if (replay["launches"] != want_replay or second["launches"] != warm
            or replay["p2"] != its + 1):
        fail(f"{label}: launches replayed {replay['launches']}, second {second['launches']}, "
             f"P2 {replay['p2']}; want {want_replay} (the host-driven loop's "
             f"{host['launches']} less {masked} masked units), plus the warm-up {warm}, and "
             f"P2 {its + 1}")
    return {"host_s": host["wall_s"], "second_s": second["wall_s"],
            "replay_s": replay["wall_s"], "build_s": drv.build_s,
            "iterations": int(host["res"].iterations),
            "mean_nfe": float(host["res"].mean_nfe), "launches": replay["launches"],
            "horizon_cond": replay["p2"],
            "host_reads": replay["syncs"], "host_driven_reads": host["syncs"],
            "window_ms": window_ms, "window_call_s": window_wall,
            "window_share": window_ms / (window_wall * 1e3)}


def forward_graphed(dev, card: str) -> dict:
    """Phase 4b's Algorithm 2 (``adaptive_forward``) on the card at a
    (4096, 2) state with a state-dependent g (0.2·x, the Itô s = ±1 from
    the streams): three solves on one set of per-row streams, captures 0,
    1, 0, the graphed solves bitwise the host-driven first, one host read
    and one driver window each; E x(1) within 2 % of e^0.05."""
    from repro_torch.core import ForwardAdaptiveConfig, adaptive_forward
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.core.solvers.base import SlotStreams
    from repro_torch.kernels.graph_loop import ops as loop_ops

    st = SlotStreams.of(list(range(4096)), 0, dev)
    f, g = (lambda x, t: 0.05 * x), (lambda x, t: 0.2 * x)
    cfg = ForwardAdaptiveConfig(eps_abs=1e-3, eps_rel=0.02, h_init=0.1)
    runs = []
    for _ in range(3):
        c0, s0, w0 = ad.captures, ad.host_syncs, loop_ops.windows
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = adaptive_forward(f, g, torch.ones(4096, 2, device=dev), 0.0, 1.0, st,
                               config=cfg, device=dev)
        torch.cuda.synchronize()
        runs.append(dict(res=res, wall_s=time.perf_counter() - t0, captures=ad.captures - c0,
                         syncs=ad.host_syncs - s0, windows=loop_ops.windows - w0))
    host = runs[0]["res"]
    same = [all(torch.equal(getattr(r["res"], k), getattr(host, k))
                for k in ("x", "nfe", "accepted", "rejected", "iterations")) for r in runs]
    mean = float(host.x.mean())
    print(f"  [{card}] Algorithm 2 at (4096, 2), g = 0.2·x: {int(host.iterations)} iterations, "
          f"walls {[round(r['wall_s'], 3) for r in runs]} s (host-driven, captured, replayed); "
          f"bitwise {same}; captures {[r['captures'] for r in runs]}; host reads "
          f"{[r['syncs'] for r in runs]}; windows {[r['windows'] for r in runs]}; E x(1) "
          f"{mean:.4f} (e^0.05 = {math.exp(0.05):.4f})")
    if (not all(same) or [r["captures"] for r in runs] != [0, 1, 0]
            or [r["syncs"] for r in runs[1:]] != [1, 1] or [r["windows"] for r in runs] != [0, 1, 1]
            or abs(mean - math.exp(0.05)) > 0.02 * math.exp(0.05)):
        fail("Algorithm 2 graphed on the card is not its host-driven solve")
    return {"host_s": runs[0]["wall_s"], "second_s": runs[1]["wall_s"],
            "replay_s": runs[2]["wall_s"], "iterations": int(host.iterations),
            "host_driven_reads": runs[0]["syncs"], "host_reads": runs[2]["syncs"]}


def body_iterations(iters: int, reads: int, c0: int) -> int:
    """The body iterations one Algorithm-1 solve of ``iters`` iterations
    ran, K1 once each, given the host reads it made since
    ``adaptive.host_syncs`` read ``reads`` before it and the captures since
    ``adaptive.captures`` read ``c0``: a graphed solve (one read) runs its
    iterations and no more, the host-driven chain (a read before it and one
    a group) whole groups of SYNC_EVERY; a capture's warm-up adds one."""
    from repro_torch.core.solvers import adaptive as ad
    graphed = ad.host_syncs - reads == 1
    return (iters if graphed else ad.SYNC_EVERY * -(-iters // ad.SYNC_EVERY)) \
        + captured_warmups(c0)


def captured_warmups(c0: int) -> int:
    """Horizons captured since ``adaptive.captures`` read ``c0``: each
    capture's warm-up ran one body iteration eagerly (K1 once, the
    forwards' kernels twice)."""
    from repro_torch.core.solvers import adaptive as ad
    return ad.captures - c0


#: the decode gates' prompt and generated tokens (fewer than the serves':
#: the eager comparison is the slow side)
DECODE_GATE_TOKENS = (8, 8)


def decode_gate(label: str, card: str, cfg, params, prompts, dev, cross=None) -> dict:
    """Phases 7, 7b, 7d, 7e: ``serve_batch``'s loop (``greedy_decode``) on
    the graphed serve step and on its eager step, each from a fresh decode
    state, over the first DECODE_GATE_TOKENS[0] prompt tokens and
    DECODE_GATE_TOKENS[1] generated: the tokens and every tensor of the
    final state bitwise equal, each state kept in place (its tensors'
    ``data_ptr``), one capture.
    Then LM_IDLE_STEPS more steps of each: ms a step; graphed, the
    elapsed device ms a step from CUDA events around the replays; for
    each, the profiled device busy time (torch.profiler, which traces the
    kernels of a plain graph's replays) and the idle share against the
    unprofiled wall."""
    from repro_torch.launch.serve import greedy_decode, state_tensors
    from repro_torch.launch.steps import GraphedServeStep, make_serve_step
    from repro_torch.models import init_decode_state

    P, gen_len = DECODE_GATE_TOKENS
    prompts = prompts[:, :P]
    R = prompts.shape[0]
    step = make_serve_step(cfg, device=dev)
    if not isinstance(step, GraphedServeStep):
        fail(f"{label}: the serve step on the card is not graphed")
    runs = {}
    for name, fn in (("graphed", step), ("eager", step.eager)):
        state = init_decode_state(cfg, R, P + gen_len, device=dev)
        ptrs = [t.data_ptr() for t in state_tensors(state)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = greedy_decode(fn, params, prompts, state, gen_len=gen_len, cross_embeds=cross)
        torch.cuda.synchronize()
        runs[name] = (toks, state, time.perf_counter() - t0,
                      [t.data_ptr() for t in state_tensors(state)] == ptrs)
    (tg, sg, wg, ig), (te, se, we, ie) = runs["graphed"], runs["eager"]
    same_tokens = torch.equal(tg, te)
    same_state = bool(state_tensors(sg)) and all(
        torch.equal(a, b) for a, b in zip(state_tensors(sg), state_tensors(se)))
    extra = {} if cross is None else {"cross_embeds": cross}

    def loop(fn, state, n=LM_IDLE_STEPS):
        tok = tg[:, -1:]
        for _ in range(n):
            tok, state = fn(params, {"tokens": tok, **extra}, state)

    n = LM_IDLE_STEPS
    loop(step, sg, 2)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    loop(step, sg)
    e1.record()
    torch.cuda.synchronize()
    g_ms = (time.perf_counter() - t0) * 1e3 / n
    g_elapsed = e0.elapsed_time(e1) / n
    # the replays' busy time: a plain CUDA graph's kernels are traced
    _, g_busy_us = profile_device(lambda: loop(step, sg), required=False)
    g_busy = None if g_busy_us is None else g_busy_us / 1e3 / n
    loop(step.eager, se, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop(step.eager, se)
    torch.cuda.synchronize()
    e_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name, busy_us = profile_device(lambda: loop(step.eager, se))
    e_dev = busy_us / 1e3 / n
    ops = sum(c for c, _ in by_name.values()) / n
    steps = P + gen_len - 1
    g_idle = None if g_busy is None else 1 - g_busy / g_ms
    print(f"  [{card}] {label} decode, graphed vs eager ({R} rows, prompt {P}, gen {gen_len}): "
          f"tokens bitwise {same_tokens}, final state bitwise {same_state}, in place "
          f"{ig and ie}, captures {step.captures} (build {step.build_s:.3f} s); the "
          f"{steps} steps graphed {wg:.3f} s (capture included), eager {we:.3f} s; then "
          f"{n} steps: graphed {g_ms:.2f} ms a step, elapsed {g_elapsed:.2f} ms on the device "
          f"(CUDA events, window share {g_elapsed / g_ms:.2f}), busy {busy_text(g_busy)} ms "
          f"(profiler, idle share {busy_text(g_idle)}); eager {e_ms:.2f} ms a step, busy "
          f"{e_dev:.2f} ms ({ops:.0f} device operations, profiler), idle share "
          f"{1 - e_dev / e_ms:.2f}; {e_ms / g_ms:.2f}x")
    if not (same_tokens and same_state and ig and ie and step.captures == 1):
        fail(f"{label}: the graphed decode is not bitwise the eager step (tokens "
             f"{same_tokens}, state {same_state}, in place {ig and ie}, captures "
             f"{step.captures})")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
    return {"graphed_ms_per_step": g_ms, "graphed_elapsed_ms_per_step": g_elapsed,
            "graphed_window_share": g_elapsed / g_ms, "graphed_busy_ms_per_step": g_busy,
            "graphed_idle_share": g_idle, "build_s": step.build_s,
            "graphed_first_call_s": wg, "eager_call_s": we,
            "eager_ms_per_step": e_ms, "decode_device_ms_per_step": e_dev,
            "decode_idle_share": 1 - e_dev / e_ms, "decode_ops_per_step": ops,
            "top": [(name[:50], c, us / 1e3) for name, (c, us) in top]}


def busy_text(v) -> str:
    """A profiled number, or "not measured" where the trace held no record."""
    return "not measured" if v is None else f"{v:.2f}"


def graph_nodes(graph) -> dict:
    """The nodes of a CUDA graph captured with ``keep_graph=True``, kernel
    nodes by function name, any other under "other nodes"
    (``repro_torch.benchmarks.kernel_times.graph_nodes``, read through the
    driver API; unlike a CUPTI trace, no record can be lost)."""
    from repro_torch.benchmarks import kernel_times
    try:
        return kernel_times.graph_nodes(graph)
    except RuntimeError as e:
        fail(str(e))


def check_tables_state_and_guard(dev, gen) -> dict:
    """Phase 2's checks for the training slice: K1 at the tables' states,
    (4096, 2) for Table 1 and (2048, 2) for Tables 3 and 4–5, fp32,
    against its plain version at the bounds of phase 2 (x''
    1e-5·(1 + max|x''|), e2 1e-5 relative), the same bits on a second
    call, and on operands off 16 bytes bitwise equal to the aligned call
    (K5 at those states is in phase 2's K5 loop); then the autograd guard:
    under grad mode every CUDA wrapper refuses an input that requires
    grad and launches nothing (neither package has a backward kernel).
    Returns K1's largest max abs error at those states."""
    from repro_torch.benchmarks.table1_solver_grid import N_SAMPLES
    from repro_torch.benchmarks.table3_offtheshelf import N as N_TABLE3
    from repro_torch.benchmarks.table45_ablations import N as N_TABLE45
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.groupnorm_silu import ops as gn_ops
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref
    from repro_torch.kernels.ssd import ops as ssd_ops

    d = 2
    k1_err = 0.0
    for b in sorted({N_SAMPLES, N_TABLE3, N_TABLE45}, reverse=True):
        states = [torch.randn(b, d, generator=gen, device=dev) for _ in range(5)]
        coeffs = [torch.rand(b, generator=gen, device=dev) for _ in range(3)]
        ea, er = (step_ops.per_sample_tolerance(e, b, dev) for e in (2 / 256, 0.05))
        xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
        again = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
        xr, e2r = step_ref.error_step(*states, *coeffs, ea, er)
        views = []
        for t in states:
            views.append(torch.empty(b * d + 1, device=dev)[1:].view(b, d))
            views[-1].copy_(t)
        vx, ve = step_ops.error_step(*views, *coeffs, eps_abs=ea, eps_rel=er)
        torch.cuda.synchronize()
        err = (xh - xr).abs().max().item()
        bound = 1e-5 * (1 + xr.abs().max().item())
        e_rel = ((e2 - e2r).abs() / e2r.abs()).max().item()
        same = torch.equal(again[0], xh) and torch.equal(again[1], e2)
        unaligned = torch.equal(vx, xh) and torch.equal(ve, e2)
        cfg = step_ops.kernel_config(b, d, d, torch.float32, True)
        print(f"  solver_step fp32 at the tables' state {(b, d)} ({cfg['design']}, "
              f"{cfg['load_bytes']}-byte loads): max|x''-plain| {err:.3e} (bound "
              f"{bound:.1e}), max rel e2 {e_rel:.3e} (bound 1e-5), same bits twice {same}, "
              f"off 16 bytes (single-element loads) bitwise the aligned call's {unaligned}")
        if not (err <= bound and e_rel <= 1e-5 and same and unaligned):
            fail(f"solver_step at {(b, d)} disagrees with its plain version or itself")
        k1_err = max(k1_err, err)

    counters = lambda: (step_ops.launches, step_ops.em_launches, step_ops.sharded_launches,
                        flash_ops.launches, gn_ops.launches, ssd_ops.launches)
    before = counters()
    rg = lambda *shape: torch.randn(*shape, generator=gen, device=dev).requires_grad_(True)
    plain = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    cs = [torch.rand(8, generator=gen, device=dev) for _ in range(3)]
    x7, dt7, A7, B7, C7 = ssd_inputs(1, 64, 2, 64, 1, 128, gen=gen)
    calls = {
        "solver_step (K1)": lambda: step_ops.error_step(
            rg(8, 64), *(plain(8, 64) for _ in range(4)), *cs, eps_abs=0.01, eps_rel=0.05),
        "em_step (K5)": lambda: step_ops.em_step(plain(8, 64), rg(8, 64), plain(8, 64), *cs),
        "error_step_sums (K4)": lambda: step_ops.error_step_sums(
            *(plain(8, 64) for _ in range(4)), rg(8, 64), *cs, eps_abs=0.01, eps_rel=0.05),
        "flash_attention (K3)": lambda: flash_ops.attention(
            rg(1, 2, 64, 64), plain(1, 2, 64, 64), plain(1, 2, 64, 64), causal=False),
        "groupnorm_silu (K6)": lambda: gn_ops.groupnorm_silu(
            plain(4, 32, 64), torch.ones(64, device=dev).requires_grad_(True),
            torch.zeros(64, device=dev), groups=8),
        "ssd_scan (K7)": lambda: ssd_ops.ssd_scan(x7.clone().requires_grad_(True), dt7, A7,
                                                  B7, C7),
    }
    for name, call in calls.items():
        with torch.enable_grad():
            try:
                call()
            except ValueError as e:
                print(f"  {name} under grad mode on an input that requires grad raises: "
                      f"{str(e).split('.')[0]}")
            else:
                fail(f"{name} launched under grad mode on an input that requires grad")
    torch.cuda.synchronize()
    if counters() != before:
        fail(f"a refused call was counted as a launch: {before} -> {counters()}")
    with torch.no_grad():
        calls["flash_attention (K3)"]()
    if flash_ops.launches != before[3] + 1:
        fail("flash attention under no_grad did not launch")
    return {"solver_step": k1_err}


def train_and_tables(dev, card: str) -> dict:
    """The training slice on the card (the new phase): DIT_100M trained
    for DIT_STEPS steps, checkpointed, reloaded and sampled through K1 and
    K3; the two TOY_MLP nets; Tables 1, 3 and 4–5 with their launch rules
    and gates (a)–(d); K1 timed at Table 1's state; the device
    idle share of one Table-1 EM-1000 solve. Returns what the kernels
    line reports."""
    import shutil
    import tempfile

    from repro_torch.benchmarks import common as bench
    from repro_torch.benchmarks import table1_solver_grid as t1
    from repro_torch.benchmarks import table3_offtheshelf as t3
    from repro_torch.benchmarks import table45_ablations as t45
    from repro_torch.core.sampling import sample
    from repro_torch.core.sde import VPSDE
    from repro_torch.benchmarks import loop_condition
    from repro_torch.examples import train_diffusion
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref
    from repro_torch.models.dit import make_score_fn

    t_phase = time.perf_counter()

    # DIT_100M: train, checkpoint, reload, sample
    ckpt = tempfile.mkdtemp(prefix="dit100m_")
    try:
        run = train_diffusion.train("100m", steps=DIT_STEPS, batch=DIT_BATCH, device=dev,
                                    ckpt_dir=ckpt, log_every=5)
        losses, ms = run.losses, run.ms_per_step
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            fail("TF32 is on: the training's products were not fp32")
        n_params = sum(p.numel() for p in run.model.parameters())
        flops = dit_train_flops(run.model.cfg, DIT_BATCH)
        median = float(np.median(ms[1:]))
        print(f"  [{card}] DIT_100M ({n_params:,} parameters) {DIT_STEPS} steps at batch "
              f"{DIT_BATCH}, fp32, TF32 off: loss {losses[0]:.2f} -> {losses[-1]:.2f}; ms per "
              f"step: first {ms[0]:.1f}, median of the rest {median:.1f}; {flops / 1e12:.3f} "
              f"TFLOP a step, {flops / median / 1e9:.1f} TFLOP/s at the median; "
              f"peak allocated {run.peak_bytes / 2**30:.2f} GiB")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"DIT_100M training: losses {losses.tolist()}")
        model = train_diffusion.load_trained(ckpt, "100m", dev)
        same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                       run.model.state_dict().values()))
        if not same:
            fail("the reloaded DIT_100M checkpoint differs from the trained EMA weights")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del run
    sde = VPSDE()
    score = make_score_fn(model, sde)
    shape = (8, model.cfg.image_size, model.cfg.image_size, model.cfg.channels)
    step_ops.launches = flash_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sample(sde, score, shape, seed=0, method="adaptive", eps_rel=0.05,
                 use_fused_kernel=True, max_iters=MAIN_MAX_ITERS, device=dev)
    torch.cuda.synchronize()
    dit_wall = time.perf_counter() - t0
    dit_launches = {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches}
    dit_iters = int(res.iterations)
    print(f"  trained DIT_100M, reloaded, 8 adaptive samples at eps_rel 0.05 (K1, K3): "
          f"{dit_iters} iterations, mean NFE {float(res.mean_nfe):.2f}, {dit_wall:.3f} s; "
          f"launches {dit_launches}; finite {bool(torch.isfinite(res.x).all())}")
    if (not torch.isfinite(res.x).all() or tuple(res.x.shape) != shape
            or dit_launches["solver_step"] < dit_iters
            or dit_launches["flash_attention"] < dit_iters):
        fail("sampling from the trained DIT_100M")
    del model, score, res
    torch.cuda.empty_cache()

    # the two TOY_MLP nets of the tables (cached for them)
    for process in ("vp", "ve"):
        net = bench.trained_mlp(process, 600, 0, dev)
        print(f"  [{card}] TOY_MLP on GMM2D, {process}: 600 steps in {net.seconds:.2f} s; loss "
              f"first {net.losses[0]:.4f}, mean of the last 50 {net.losses[-50:].mean():.4f}")
        if not np.isfinite(net.losses).all() or net.losses[-50:].mean() >= net.losses[0]:
            fail(f"TOY_MLP {process} training did not lower the loss")

    # the tables, every row printed with its launches
    tables = {"table1": t1.run("vp", dev) + t1.run("ve", dev), "table3": t3.run(dev),
              "table45": t45.run(dev)}
    derived = {"table1": t1.derived, "table3": t3.derived, "table45": t45.derived}
    k1_total = k5_total = 0
    for tname, rows in tables.items():
        for r in rows:
            line = bench.csv_row(r["name"], r["us"], derived[tname](r))
            if "nfe" not in r:  # a derived (slowdown) row
                print(f"  {line}")
                continue
            k1, k5 = r["launches"]["solver_step"], r["launches"]["em_step"]
            print(f"  {line};iterations={r['iterations']};w2g={r['w2g']:.4f};K1={k1};K5={k5};"
                  f"captures={r['captures']};host_reads={r['host_reads']}")
            if r["captures"] or r["host_reads"] != 1:
                fail(f"{r['name']}: the timed row captured {r['captures']} graphs and read "
                     f"the host {r['host_reads']} times (want a replay: 0 and 1)")
            finite = r["finite"] and all(math.isfinite(r[f])
                                         for f in ("us", "nfe", "frechet", "sw2", "w2g"))
            if not finite:
                fail(f"gate (a): {r['name']} is not finite")
            want_k5 = {"em": r["n_steps"], "pc": 2 * (r["n_steps"] or 0),
                       "pc_hmc": r["n_steps"]}.get(r["method"], 0)
            if k5 != want_k5:
                fail(f"{r['name']}: {k5} K5 launches, want exactly {want_k5}")
            if r["method"] == "adaptive" and r["fused"]:
                # one launch an iteration: a timed row replays its graph,
                # which stops at the last iteration with a sample active (the
                # host-driven chain's whole groups of SYNC_EVERY would add the
                # last group's tail), and no capture's warm-up adds one
                want_k1 = r["iterations"]
                if k1 != want_k1:
                    fail(f"{r['name']}: {k1} K1 launches, want {want_k1} for "
                         f"{r['iterations']} iterations")
            elif k1 != 0:
                fail(f"{r['name']}: {k1} K1 launches on a path without the fused step")
            k1_total, k5_total = k1_total + k1, k5_total + k5

    # gates (b)-(d) on Table 1
    by = {r["name"]: r for r in tables["table1"]}
    for process in ("vp", "ve"):
        ours = by[f"table1/{process}/ours-eps0.05"]
        em_m = by[f"table1/{process}/em-match-eps0.05"]
        print(f"  Table 1 {process}, eps_rel 0.05: w2g adaptive {ours['w2g']:.4f}, EM at the "
              f"matched NFE {em_m['w2g']:.4f} (the reference's CPU run: "
              f"{REF_TABLE1_W2G[process][0]:.4f} and {REF_TABLE1_W2G[process][1]:.4f}); not a "
              f"gate, the reference misses the +0.15 rule here itself")
        if not ours["nfe"] <= 0.5 * 1000:
            fail(f"gate (c): adaptive at eps_rel 0.05 on {process} spends {ours['nfe']} NFE, "
                 f"more than half of EM-1000's 1000")
        for eps, ref_nfe in REF_TABLE1_NFE[process].items():
            got = by[f"table1/{process}/ours-eps{eps}"]["nfe"]
            ok = abs(got - ref_nfe) <= NFE_BAND * ref_nfe
            print(f"  gate (d) {process} eps_rel {eps}: mean NFE {got:.2f}, the reference's CPU "
                  f"run {ref_nfe:.2f}, within {NFE_BAND:.0%}: {ok}")
            if not ok:
                fail(f"gate (d): {process} eps_rel {eps} mean NFE {got} outside the band")
    # Table 1's adaptive rows again: the replayed graph against the
    # host-driven chain on the same streams, both timed
    t1_walls = loop_condition.table1_adaptive_walls(dev)
    for w in t1_walls:
        print(f"  [{card}] {w['name']}: replayed {w['replay_us']:.1f} us, host-driven chain "
              f"{w['host_us']:.1f} us ({w['host_us'] / w['replay_us']:.2f}x); "
              f"{w['iterations']} iterations; K1 replayed {w['k1_replay']}, host-driven "
              f"{w['k1_host']}; bitwise {w['bitwise']}")
        if not w["bitwise"] or w["k1_replay"] != w["iterations"]:
            fail(f"{w['name']}: the replayed row is not the host-driven chain bitwise, or K1 "
                 f"ran {w['k1_replay']} times for {w['iterations']} iterations")
    gate_b = e2e_rule(dev)
    check_sample_chunked(dev, *bench.trained_mlp_score("vp", 600, 0, dev))

    # K1 at Table 1's state, timed
    b, d = t1.N_SAMPLES, 2
    gen = torch.Generator(device=dev).manual_seed(5)
    sets = []
    for _ in range(8):
        states = [torch.randn(b, d, generator=gen, device=dev) for _ in range(5)]
        coeffs = [torch.rand(b, generator=gen, device=dev) for _ in range(3)]
        eps = [step_ops.per_sample_tolerance(e, b, dev) for e in (2 / 256, 0.05)]
        sets.append((*states, *coeffs, *eps))
    k1 = lambda *a: step_ops.error_step(*a[:8], eps_abs=a[8], eps_rel=a[9])
    k1_ms, k1_plain = device_ms(k1, sets), device_ms(lambda *a: step_ref.error_step(*a), sets)
    k1_bytes = 6 * b * d * 4 + 6 * b * 4
    k1_ops = STEP_FLOPS_PER_ELEMENT * b * d
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_FLOPS) * 1e3
    print(f"  [{card}] at Table 1's state {(b, d)} fp32: solver_step {k1_ms * 1e3:.2f} us on the "
          f"device (bound {k1_bound * 1e3:.3f} us, bytes; plain {k1_plain * 1e3:.1f} us)")
    # the device idle share of one Table-1 EM-1000 row (VP, N 4096)
    from repro_torch.benchmarks import kernel_times
    idle = kernel_times.table1_em_idle(dev)
    print(f"  [{card}] Table 1 EM-1000 at N 4096 (VP): graphed wall "
          f"{idle['graphed_wall_ms']:.1f} ms, its driver window {idle['window_ms']:.1f} ms on "
          f"the device (CUDA events; window share {idle['window_share']:.3f}); host-driven "
          f"wall {idle['wall_ms']:.1f} ms, device busy {idle['busy_ms']:.2f} ms (K5 "
          f"{idle['em_step_ms']:.3f} ms; torch.profiler), idle share {idle['idle_share']:.3f}; "
          f"graphed wall / busy {idle['graphed_wall_ms'] / idle['busy_ms']:.2f}")
    captures = {t: [r["captures"] for r in rows if "captures" in r] for t, rows in tables.items()}
    print(f"  captures in the timed rows: {captures}")
    wall = time.perf_counter() - t_phase
    print(f"  [{card}] train and tables: {wall:.1f} s; K1 launches over the tables' adaptive "
          f"rows {k1_total}, K5 launches over their EM and PC rows {k5_total}")
    return {"dit_launches": dit_launches, "dit_iterations": dit_iters,
            "k1_tables": k1_total, "k5_tables": k5_total, "gate_b": gate_b,
            "table1_walls": t1_walls,
            "captures": captures,
            "k1_t1": dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound),
            "em1000_idle": idle}


def check_sample_chunked(dev, sde, score_fn) -> None:
    """``sample_chunked`` at Table 1's size, N 4096 in chunks of 1024,
    from the VP TOY_MLP: each chunk's bits are those of a ``sample`` call
    with its seed, and the launches are exactly theirs (K5 one an EM
    step; K1 the count of the chunks' own solves, which replay, plus the
    masked tail of ``sample_chunked``'s first chunk, which runs
    host-driven in whole groups of SYNC_EVERY): the pinned copies on the
    side stream add none."""
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.core.sampling import chunk_seeds, sample, sample_chunked
    from repro_torch.kernels.solver_step import ops as step_ops

    for method, kw in (("em", dict(n_steps=100)),
                       ("adaptive", dict(eps_rel=0.05, use_fused_kernel=True))):
        # the chunks share one key: the first sample() runs host-driven, the
        # second captures, the rest replay; a capture's warm-up adds one
        # launch (K5 for EM's one step, K1 for Algorithm 1's one iteration),
        # taken off both sides
        def counts(c0):
            warm = captured_warmups(c0)
            return (step_ops.launches - (warm if method == "adaptive" else 0),
                    step_ops.em_launches - (warm if method == "em" else 0))

        step_ops.launches = step_ops.em_launches = 0
        c0 = ad.captures
        x, mean_nfe = sample_chunked(sde, score_fn, 4096, (2,), seed=3, chunk=1024,
                                     method=method, device=dev, **kw)
        got = counts(c0)
        step_ops.launches = step_ops.em_launches = 0
        c0 = ad.captures
        parts = [sample(sde, score_fn, (1024, 2), seed=s, method=method, device=dev, **kw)
                 for s in chunk_seeds(3, 4)]
        its = int(parts[0].iterations)
        tail = ad.SYNC_EVERY * -(-its // ad.SYNC_EVERY) - its if method == "adaptive" else 0
        k1, k5 = counts(c0)
        want = (k1 + tail, k5)
        same = np.array_equal(x, np.concatenate([p.x.cpu().numpy() for p in parts]))
        print(f"  sample_chunked {method} N 4096 in chunks of 1024: mean NFE {mean_nfe:.2f}, "
              f"launches (K1, K5) {got}, the four chunks' own solves {(k1, k5)} + the first "
              f"chunk's host-driven tail {tail} = {want}, the same bits {same}")
        if got != want or not same or (method == "em" and got != (0, 400)):
            fail(f"sample_chunked ({method}) launched {got}, its chunks {want}; bits {same}")


def e2e_rule(dev) -> dict:
    """Gate (b): the reference's end-to-end rule
    (``tests/test_e2e_diffusion.py``) on its own setting, on the card: an
    MLP (hidden 96) trained 400 steps at batch 256 (EMA 0.99) on the
    2-mode mixture (means ±1.5, std 0.3); adaptive at eps_rel 0.05 and EM
    at 500 steps each within w2_gaussianized 0.35 of 1024 data draws, and
    adaptive no worse than EM at half its NFE in steps + 0.15."""
    from repro_torch.benchmarks import common as bench
    from repro_torch.core.sampling import sample
    from repro_torch.data.images import GMM2D
    from repro_torch.models.score_unet import MLPScoreConfig, init_mlp_score

    gmm = GMM2D(means=((-1.5, 0.0), (1.5, 0.0)), std=0.3, weights=(0.5, 0.5))
    model = init_mlp_score(MLPScoreConfig(dim=2, hidden=96, depth=3),
                           torch.Generator(device=dev).manual_seed(0))
    net = bench.train_mlp("vp", 400, 0, dev, batch=256, model=model, data=gmm, ema_decay=0.99)
    data = gmm.sample(torch.Generator().manual_seed(9), 1024).numpy()
    w2 = lambda r: bench.w2_gaussianized(r.x.cpu().numpy(), data)
    ad = sample(net.sde, net.score_fn, (1024, 2), seed=0, method="adaptive", eps_rel=0.05,
                use_fused_kernel=True, device=dev)
    nfe = int(float(ad.mean_nfe))
    em = sample(net.sde, net.score_fn, (1024, 2), seed=0, method="em",
                n_steps=max(nfe // 2, 2), device=dev)
    em500 = sample(net.sde, net.score_fn, (1024, 2), seed=0, method="em", n_steps=500,
                   device=dev)
    out = dict(adaptive=w2(ad), em_half=w2(em), em_500=w2(em500), nfe=nfe)
    print(f"  gate (b), the reference's e2e rule on its setting: w2g adaptive {out['adaptive']:.4f} "
          f"(NFE {nfe}) <= EM at {max(nfe // 2, 2)} steps {out['em_half']:.4f} + 0.15; adaptive "
          f"and EM-500 ({out['em_500']:.4f}) < 0.35")
    if not (out["adaptive"] <= out["em_half"] + 0.15 and out["adaptive"] < 0.35
            and out["em_500"] < 0.35):
        fail("gate (b): the reference's end-to-end rule fails on the card")
    return out


def run_lm(dev) -> dict:
    """Phase 7: mamba2-2.7b at full width, prefill through K7 and greedy
    serving; returns K7's launch count on the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import forward, init_decode_state, init_model
    from repro_torch.models.transformer import decode_step, param_count

    cfg = get_config("mamba2-2.7b")
    t0 = time.perf_counter()
    params = init_model(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = param_count(params)
    print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.mamba.num_heads(cfg.d_model)} SSD heads of {cfg.mamba.head_dim}, d_state "
          f"{cfg.mamba.d_state}, vocab {cfg.vocab_size}: {n:,} parameters, {n * 4 / 1e9:.2f} GB "
          f"fp32, made in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, LM_PREFILL, generator=g, device=dev)
    prefill = make_prefill_step(cfg, device=dev)  # the default routes the scan through K7
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: the LM's fp32 products would not be fp32")
    prefill(params, {"tokens": prompts[:, :256]})  # cuBLAS and the allocator warm up
    ssd_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    k7_launches = ssd_ops.launches
    n_tok = LM_PREFILL[0] * LM_PREFILL[1]
    print(f"  prefill {LM_PREFILL} through K7: {prefill_s:.3f} s, {n_tok / prefill_s:.0f} "
          f"tokens/s; K7 launches {k7_launches} (want {cfg.num_layers}: one per layer); "
          f"next tokens {nxt[:, 0].tolist()}")
    if k7_launches != cfg.num_layers:
        fail(f"the prefill launched K7 {k7_launches} times, not {cfg.num_layers}")
    if nxt.shape != (LM_PREFILL[0], 1) or not bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()):
        fail(f"prefill tokens {nxt.tolist()} out of range")

    # the same weights through the plain ssd_chunked path: last-position logits
    with torch.no_grad():
        fast, _ = forward(params, prompts, cfg, last_logits_only=True)
        plain, _ = forward(params, prompts, cfg, use_kernel_ssd=False, last_logits_only=True)
    err, scale = (fast - plain).abs().max().item(), plain.abs().max().item()
    finite = bool(torch.isfinite(fast).all())
    print(f"  last-position logits, K7 vs plain ssd_chunked: max abs err {err:.3e} (bound "
          f"{LM_LOGIT_TOL}·max|logit| = {LM_LOGIT_TOL * scale:.3e}), finite {finite}, argmax "
          f"equal {torch.equal(fast.argmax(-1), plain.argmax(-1))}")
    if not (finite and err <= LM_LOGIT_TOL * scale):
        fail("the prefill through K7 disagrees with the plain path")
    # where one prefill's device time goes, and the CUDA kernels a K7 call runs
    ssd_ops.launches = 0
    by_name, total_us = profile_device(lambda: prefill(params, {"tokens": prompts}))
    k7_calls = ssd_ops.launches
    k7_us = sum(us for name, (_, us) in by_name.items() if "ssd_scan" in name)
    k7_kernels = sum(n for name, (n, _) in by_name.items() if "ssd_scan" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"  one prefill: {total_us / 1e3:.1f} ms of device time, K7 {k7_us / 1e3:.1f} ms "
          f"({100 * k7_us / total_us:.1f} %) in {k7_kernels} CUDA kernels over {k7_calls} "
          f"calls; largest: " + "; ".join(
              f"{name[:50]} x{n} {us / 1e3:.1f} ms" for name, (n, us) in top))
    if not k7_calls or not k7_kernels:
        fail("the profiled prefill shows no K7 kernel")
    fp32_logits = fast.cpu()  # phase 9e holds the bf16 prefill against these
    del fast, plain

    # serving: 4 requests, prompt 16, gen 16 (prefill by replay, then greedy),
    # three calls at one key: eager, a capture, a replay (the one-shot rule;
    # the decode state and the step kept across calls)
    B, P, G = LM_SERVE
    sprompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    calls = []
    for _ in range(3):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = serve_batch(cfg, params, sprompts, gen_len=G, device=dev, stats=stats)
        torch.cuda.synchronize()
        calls.append((toks, time.perf_counter() - t0, stats))
    serve_s = calls[2][1]
    step_ms = serve_s / (P + G - 1) * 1e3
    captures = [c[2]["captures"] for c in calls]
    same = all(torch.equal(c[0], toks) for c in calls)
    print(f"  serve_batch three calls at one key: captures {captures} (build "
          f"{calls[1][2]['build_s']:.3f} s), graphed {[c[2]['graphed'] for c in calls]}, tokens "
          f"bitwise {same}; walls {', '.join(f'{c[1]:.3f}' for c in calls)} s (eager, capturing, "
          f"replayed)")
    if captures != [0, 1, 0] or not same:
        fail(f"serve_batch across calls: captures {captures}, tokens bitwise {same}")
    first = make_prefill_step(cfg, device=dev)(params, {"tokens": sprompts})
    print(f"  serve_batch {B} requests, prompt {P}, gen {G}: {serve_s:.3f} s, {step_ms:.2f} ms "
          f"per decode step of {B} ({B * 1e3 / step_ms:.1f} tokens/s); tokens finite "
          f"{toks.shape}; prefill's first tokens {first[:, 0].tolist()}, serve's "
          f"{toks[:, 0].tolist()}")
    if toks.shape != (B, G) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("serve_batch tokens out of range")
    if not torch.equal(first[:, 0], toks[:, 0]):
        fail("the chunked prefill's first token differs from the recurrent decode's")
    # logits: the recurrence over the prompt against the chunked prefill
    with torch.no_grad():
        state = init_decode_state(cfg, B, P + G, device=dev)
        for i in range(P):
            rec_logits, state = decode_step(params, sprompts[:, i:i + 1], state, cfg)
        chunk_logits, _ = forward(params, sprompts, cfg, last_logits_only=True)
    err, scale = (rec_logits - chunk_logits).abs().max().item(), chunk_logits.abs().max().item()
    print(f"  last prompt position: recurrent decode vs chunked prefill logits max abs err "
          f"{err:.3e} (bound {LM_LOGIT_TOL}·max|logit| = {LM_LOGIT_TOL * scale:.3e})")
    if not err <= LM_LOGIT_TOL * scale:
        fail("the recurrent decode's logits disagree with the chunked prefill's")
    # the graphed decode step against the eager one: bitwise, ms a step,
    # device time (the Mamba2 state now written in place)
    decode = decode_gate("mamba2-2.7b", "phase 7", cfg, params, sprompts, dev)
    del params, state
    torch.cuda.empty_cache()
    return {"k7_launches": k7_launches, "k7_cuda_kernels_per_call": k7_kernels / k7_calls,
            "fp32_logits": fp32_logits, "prefill_s": prefill_s,
            "prefill_device_ms": total_us / 1e3, "serve_ms_per_step": step_ms,
            "decode": decode, "serve_calls_s": [c[1] for c in calls],
            "serve_captures": captures}


def top2_gap(logits) -> float:
    """The gap between the largest and the second largest logit of a row."""
    top = torch.topk(logits.float().reshape(-1), 2).values
    return (top[0] - top[1]).item()


def k3_lm_times(dev, gen, card: str, dtype=torch.float32) -> dict:
    """K3 at gemma3-12b's prefill shapes, "L" (causal, window 1024) and "A"
    (causal), in ``dtype``: device time beside its bound (fp32: 3xTF32 on
    the tensor cores over the visible (query, key) pairs; bf16: the bf16
    tensor-core peak over them; bytes), the plain version and SDPA
    (``is_causal`` with ``enable_gqa`` for "A", an explicit boolean mask
    for "L"; a yardstick the port never calls)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref

    B, Hq, Hkv, S, Dh = GEMMA_ATTN
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(S, device=dev)[None, :]
    out = {}
    for kind, window in (("L", GEMMA_WINDOW), ("A", None)):
        sets = [(torch.randn(B, Hq, S, Dh, generator=gen, device=dev).to(dtype),
                 torch.randn(B, Hkv, S, Dh, generator=gen, device=dev).to(dtype),
                 torch.randn(B, Hkv, S, Dh, generator=gen, device=dev).to(dtype))
                for _ in range(2)]
        k3 = lambda q, k, v: flash_ops.attention(q, k, v, causal=True, window=window)
        plain = lambda q, k, v: flash_ref.attention(q, k, v, causal=True, window=window)
        if window is None:
            lib = lambda q, k, v: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        else:
            mask = (kpos <= qpos) & (kpos > qpos - window)
            lib = lambda q, k, v: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
        lib_err = (lib(*sets[0]).float() - plain(*sets[0]).float()).abs().max().item()
        ms = device_ms(k3, sets, reps=6, replays=2)
        plain_ms = device_ms(plain, sets, reps=2, replays=2)
        lib_ms = device_ms(lib, sets, reps=4, replays=2)
        w = S if window is None else window
        pairs = w * (w + 1) // 2 + (S - w) * w  # visible (query, key) pairs
        flops = 4 * B * Hq * pairs * Dh
        nbytes = dtype.itemsize * (2 * B * Hq * S * Dh + 2 * B * Hkv * S * Dh)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        if dtype == torch.float32:  # 3xTF32: three tensor-core products a multiply-add
            t_ops, of = 3 * flops / TF32_FLOPS * 1e3, "3xTF32: 3 x"
        else:
            t_ops, of = flops / BF16_FLOPS * 1e3, "bf16:"
        bound = max(t_bytes, t_ops)
        out[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                         bound_by="bytes" if t_bytes >= bound else "operations",
                         bound_fp32_cuda_cores_ms=max(t_bytes, flops / FP32_FLOPS * 1e3),
                         visible_pairs=pairs, library_max_abs_diff=lib_err)
        print(f"  [{card}] flash_attention {GEMMA_ATTN} causal window={window} "
              f"{str(dtype)[6:]}: {ms:.3f} ms on the device; bound {bound:.3f} ms ({of} "
              f"{flops / 1e9:.1f} GFLOP over {pairs:,} visible pairs; {bound / ms:.0%} of it "
              f"reached; bytes {t_bytes:.3f} ms); plain {plain_ms:.3f} ms; SDPA "
              f"{lib_ms:.3f} ms (max abs diff from the plain version {lib_err:.1e})")
        del sets
    torch.cuda.empty_cache()
    return out


def run_attention_lm(dev, card: str) -> dict:
    """Phase 7b: gemma3-12b at full width (seeded weights, fp32, TF32 off):
    the (1, 4096) prefill through K3 (48 launches, one a layer) against the
    plain attention, ``serve_batch`` and ``ContinuousBatcher`` against solo
    runs; K3's times at the prefill's shapes first. Returns the numbers of
    the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import decode_step, forward, init_decode_state, init_model
    from repro_torch.models.transformer import param_count
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    cfg = get_config("gemma3-12b")
    B, Hq, Hkv, S, Dh = GEMMA_ATTN
    if ((Hq, Hkv, Dh, cfg.sliding_window) != (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                                               GEMMA_WINDOW) or GEMMA_PREFILL != (B, S)):
        fail(f"GEMMA_ATTN {GEMMA_ATTN} is not gemma3-12b's prefill shape")
    times = k3_lm_times(dev, torch.Generator(device=dev).manual_seed(24), card)

    t0 = time.perf_counter()
    params = init_model(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = param_count(params)
    print(f"  {cfg.name}: {cfg.num_layers} layers ({cfg.mixer_pattern.count('L') * cfg.num_repeats}"
          f" sliding-window 'L' of {cfg.sliding_window}, {cfg.mixer_pattern.count('A') * cfg.num_repeats}"
          f" global 'A'), d_model {cfg.d_model}, GQA {cfg.num_heads}:{cfg.num_kv_heads}, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n:,} parameters, "
          f"{n * 4 / 1e9:.2f} GB fp32, {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          f"allocated, made in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, GEMMA_PREFILL, generator=g, device=dev)
    prefill = make_prefill_step(cfg, device=dev)  # the default runs attention through K3
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: the LM's fp32 products would not be fp32")
    prefill(params, {"tokens": prompts[:, :256]})  # cuBLAS and the allocator warm up
    torch.cuda.reset_peak_memory_stats(dev)
    flash_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    k3_launches = flash_ops.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"  prefill {GEMMA_PREFILL} through K3: {prefill_s:.3f} s, "
          f"{GEMMA_PREFILL[1] / prefill_s:.0f} tokens/s, peak allocated {peak:.2f} GiB; K3 "
          f"launches {k3_launches} (want {cfg.num_layers}: one a layer); next token "
          f"{nxt[:, 0].tolist()}")
    if k3_launches != cfg.num_layers:
        fail(f"the prefill launched K3 {k3_launches} times, not {cfg.num_layers}")
    if not bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()):
        fail(f"prefill token {nxt.tolist()} out of range")
    with torch.no_grad():
        fast, _ = forward(params, prompts, cfg, last_logits_only=True)
        t0 = time.perf_counter()
        plain, _ = forward(params, prompts, cfg, use_flash=False, last_logits_only=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    err, scale = (fast - plain).abs().max().item(), plain.abs().max().item()
    bound = LM_LOGIT_TOL * scale
    gap = top2_gap(plain[0, -1])
    same_token = torch.equal(fast.argmax(-1), plain.argmax(-1))
    finite = bool(torch.isfinite(fast).all())
    print(f"  last-position logits, K3 vs the plain attention (prefill {plain_s:.3f} s): max abs "
          f"err {err:.3e} (bound {LM_LOGIT_TOL}·max|logit| = {bound:.3e}), finite {finite}, "
          f"greedy token equal {same_token} (top-2 gap {gap:.3e})")
    if not (finite and err <= bound) or (not same_token and gap > bound):
        fail("the prefill through K3 disagrees with the plain path")
    by_name, total_us = profile_device(lambda: prefill(params, {"tokens": prompts}))
    k3_us = sum(us for name, (_, us) in by_name.items() if "flash_fwd" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    print(f"  one prefill: {total_us / 1e3:.1f} ms of device time, K3 {k3_us / 1e3:.1f} ms "
          f"({100 * k3_us / total_us:.1f} %); largest: " + "; ".join(
              f"{name[:50]} x{c} {us / 1e3:.1f} ms" for name, (c, us) in top))
    fp32_logits = fast.cpu()  # phase 9d holds the bf16 prefill against these
    prefill_device_ms = total_us / 1e3
    del fast, plain

    # serve_batch: 4 requests, prompt 16, gen 16 (prefill by replay, then greedy)
    R, P, G = GEMMA_SERVE
    sprompts = torch.randint(0, cfg.vocab_size, (R, P), generator=g, device=dev)
    for _ in range(2):  # warm-up at the timed call's key: eager, then its capture
        serve_batch(cfg, params, sprompts[:, :2], gen_len=2, cache_len=P + G, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, sprompts, gen_len=G, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    step_ms = serve_s / (P + G - 1) * 1e3
    first = prefill(params, {"tokens": sprompts})
    with torch.no_grad():
        first_logits, _ = forward(params, sprompts, cfg, last_logits_only=True)
    print(f"  serve_batch {R} requests, prompt {P}, gen {G}: {serve_s:.3f} s, {step_ms:.2f} ms "
          f"per decode step of {R} ({R * 1e3 / step_ms:.1f} tokens/s); prefill's first tokens "
          f"{first[:, 0].tolist()}, serve's {toks[:, 0].tolist()}")
    if toks.shape != (R, G) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail("serve_batch tokens out of range")
    for r in range(R):
        gap = top2_gap(first_logits[r, -1])
        if first[r, 0] != toks[r, 0] and gap > LM_LOGIT_TOL * first_logits.abs().max().item():
            fail(f"request {r}: the prefill's first token differs from the decode's at a top-2 "
                 f"gap of {gap:.3e}")

    # the graphed decode step against the eager one
    decode = decode_gate("gemma3-12b", "phase 7b", cfg, params, sprompts, dev)
    idle = decode["decode_idle_share"]

    # the continuous batcher: mixed requests through BATCHER_SLOTS slots
    reqs = [(uid, torch.randint(0, cfg.vocab_size, (p,), generator=g, device=dev), m)
            for uid, (p, m) in enumerate(BATCHER_REQUESTS)]
    drains = {}
    for graphed in (True, False):  # the graphed step, then its eager one
        b = ContinuousBatcher(cfg, params, slots=BATCHER_SLOTS, cache_len=BATCHER_CACHE,
                              device=dev)
        if not graphed:
            b.step_fn = b.step_fn.eager
        for uid, p, m in reqs:
            b.submit(Request(uid=uid, prompt=p.cpu().numpy(), max_new_tokens=m))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = b.run_to_completion()
        torch.cuda.synchronize()
        drains[graphed] = (b, done, time.perf_counter() - t0)
    (b, done, batch_s), (be, done_e, batch_e) = drains[True], drains[False]
    n_new = sum(m for _, _, m in reqs)
    same_drain = list(done) == list(done_e) and all(
        done[u].output == done_e[u].output for u in done)
    print(f"  ContinuousBatcher: {len(reqs)} requests (prompt, gen) {list(BATCHER_REQUESTS)} "
          f"through {BATCHER_SLOTS} slots: {b.total_steps} steps in {batch_s:.3f} s graphed "
          f"({batch_s / b.total_steps * 1e3:.2f} ms a step, {n_new / batch_s:.1f} new tokens/s; "
          f"captures {b.captures}, build {b.build_s:.3f} s), eager {batch_e:.3f} s "
          f"({batch_e / be.total_steps * 1e3:.2f} ms a step); request for request bitwise the "
          f"eager drain {same_drain}; wasted_step_fraction {b.wasted_step_fraction:.4f}, "
          f"finishing order {list(done)}")
    if len(done) != len(reqs) or b.total_steps >= BATCHER_CACHE:
        fail(f"the batcher finished {len(done)} of {len(reqs)} requests in {b.total_steps} steps")
    if not same_drain or b.captures != 1:
        fail(f"the graphed batcher's drain is not the eager one's (captures {b.captures})")
    differ = 0
    for uid, p, m in reqs:
        solo = serve_batch(cfg, params, p[None], gen_len=m, device=dev)[0].tolist()
        got = done[uid].output
        if got == solo:
            continue
        j = next(i for i, (a, c) in enumerate(zip(got, solo)) if a != c)
        # the solo run's logits at the first differing position
        state = init_decode_state(cfg, 1, p.numel() + m, device=dev)
        with torch.no_grad():
            for tok in torch.cat([p, torch.tensor(solo[:j], device=dev, dtype=p.dtype)]):
                logits, state = decode_step(params, tok.view(1, 1), state, cfg)
        gap, lbound = top2_gap(logits[0, -1]), LM_LOGIT_TOL * logits.abs().max().item()
        differ += 1
        print(f"  request {uid}: batched {got} vs solo {solo} differ first at {j}, where the "
              f"solo top-2 gap is {gap:.3e} (bound {lbound:.3e})")
        if gap > lbound:
            fail(f"request {uid}: the batcher's tokens differ from its solo run's past the bound")
    print(f"  every batched request equals its solo serve_batch tokens"
          + (f" up to a near tie ({differ} requests)" if differ else ""))
    rec = {"k3": times, "launches": k3_launches, "prefill_s": prefill_s,
           "plain_prefill_s": plain_s, "params": n, "peak_gib": peak, "logit_err": err,
           "serve_ms_per_step": step_ms, "decode_idle_share": idle,
           "decode_device_ms_per_step": decode["decode_device_ms_per_step"], "decode": decode,
           "batcher_s": batch_s, "batcher_eager_s": batch_e, "batcher_steps": b.total_steps,
           "batcher_build_s": b.build_s,
           "wasted_step_fraction": b.wasted_step_fraction,
           "batcher_tokens_per_s": n_new / batch_s, "differ": differ,
           "fp32_logits": fp32_logits, "prefill_device_ms": prefill_device_ms}
    del params, b, be
    torch.cuda.empty_cache()
    return rec


def run_diffusion_lm(dev) -> dict:
    """Phase 7c: the diffusion LM on olmo-1b's backbone at full width
    (seeded weights, ``out_proj`` livened), VP, adaptive at DLM_EPS_REL with
    the fused step: K1 exactly once an iteration in whole groups of 8.
    Returns the numbers of the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.core.sde import VPSDE
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.models import diffusion_lm as dlm
    from repro_torch.models.transformer import param_count

    B, S, De = DLM_SHAPE
    cfg = dlm.DiffusionLMConfig(backbone=get_config("olmo-1b"), embed_dim=De)
    params = dlm.init_diffusion_lm(cfg, 0, device=dev)
    dlm.liven(params, torch.Generator(device=dev).manual_seed(0))
    bb = cfg.backbone
    print(f"  diffusion LM on {bb.name}'s backbone ({bb.num_repeats} layers, d_model "
          f"{bb.d_model}, {bb.num_heads} heads, d_ff {bb.d_ff}, {bb.norm_type}, vocab "
          f"{bb.vocab_size}; embed_dim {De}): {param_count(params):,} parameters; batch {B} x "
          f"{S} tokens, VP, eps_rel {DLM_EPS_REL}")
    sde = VPSDE()
    kw = dict(method="adaptive", device=dev, eps_rel=DLM_EPS_REL, use_fused_kernel=True,
              max_iters=MAIN_MAX_ITERS)
    dlm.generate(params, cfg, sde, B, S, seed=1, **{**kw, "max_iters": 8})  # warm-up
    step_ops.launches = 0
    c0, r0 = ad.captures, ad.host_syncs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, res = dlm.generate(params, cfg, sde, B, S, seed=0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = step_ops.launches
    iters = int(res.iterations)
    # generate() makes its score function anew, a new key: host-driven, in
    # whole groups of SYNC_EVERY (graphed, the iterations and a capture's
    # warm-up)
    want = body_iterations(iters, r0, c0)
    nfe, acc, rej = res.nfe, res.accepted, res.rejected
    print(f"  generate: {iters} iterations, mean NFE {float(res.mean_nfe):.2f}, accepted "
          f"{int(acc.sum())}, rejected {int(rej.sum())}, wall {wall:.3f} s "
          f"({wall / (2 * iters) * 1e3:.2f} ms a batch forward, two an iteration); K1 launches "
          f"{k1} (want {want}: 8·⌈iterations/8⌉ host-driven, the iterations graphed, + a "
          f"capture's warm-up); tokens "
          f"{tuple(toks.shape)}, first row "
          f"{toks[0, :12].tolist()}")
    if k1 != want:
        fail(f"the diffusion LM's solve launched K1 {k1} times, not {want}")
    if not (bool(torch.isfinite(res.x).all()) and toks.shape == (B, S)
            and bool(((toks >= 0) & (toks < bb.vocab_size)).all())):
        fail("the diffusion LM's sample is not finite or its tokens are out of range")
    if not torch.equal(nfe, 2 * (acc + rej) + 1):
        fail(f"NFE {nfe.tolist()} is not 2·(accepted + rejected) + 1 (the denoise)")
    if iters >= MAIN_MAX_ITERS:
        fail(f"the diffusion LM's solve did not converge in {MAIN_MAX_ITERS} iterations")
    del params
    torch.cuda.empty_cache()
    # K1 at the solve's state (B, S·embed_dim), timed beside its bytes bound
    from repro_torch.kernels.solver_step import ref as step_ref
    b, d = B, S * De
    gen = torch.Generator(device=dev).manual_seed(7)
    sets = []
    for _ in range(8):
        states = [torch.randn(b, d, generator=gen, device=dev) for _ in range(5)]
        coeffs = [torch.rand(b, generator=gen, device=dev) for _ in range(3)]
        eps = [step_ops.per_sample_tolerance(e, b, dev) for e in (0.0078, DLM_EPS_REL)]
        sets.append((*states, *coeffs, *eps))
    k1_fn = lambda *a: step_ops.error_step(*a[:8], eps_abs=a[8], eps_rel=a[9])
    k1_ms = device_ms(k1_fn, sets)
    k1_plain = device_ms(lambda *a: step_ref.error_step(*a), sets)
    k1_bytes = 6 * b * d * 4 + 6 * b * 4
    k1_t_bytes = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_bound = max(k1_t_bytes, STEP_FLOPS_PER_ELEMENT * b * d / FP32_FLOPS * 1e3)
    print(f"  K1 at the solve's state {(b, d)} fp32: {k1_ms * 1e3:.2f} us on the device (bound "
          f"{k1_bound * 1e3:.3f} us by {'bytes' if k1_t_bytes >= k1_bound else 'operations'}: "
          f"{k1_bytes / 1e6:.3f} MB at 3.35 TB/s); plain {k1_plain * 1e3:.1f} us")
    return {"launches": k1, "iterations": iters, "mean_nfe": float(res.mean_nfe),
            "wall_s": wall, "ms_per_batch_forward": wall / (2 * iters) * 1e3,
            "shape": [b, d], "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
            "bound_by": "bytes" if k1_t_bytes >= k1_bound else "operations"}


def attention_bound(shape) -> dict:
    """K3's least time at ``shape`` (B, Hq, Hkv, S, D), causal, fp32: 3xTF32
    on the tensor cores over the visible (query, key) pairs (QKᵀ and PV,
    two flops a multiply-add), or each operand read once and the output
    written once at 3.35 TB/s, whichever is larger."""
    B, Hq, Hkv, S, D = shape
    pairs = S * (S + 1) // 2
    flops = 4 * B * Hq * pairs * D
    t_bytes = 4 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D) / HBM_BYTES_PER_S * 1e3
    bound = max(t_bytes, 3 * flops / TF32_FLOPS * 1e3)
    return {"bound_ms": bound, "bound_by": "bytes" if t_bytes >= bound else "operations",
            "visible_pairs": pairs, "gflop": flops / 1e9}


def moe_kernel_times(dev, card: str) -> dict:
    """K3 at the three MoE LMs' prefill shapes and K7 at jamba's "M"
    layers (``kernel_times``), each beside its bound, its plain version and
    (K3) SDPA."""
    from repro_torch.benchmarks import kernel_times

    gen = torch.Generator(device=dev).manual_seed(25)
    k3 = {}
    for name, shape in kernel_times.MOE_ATTN_SHAPES.items():
        t = {**kernel_times.causal_attention_times(dev, gen, shape), **attention_bound(shape)}
        k3[name] = t
        print(f"  [{card}] flash_attention {shape} causal fp32 ({name}): {t['ms']:.3f} ms on "
              f"the device; bound {t['bound_ms']:.3f} ms (3xTF32: 3 x {t['gflop']:.1f} GFLOP "
              f"over {t['visible_pairs']:,} visible pairs at 495 TFLOP/s; {t['bound_ms'] / t['ms']:.0%}"
              f" of it reached); plain {t['plain_ms']:.3f} ms; SDPA {t['library_ms']:.3f} ms "
              f"(max abs diff from the plain version {t['library_max_abs_diff']:.1e})")
    shape = kernel_times.JAMBA_SSD_SHAPE
    if shape not in SSD_SHAPES:
        fail(f"jamba's K7 shape {shape} is not held against the plain version in phase 2")
    k7 = kernel_times.ssd_times(dev, gen, shape)
    flops, nbytes = ssd_work(*shape)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    k7["bound_ms"] = max(t_bytes, 3 * flops / TF32_FLOPS * 1e3)
    k7["bound_by"] = "bytes" if t_bytes >= k7["bound_ms"] else "operations"
    print(f"  [{card}] ssd_scan {shape} fp32 (jamba's 'M' layers, {k7['ranges']} ranges a "
          f"sequence): {k7['ms']:.3f} ms on the device; bound {k7['bound_ms']:.4f} ms by "
          f"{k7['bound_by']} ({nbytes / 1e6:.1f} MB at 3.35 TB/s; 3 x {flops / 1e9:.2f} GFLOP "
          f"at 495 TFLOP/s); plain {k7['plain_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return {"k3": k3, "k7": k7}


def routing_rows(rec: dict):
    """One "E" call's routing record as per-token rows over the true T
    tokens: experts (T, k), kept (T, k), margin (T,)."""
    n, g, k = rec["expert_idx"].shape
    T = rec["tokens"]
    kept = rec["keep"].reshape(n, k, g).transpose(1, 2).reshape(-1, k)[:T]
    return rec["expert_idx"].reshape(-1, k)[:T], kept, rec["margin"].reshape(-1)[:T]


def dropped_share(records: list) -> float:
    """The share of the true tokens' routing decisions over every "E"
    layer of a run that found its expert full (capacity)."""
    kept = total = 0
    for rec in records:
        _, k, _ = routing_rows(rec)
        kept += int(k.sum())
        total += k.numel()
    return 1 - kept / total


def hold_moe_logits(label: str, fast, plain, rec_fast: list, rec_plain: list) -> dict:
    """Last-position logits of two fp32 paths through an MoE LM (B 1), as
    phase 7b holds them: within LM_LOGIT_TOL·max|logit| with the same
    greedy token (or a top-2 gap within that bound). Routing is
    discontinuous, so where they miss, the routing decisions of the two
    runs are compared layer by layer: the first "E" layer where any
    differs must differ only in tokens whose top-k choice is a near tie
    (a margin below NEAR_TIE of the token's largest probability, in
    either run; each printed); what differs after it follows from it
    (counted). Returns the numbers."""
    err, scale = (fast - plain).abs().max().item(), plain.abs().max().item()
    bound = LM_LOGIT_TOL * scale
    gap = top2_gap(plain[0, -1])
    same = torch.equal(fast.argmax(-1), plain.argmax(-1))
    per_layer = []
    for a, b in zip(rec_fast, rec_plain):
        ea, ka, ma = routing_rows(a)
        eb, kb, mb = routing_rows(b)
        moved = (ea != eb).any(-1)
        per_layer.append((int(moved.sum()), int(((ka != kb).any(-1) & ~moved).sum()),
                          torch.minimum(ma, mb)[moved].tolist()))
    flips = sum(m for m, _, _ in per_layer)
    print(f"  {label}: last-position logits max abs err {err:.3e} (bound {LM_LOGIT_TOL}·max|logit|"
          f" = {bound:.3e}), greedy token equal {same} (top-2 gap {gap:.3e}); routing decisions "
          f"that differ: {flips} tokens over {len(per_layer)} 'E' layers")
    if not bool(torch.isfinite(fast).all()):
        fail(f"{label}: non-finite logits")
    out = {"logit_err": err, "bound": bound, "routing_flips": flips, "first_flip_layer": None}
    if err <= bound and (same or gap <= bound):
        return out
    first = next((i for i, (m, kd, _) in enumerate(per_layer) if m or kd), None)
    if first is None:
        fail(f"{label}: the logits miss the bound with the same routing in every layer")
    moved, kept_only, margins = per_layer[first]
    print(f"  {label}: first differing 'E' layer {first}: {moved} tokens change experts, "
          f"{kept_only} more only kept/dropped; their top-k margins: "
          + ", ".join(f"{m:.2e}" for m in margins))
    if not moved or max(margins) >= NEAR_TIE:
        fail(f"{label}: the logits miss the bound and the first differing routing is not a near "
             f"tie (margins {margins}, want < {NEAR_TIE})")
    out.update(first_flip_layer=first, first_layer_margins=margins)
    return out


def moe_profile_split(fn, attempts: int = 3) -> dict:
    """One run of ``fn`` under torch.profiler with the MoE pieces annotated
    (``record_function`` around ``moe._route_common``, the dispatch and
    ``moe._expert_ffn``, patched for the traced run only): device ms of
    K3, of the expert products, of the dispatch and combine products (the
    dispatch less the experts), of the router, and of the rest. A kernel
    is charged to the innermost annotation whose device span (the trace's
    gpu_user_annotation records) holds its start. A trace without device
    records or spans (CUPTI can lose them) is taken again, up to
    ``attempts``; after that the split is not measured, which fails
    nothing."""
    from repro_torch.models import moe

    labels = {"_route_common": "moe:router", "_dispatch_einsum": "moe:dispatch",
              "_dispatch_gather": "moe:dispatch", "_expert_ffn": "moe:experts"}
    saved = {n: getattr(moe, n) for n in labels}

    def annotate(label, f):
        def run(*a, **kw):
            with torch.profiler.record_function(label):
                return f(*a, **kw)
        return run

    act = torch.profiler.ProfilerActivity
    for attempt in range(1, attempts + 1):
        try:
            for n, label in labels.items():
                setattr(moe, n, annotate(label, saved[n]))
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        finally:
            for n, f in saved.items():
                setattr(moe, n, f)
        spans, kernels = [], []
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                (spans if e.name in labels.values() else kernels).append(e)
        if spans and kernels:
            break
        print(f"  torch.profiler: trace {attempt} of {attempts} holds {len(kernels)} device "
              f"records and {len(spans)} annotation spans")
    else:
        return {"method": "not measured"}
    part = {"moe:experts": 0.0, "moe:dispatch": 0.0, "moe:router": 0.0}
    k3 = 0.0
    for e in kernels:
        t = e.time_range.start
        inner = [s for s in spans if s.time_range.start <= t < s.time_range.end]
        if "flash_fwd" in e.name:
            k3 += e.device_time_total
        elif inner:
            part[max(inner, key=lambda s: s.time_range.start).name] += e.device_time_total
    total = sum(e.device_time_total for e in kernels)
    return {"method": "device spans", "total_ms": total / 1e3, "k3_ms": k3 / 1e3,
            "experts_ms": part["moe:experts"] / 1e3,
            "dispatch_combine_ms": part["moe:dispatch"] / 1e3,
            "router_ms": part["moe:router"] / 1e3,
            "rest_ms": (total - k3 - sum(part.values())) / 1e3}


def moe_prefill(cfg, params, prompts, dev, *, k3: int, k7: int = 0) -> dict:
    """``make_prefill_step`` on ``prompts`` (the default: attention through
    K3, SSD through K7), warm first: the counts set to 0 just before and
    read just after (exactly ``k3`` and ``k7``), the wall, the peak
    allocated memory; then the last-position logits against the plain
    paths (``use_flash=False``, ``use_kernel_ssd=False``), routing
    recorded in both runs (``hold_moe_logits``)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import forward

    prefill = make_prefill_step(cfg, device=dev)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: the LM's fp32 products would not be fp32")
    prefill(params, {"tokens": prompts[:, :256]})  # cuBLAS and the allocator warm up
    torch.cuda.reset_peak_memory_stats(dev)
    flash_ops.launches = ssd_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"K3": flash_ops.launches, "K7": ssd_ops.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    S = prompts.shape[1]
    print(f"  prefill {tuple(prompts.shape)}: {wall:.3f} s, {S / wall:.0f} tokens/s, peak "
          f"allocated {peak:.2f} GiB; launches K3 {got['K3']} (want {k3}), K7 {got['K7']} (want "
          f"{k7}); next token {nxt[:, 0].tolist()}")
    if got != {"K3": k3, "K7": k7}:
        fail(f"{cfg.name}'s prefill launched {got}, not K3 {k3} and K7 {k7}")
    if not bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()):
        fail(f"prefill token {nxt.tolist()} out of range")
    rec_fast, rec_plain = [], []
    with torch.no_grad():
        fast, aux = forward(params, prompts, cfg, last_logits_only=True, moe_routing=rec_fast)
        t0 = time.perf_counter()
        plain, _ = forward(params, prompts, cfg, use_flash=False, use_kernel_ssd=False,
                           last_logits_only=True, moe_routing=rec_plain)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    held = hold_moe_logits(f"{cfg.name} kernels vs plain paths (plain prefill {plain_s:.3f} s)",
                           fast, plain, rec_fast, rec_plain)
    if not torch.equal(nxt, fast[:, -1:].argmax(-1).to(torch.int32)):
        fail(f"{cfg.name}: the prefill step's token is not its forward's")
    drop = dropped_share(rec_fast)
    print(f"  aux loss {aux.item():.6f}; dropped share of the prefill's routing decisions "
          f"(capacity) {drop:.4f}")
    return {"prefill_s": wall, "plain_prefill_s": plain_s, "peak_gib": peak, "launches": got,
            "aux": aux.item(), "prefill_dropped_share": drop, "logits": fast,
            "routing": rec_fast, **held}


def moe_serve(cfg, params, gen, dev, card: str) -> dict:
    """``serve_batch`` for MOE_SERVE requests (prompt + gen) after a warm-up:
    ms a decode step, tokens in range. Its first tokens are printed beside
    the prefill's, not gated: the prefill routes the prompts' tokens in
    one group, a decode step the batch's tokens, at other capacities."""
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step

    R, P, G = MOE_SERVE
    prompts = torch.randint(0, cfg.vocab_size, (R, P), generator=gen, device=dev)
    for _ in range(2):  # warm-up at the timed call's key: eager, then its capture
        serve_batch(cfg, params, prompts[:, :2], gen_len=2, cache_len=P + G, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, prompts, gen_len=G, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = wall / (P + G - 1) * 1e3
    first = make_prefill_step(cfg, device=dev)(params, {"tokens": prompts})
    print(f"  [{card}] serve_batch {R} requests, prompt {P}, gen {G}: {wall:.3f} s, {step_ms:.2f} "
          f"ms per decode step of {R} ({R * 1e3 / step_ms:.1f} tokens/s); first tokens: serve's "
          f"{toks[:, 0].tolist()}, the prefill's {first[:, 0].tolist()}")
    if toks.shape != (R, G) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{cfg.name}: serve_batch tokens out of range")
    return {"serve_s": wall, "serve_ms_per_step": step_ms, "prompts": prompts, "tokens": toks}


def init_moe_model(cfg, dev, label: str) -> tuple:
    """``init_model(cfg, 0)`` on the card, its parameter count, the peak
    allocated memory while it built and the seconds it took."""
    from repro_torch.models import init_model
    from repro_torch.models.transformer import param_count

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_model(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = param_count(params)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"  {label}: {n:,} parameters, {n * 4 / 1e9:.2f} GB fp32 ({n * 4 / 2**30:.2f} GiB); init "
          f"{init_s:.1f} s, peak allocated {peak:.2f} GiB")
    return params, {"params": n, "init_peak_gib": peak, "init_s": init_s}


def run_moe_lm(dev, card: str) -> dict:
    """Phase 7d: the mixture-of-experts LMs (seeded weights, fp32, TF32
    off), after the earlier phases have freed theirs. K3 at the three
    prefill shapes and K7 at jamba's first; then (a) deepseek-moe-16b at
    full width and depth, (b) granite-moe-3b-a800m at full width and
    depth, (c) jamba-v0.1-52b at full width, one 8-layer period. Returns
    the numbers of the kernels line."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import decode_step, forward, init_decode_state
    from repro_torch.serving.scheduler import ContinuousBatcher, Request

    t_phase = time.perf_counter()
    held_below_1gib(dev, "the phase")
    out = moe_kernel_times(dev, card)
    g = torch.Generator(device=dev).manual_seed(0)

    # (a) deepseek-moe-16b, full width and depth
    cfg = get_config("deepseek-moe-16b")
    params, rec = init_moe_model(cfg, dev, f"{cfg.name} ({cfg.num_layers} 'A' + 'E' layers, "
                                 f"{cfg.moe.num_experts} experts of {cfg.moe.expert_ffn}, top-"
                                 f"{cfg.moe.top_k}, shared {cfg.moe.shared_ffn})")
    if rec["params"] != DEEPSEEK_PARAMS:
        fail(f"deepseek-moe-16b has {rec['params']:,} parameters, not {DEEPSEEK_PARAMS:,}")
    if rec["init_peak_gib"] >= INIT_PEAK_GIB:
        fail(f"deepseek-moe-16b's init peaked at {rec['init_peak_gib']:.2f} GiB "
             f"(want < {INIT_PEAK_GIB})")
    prompts = torch.randint(0, cfg.vocab_size, MOE_PREFILL[cfg.name], generator=g, device=dev)
    rec.update(moe_prefill(cfg, params, prompts, dev, k3=cfg.num_layers))
    rec_gather = []
    with torch.no_grad():
        gathered, _ = forward(params, prompts, cfg.replace(moe_dispatch="gather"),
                              last_logits_only=True, moe_routing=rec_gather)
    rec["gather"] = hold_moe_logits("deepseek-moe-16b einsum vs gather dispatch",
                                    rec["logits"], gathered, rec["routing"], rec_gather)
    del gathered, rec_gather
    rec["profile"] = split = moe_profile_split(
        lambda: forward(params, prompts, cfg, last_logits_only=True))
    if split["method"] == "not measured":
        print("  one prefill's device time by part: not measured (no trace held its records)")
    else:
        print(f"  [{card}] one prefill: {split['total_ms']:.1f} ms of device time: K3 "
              f"{split['k3_ms']:.1f} ms, expert products {split['experts_ms']:.1f} ms, dispatch "
              f"and combine products {split['dispatch_combine_ms']:.1f} ms, router "
              f"{split['router_ms']:.1f} ms, the rest {split['rest_ms']:.1f} ms")
    srv = moe_serve(cfg, params, g, dev, card)
    rec.update({k: srv[k] for k in ("serve_s", "serve_ms_per_step")})

    # a decode step's dropped share (the eager step records the routing;
    # a graphed step refuses moe_routing), then the graphed step against it
    R, P, G = MOE_SERVE
    state = init_decode_state(cfg, R, P + G, device=dev)
    routing = []
    with torch.no_grad():
        decode_step(params, srv["prompts"][:, :1], state, cfg, moe_routing=routing)
    rec["decode_dropped_share"] = dropped_share(routing)
    del state
    rec["decode"] = decode = decode_gate("deepseek-moe-16b", card, cfg, params, srv["prompts"],
                                         dev)
    rec["decode_device_ms_per_step"] = decode["decode_device_ms_per_step"]
    rec["decode_idle_share"] = decode["decode_idle_share"]
    weights_ms = rec["params"] * 4 / HBM_BYTES_PER_S * 1e3
    print(f"  [{card}] decode: every expert reads its weights ({weights_ms:.1f} ms at 3.35 "
          f"TB/s); dropped share of a decode step's routing decisions "
          f"{rec['decode_dropped_share']:.4f}")

    # the continuous batcher, graphed then eager on the same requests; solo
    # runs compared, not gated
    reqs = [(uid, torch.randint(0, cfg.vocab_size, (p,), generator=g, device=dev), m)
            for uid, (p, m) in enumerate(BATCHER_REQUESTS)]
    runs = []
    for graphed in (True, False):
        b = ContinuousBatcher(cfg, params, slots=BATCHER_SLOTS, cache_len=BATCHER_CACHE,
                              device=dev)
        if not graphed:
            b.step_fn = b.step_fn.eager
        for uid, p, m in reqs:
            b.submit(Request(uid=uid, prompt=p.cpu().numpy(), max_new_tokens=m))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = b.run_to_completion()
        torch.cuda.synchronize()
        runs.append((b, done, time.perf_counter() - t0))
    b, done, batch_s = runs[0]
    n_new = sum(m for _, _, m in reqs)
    print(f"  [{card}] ContinuousBatcher: {len(reqs)} requests through {BATCHER_SLOTS} slots: "
          f"{b.total_steps} steps in {batch_s:.3f} s graphed (captures {b.captures}, build "
          f"{b.build_s:.3f} s) and {runs[1][2]:.3f} s eager "
          f"({batch_s / b.total_steps * 1e3:.2f} ms a step, {n_new / batch_s:.1f} new tokens/s), "
          f"wasted_step_fraction {b.wasted_step_fraction:.4f}, finishing order {list(done)}")
    if len(done) != len(reqs) or b.total_steps >= BATCHER_CACHE:
        fail(f"the batcher finished {len(done)} of {len(reqs)} requests in {b.total_steps} steps")
    again = runs[1][1]
    if (list(again) != list(done) or any(again[u].output != done[u].output for u in done)
            or b.captures != 1):
        fail("the graphed batcher's drain differs from the eager one's, request for request")
    differ = 0
    for uid, p, m in reqs:
        solo = serve_batch(cfg, params, p[None], gen_len=m, device=dev)[0].tolist()
        differ += sum(a != c for a, c in zip(done[uid].output, solo))
    print(f"  the graphed and eager drains gave the same tokens; {differ} of {n_new} batched "
          f"tokens differ "
          f"from the requests' solo runs (seatmates share the experts' capacity; not gated)")
    rec.update(batcher_s=batch_s, batcher_eager_s=runs[1][2], batcher_steps=b.total_steps,
               wasted_step_fraction=b.wasted_step_fraction, batcher_tokens_per_s=n_new / batch_s,
               tokens_differing_from_solo=differ)
    del params, b, done, runs, srv
    out["deepseek-moe-16b"] = rec
    torch.cuda.empty_cache()

    # (b) granite-moe-3b-a800m, full width and depth
    cfg = get_config("granite-moe-3b-a800m")
    params, rec = init_moe_model(cfg, dev, f"{cfg.name} ({cfg.num_layers} 'A' (GQA "
                                 f"{cfg.num_heads}:{cfg.num_kv_heads}) + 'E' layers, "
                                 f"{cfg.moe.num_experts} experts of {cfg.moe.expert_ffn}, "
                                 f"top-{cfg.moe.top_k})")
    prompts = torch.randint(0, cfg.vocab_size, MOE_PREFILL[cfg.name], generator=g, device=dev)
    rec.update(moe_prefill(cfg, params, prompts, dev, k3=cfg.num_layers))
    srv = moe_serve(cfg, params, g, dev, card)
    rec.update({k: srv[k] for k in ("serve_s", "serve_ms_per_step")})
    del params, srv
    out["granite-moe-3b-a800m"] = rec
    torch.cuda.empty_cache()

    # (c) jamba-v0.1-52b at full width, its depth cut to one period of 8
    full = get_config("jamba-v0.1-52b")
    cfg = full.replace(num_layers=len(full.mixer_pattern))
    n_m = cfg.mixer_pattern.count("M")
    params, rec = init_moe_model(cfg, dev, f"{cfg.name}, one period ({n_m} 'M' of d_state "
                                 f"{cfg.mamba.d_state}, {cfg.mixer_pattern.count('A')} 'A', "
                                 f"{cfg.mlp_pattern.count('D')} 'D', {cfg.mlp_pattern.count('E')} "
                                 f"'E' of {cfg.moe.num_experts} experts; cut from "
                                 f"{full.num_layers} layers)")
    prompts = torch.randint(0, cfg.vocab_size, MOE_PREFILL[cfg.name], generator=g, device=dev)
    rec.update(moe_prefill(cfg, params, prompts, dev, k3=cfg.mixer_pattern.count("A"), k7=n_m))
    srv = moe_serve(cfg, params, g, dev, card)
    rec.update({k: srv[k] for k in ("serve_s", "serve_ms_per_step")})
    rec["decode"] = decode_gate("jamba's period", card, cfg, params, srv["prompts"], dev)
    del params, srv
    out["jamba-v0.1-52b"] = rec
    torch.cuda.empty_cache()

    for name in ("deepseek-moe-16b", "granite-moe-3b-a800m", "jamba-v0.1-52b"):
        for key in ("logits", "routing"):
            out[name].pop(key)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [{card}] MoE phase {out['phase_s']:.1f} s")
    return out


def hold_lm_logits(label: str, fast, plain) -> dict:
    """The kernel path's last-position logits against the plain path's:
    within LM_LOGIT_TOL·max|logit|, and the same greedy token in every row
    (a sequence's, or a sequence's codebook's) unless that row's top-2 gap
    is within the bound (a near tie two fp32 paths may break either way)."""
    err = (fast - plain).abs().max().item()
    bound = LM_LOGIT_TOL * plain.abs().max().item()
    V = plain.shape[-1]
    rows_f, rows_p = fast.reshape(-1, V), plain.reshape(-1, V)
    same = torch.equal(rows_f.argmax(-1), rows_p.argmax(-1))
    gaps = [top2_gap(r) for r in rows_p]
    print(f"  {label}: max|Δlogit| {err:.3e} (bound {bound:.3e}); the same greedy token in all "
          f"{len(gaps)} rows {same}; smallest top-2 gap {min(gaps):.3e}")
    if err > bound:
        fail(f"{label}: logits {err:.3e} off the plain path (bound {bound:.3e})")
    for i, (a, b) in enumerate(zip(rows_f.argmax(-1).tolist(), rows_p.argmax(-1).tolist())):
        if a != b and gaps[i] > bound:
            fail(f"{label}: row {i} takes token {a}, the plain path {b}, at a top-2 gap "
                 f"{gaps[i]:.3e} above the bound")
    return {"logit_err": err, "logit_bound": bound, "same_tokens": same,
            "min_top2_gap": min(gaps)}


def lm_prefill(cfg, params, batch: dict, dev, k3: int) -> dict:
    """``make_prefill_step`` on ``batch`` (attention through K3; "X" layers
    plain), warm first: K3's count set to 0 just before and read just after
    (exactly ``k3``), the wall, the peak allocated memory; then the
    last-position logits against the plain attention (``hold_lm_logits``)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import forward

    prefill = make_prefill_step(cfg, device=dev)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("TF32 is on: the LM's fp32 products would not be fp32")
    prefill(params, {**batch, "tokens": batch["tokens"][:, :256]})  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    flash_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt = prefill(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = flash_ops.launches
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    toks = batch["tokens"]
    rate = toks.shape[0] * toks.shape[1] / wall
    print(f"  prefill {tuple(toks.shape)}: {wall:.3f} s, {rate:.0f} positions/s, peak allocated "
          f"{peak:.2f} GiB; K3 launches {got} (want {k3}); next tokens {nxt[:, 0].tolist()}")
    if got != k3:
        fail(f"{cfg.name}'s prefill launched K3 {got} times, not {k3}")
    if not bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()):
        fail(f"prefill token {nxt.tolist()} out of range")
    with torch.no_grad():
        fast, _ = forward(params, toks, cfg, cross_embeds=batch.get("cross_embeds"),
                          last_logits_only=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, _ = forward(params, toks, cfg, cross_embeds=batch.get("cross_embeds"),
                           use_flash=False, last_logits_only=True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    if not torch.equal(nxt, fast[:, -1:].argmax(-1).to(torch.int32)):
        fail(f"{cfg.name}: the prefill step's tokens are not its forward's")
    held = hold_lm_logits(f"{cfg.name} K3 vs the plain attention (plain prefill "
                          f"{plain_s:.3f} s)", fast, plain)
    if not bool(torch.isfinite(fast).all()):
        fail(f"{cfg.name}: non-finite prefill logits")
    return {"prefill_s": wall, "plain_prefill_s": plain_s, "peak_gib": peak, "launches": got,
            **held}


def lm_serve(cfg, params, prompts, cross, dev, card: str) -> dict:
    """``serve_batch`` (prompt + VLM_AUDIO_SERVE's gen, ``cross`` the image
    embeddings or None) after a warm-up: ms a decode step, tokens in range,
    the capture's build time; then ``decode_gate``: the graphed step
    bitwise the eager one, ms and device ms a step of each, the eager
    step's idle share."""
    from repro_torch.launch.serve import serve_batch

    R, P, G = VLM_AUDIO_SERVE
    stats = {}
    for _ in range(2):  # warm-up at the timed call's key: eager, then its capture
        serve_batch(cfg, params, prompts[:, :2], gen_len=2, cache_len=P + G,
                    cross_embeds=cross, device=dev, stats=stats)
    build_s = stats["build_s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, prompts, gen_len=G, cross_embeds=cross, device=dev,
                       stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = wall / (P + G - 1) * 1e3
    want = (R, G) + tuple(prompts.shape[2:])
    if tuple(toks.shape) != want or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{cfg.name}: serve_batch gave {tuple(toks.shape)} (want {want}) or tokens out "
             f"of range")
    print(f"  [{card}] serve_batch {R} requests, prompt {P}, gen {G}: {wall:.3f} s replayed "
          f"(graphed {stats['graphed']}, captures {stats['captures']}; the warm-up's capture "
          f"{build_s:.3f} s), {step_ms:.2f} ms per decode step of {R}; first tokens "
          f"{toks[:, 0].tolist()}")
    decode = decode_gate(cfg.name if cross is None else f"{cfg.name}'s period", card, cfg,
                         params, prompts, dev, cross=cross)
    return {"serve_s": wall, "serve_ms_per_step": step_ms, "serve_build_s": build_s,
            "decode_device_ms_per_step": decode["decode_device_ms_per_step"],
            "decode_idle_share": decode["decode_idle_share"],
            "decode_ops_per_step": decode["decode_ops_per_step"], "decode": decode}


def train_musicgen(dev, card: str) -> dict:
    """Phase 7e (c): musicgen-medium at full width trained MUSICGEN_TRAIN's
    steps through ``launch.train.train_loop`` (seeded weights, the delay
    pattern, plain attention, TF32 off): every cross-entropy finite, the
    last below the first, every parameter moved, ms a step and the peak
    allocated memory; then one step under remat "full" against "none" from
    the same weights and batch: the same loss, a lower peak."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig, synth_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_model
    from repro_torch.models.transformer import _map, param_count
    from repro_torch.optim import AdamW

    cfg = get_config("musicgen-medium")
    run = MUSICGEN_TRAIN
    n = MUSICGEN_PARAMS
    print(f"  train {cfg.name}: {run['steps']} steps of batch {run['batch']} x {run['seq']} "
          f"frames x {cfg.num_codebooks} codebooks (delay pattern), AdamW, lr {run['lr']} "
          f"(warmup_cosine); weights, grads, m and v {4 * n * 4 / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    t0 = time.perf_counter()
    params, losses = train_loop(cfg, **run, seed=0, log_every=5, step_times=times, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if param_count(params) != n:
        fail(f"musicgen-medium has {param_count(params):,} parameters, not {n:,}")
    steady = sorted(times[1:])[len(times[1:]) // 2] * 1e3
    tokens = run["batch"] * run["seq"] * cfg.num_codebooks
    print(f"  [{card}] train_loop: {wall:.2f} s in all; a step {steady:.1f} ms (median after the "
          f"first, {times[0] * 1e3:.1f} ms), {tokens / steady * 1e3:.0f} tokens/s; peak allocated "
          f"{peak:.2f} GiB; ce {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"a training loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training did not lower the cross-entropy: {losses[0]:.4f} -> {losses[-1]:.4f}")
    fresh = init_model(cfg, 0, device=dev)
    after, before = [], []
    _map(after.append, params)
    _map(before.append, fresh)
    moved = sum(not torch.equal(a.detach(), b) for a, b in zip(after, before))
    print(f"  {moved} of {len(after)} parameter leaves moved")
    if moved != len(after):
        fail(f"only {moved} of {len(after)} parameter leaves moved in training")
    del params, fresh, after, before
    torch.cuda.empty_cache()

    # one step under remat "full" against "none": same weights, same batch
    batch = {"tokens": synth_batch(TokenPipelineConfig(cfg.vocab_size, run["seq"], run["batch"],
                                                       num_codebooks=cfg.num_codebooks), 0)}
    remat = {}
    for mode in ("none", "full"):
        params = init_model(cfg, 0, device=dev)
        opt = AdamW(lr=run["lr"])
        state = opt.init(params)
        step = make_train_step(cfg, opt, remat=mode, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        metrics = step(params, state, batch)[2]
        loss = metrics["loss"].item()
        ms = (time.perf_counter() - t0) * 1e3
        remat[mode] = {"loss": loss, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                       "ms": ms}
        del params, state, step, metrics  # the moments too: the next mode's peak starts clean
        torch.cuda.empty_cache()
    a, b = remat["none"], remat["full"]
    rel = abs(b["loss"] - a["loss"]) / abs(a["loss"])
    print(f"  [{card}] one step, remat none / full: loss {a['loss']:.6f} / {b['loss']:.6f} "
          f"(relative {rel:.2e}, bound {REMAT_LOSS_RTOL:g}); peak allocated "
          f"{a['peak_gib']:.2f} / {b['peak_gib']:.2f} GiB; {a['ms']:.1f} / {b['ms']:.1f} ms "
          f"(first step of each: cold allocator)")
    if rel > REMAT_LOSS_RTOL:
        fail(f"remat 'full' changed the loss by {rel:.2e} relative")
    if not b["peak_gib"] < a["peak_gib"]:
        fail(f"remat 'full' did not lower the peak ({b['peak_gib']:.2f} GiB against "
             f"{a['peak_gib']:.2f})")
    return {"steps": run["steps"], "batch": run["batch"], "seq": run["seq"], "wall_s": wall,
            "ms_per_step": steady, "first_step_ms": times[0] * 1e3, "tokens_per_s":
            tokens / steady * 1e3, "peak_gib": peak, "ce_first": losses[0],
            "ce_last": losses[-1], "remat": remat}


def run_vlm_audio_lm(dev, card: str) -> dict:
    """Phase 7e: the cross-attention and codebook LMs and LM training
    (seeded weights, fp32, TF32 off), after the earlier phases have freed
    their memory (< 1 GiB still allocated, else it fails). First K3 at the
    two prefill shapes, timed beside its bound, its plain version and SDPA;
    then (a) llama-3.2-vision-90b at full width, one 5-layer period, on
    seeded image embeddings, (b) musicgen-medium at full width and depth,
    (c) musicgen-medium trained (``train_musicgen``). Returns the numbers
    of the kernels line."""
    from repro_torch.benchmarks import kernel_times
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    held_below_1gib(dev, "the phase")
    gen = torch.Generator(device=dev).manual_seed(26)
    out = {"k3": {}}
    for name, shape in kernel_times.VLM_AUDIO_ATTN_SHAPES.items():
        t = {**kernel_times.causal_attention_times(dev, gen, shape), **attention_bound(shape)}
        out["k3"][name] = t
        print(f"  [{card}] flash_attention {shape} causal fp32 ({name}): {t['ms']:.3f} ms on "
              f"the device; bound {t['bound_ms']:.3f} ms by {t['bound_by']} (3xTF32: 3 x "
              f"{t['gflop']:.1f} GFLOP over {t['visible_pairs']:,} visible pairs at 495 TFLOP/s;"
              f" {t['bound_ms'] / t['ms']:.0%} of it reached); plain {t['plain_ms']:.3f} ms; "
              f"SDPA {t['library_ms']:.3f} ms (max abs diff from the plain version "
              f"{t['library_max_abs_diff']:.1e})")
    g = torch.Generator(device=dev).manual_seed(0)

    # (a) llama-3.2-vision-90b at full width, its depth cut to one period
    full = get_config("llama-3.2-vision-90b")
    cfg = full.replace(num_layers=len(full.mixer_pattern))
    params, rec = init_moe_model(cfg, dev, f"{cfg.name}, one period ({cfg.mixer_pattern.count('A')}"
                                 f" 'A' GQA {cfg.num_heads}:{cfg.num_kv_heads} x {cfg.head_dim}, "
                                 f"1 'X' over {cfg.num_patches} patches of {cfg.vision_dim}; cut "
                                 f"from {full.num_layers} layers)")
    if rec["params"] != VLM_PARAMS:
        fail(f"one period of {cfg.name} has {rec['params']:,} parameters, not {VLM_PARAMS:,}")
    B, S = VLM_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    cross = torch.randn(B, cfg.num_patches, cfg.vision_dim, generator=g, device=dev)
    rec.update(lm_prefill(cfg, params, {"tokens": toks, "cross_embeds": cross}, dev,
                          k3=cfg.mixer_pattern.count("A")))
    R, P, _ = VLM_AUDIO_SERVE
    prompts = torch.randint(0, cfg.vocab_size, (R, P), generator=g, device=dev)
    cross = torch.randn(R, cfg.num_patches, cfg.vision_dim, generator=g, device=dev)
    rec.update(lm_serve(cfg, params, prompts, cross, dev, card))
    del params, cross
    out["llama-3.2-vision-90b"] = rec
    torch.cuda.empty_cache()

    # (b) musicgen-medium at full width and depth
    cfg = get_config("musicgen-medium")
    K = cfg.num_codebooks
    params, rec = init_moe_model(cfg, dev, f"{cfg.name} ({cfg.num_layers} 'A' MHA "
                                 f"{cfg.num_heads} x {cfg.head_dim} + 'D' layers, {K} codebooks "
                                 f"of {cfg.vocab_size}, {cfg.norm_type}, {cfg.act})")
    if rec["params"] != MUSICGEN_PARAMS:
        fail(f"{cfg.name} has {rec['params']:,} parameters, not {MUSICGEN_PARAMS:,}")
    toks = torch.randint(0, cfg.vocab_size, (*MUSICGEN_PREFILL, K), generator=g, device=dev)
    rec.update(lm_prefill(cfg, params, {"tokens": toks}, dev, k3=cfg.num_layers))
    prompts = torch.randint(0, cfg.vocab_size, (R, P, K), generator=g, device=dev)
    rec.update(lm_serve(cfg, params, prompts, None, dev, card))
    del params
    out["musicgen-medium"] = rec
    torch.cuda.empty_cache()

    # (c) musicgen-medium trained at full width
    out["train"] = train_musicgen(dev, card)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [{card}] cross-attention, codebook and training phase {out['phase_s']:.1f} s")
    return out


def run_sharded(dev, card: str, main_wall_s: float) -> dict:
    """Phase 8: K4 against its plain version in process, then the sharded
    selftest in subprocesses (world 1 over NCCL, world 2 over gloo on this
    card); returns K4's numbers for the kernels line."""
    from repro_torch.configs.diffusion import HIGHRES_DIT
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref

    B, D = 8, HIGHRES_DIT.image_size ** 2 * HIGHRES_DIT.channels
    gen = torch.Generator(device=dev).manual_seed(15)
    err = {}
    # Bounds: x'' bitwise equal to K1's columns (the same kernel arithmetic);
    # against the plain version as in phase 2 (1e-5·(1+max|x''|) fp32, 1e-2 bf16);
    # the partial sums within 1e-5 of the plain version's (as K1's e2); the
    # ranges' sums added in range order within K4_E2_RTOL of K1's e2.
    for dtype, xtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        states = [torch.randn(B, D, generator=gen, device=dev).to(dtype) for _ in range(5)]
        coeffs = [torch.rand(B, generator=gen, device=dev) for _ in range(3)]
        ea = step_ops.per_sample_tolerance(0.0078, B, dev)
        er = step_ops.per_sample_tolerance(0.05, B, dev)
        xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
        # batch-only K4 runs K1 on the rank's rows: a batch half must give
        # the whole state's bits for those rows
        for rows in (slice(0, B // 2), slice(B // 2, B)):
            bx, be = step_ops.error_step(
                *(t[rows] for t in states), *(c[rows] for c in coeffs), eps_abs=ea[rows],
                eps_rel=er[rows])
            if not (torch.equal(bx, xh[rows]) and torch.equal(be, e2[rows])):
                fail("K1 on a batch half differs from K1 on those rows of the whole state")
        for f in (1, 2, 4):
            total = torch.zeros(B, device=dev)
            x_err = s_rel = 0.0
            for i in range(f):
                a, b = step_ops.feature_range(D, f, i)
                block = [t[:, a:b] for t in states]
                bx, bs = step_ops.error_step_sums(*block, *coeffs, eps_abs=ea, eps_rel=er)
                px, ps = step_ref.error_step_sums(*block, *coeffs, ea, er)
                torch.cuda.synchronize()
                if not torch.equal(bx, xh[:, a:b]):
                    fail(f"K4's x'' on columns {a}:{b} differs from K1's")
                x_err = max(x_err, (bx.float() - px.float()).abs().max().item())
                s_rel = max(s_rel, ((bs - ps).abs() / ps).max().item())
                total = total + bs
            e_rel = ((torch.sqrt(total / D) - e2).abs() / e2).max().item()
            x_bound = xtol * (1 + xh.float().abs().max().item())
            ok = x_err <= x_bound and s_rel <= 1e-5 and e_rel <= K4_E2_RTOL
            print(f"  K4 {str(dtype)[6:]:8s} (8, {D}) in {f} column range(s): x'' = K1's "
                  f"bitwise; max|x''-plain| {x_err:.3e} (bound {x_bound:.1e}); sums vs plain "
                  f"max rel {s_rel:.3e} (bound 1e-5); combined e2 vs K1 max rel {e_rel:.3e} "
                  f"(bound {K4_E2_RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail("K4 disagrees with its plain version or with K1")
            err[(dtype, f)] = x_err
        del states, xh
    print("  K1 on each batch half (batch-only K4; fp32, bf16): x'' and e2 bitwise equal to "
          "the whole state's rows")

    # the sharded path through torch.distributed: the library is built, each
    # rank loads it
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}
    for world, backend in ((1, "nccl"), (2, "gloo")):
        cmd = [sys.executable, "-m", "repro_torch.launch.sharded_selftest", "--device",
               "cuda", "--backend", backend, "--world", str(world), "--arch", "highres_dit"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                              timeout=SELFTEST_TIMEOUT_S)
        line = (proc.stdout.strip().splitlines() or ["{}"])[-1]
        print(f"  sharded_selftest world {world} over {backend}, exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s: {line}")
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            fail(f"sharded_selftest at world {world} over {backend} failed")
        runs[world] = json.loads(line)
    one, two = runs[1]["arch"], runs[2]["arch"]
    launches = one["launches"]
    print(f"  world 1 (NCCL): HIGHRES_DIT sharded = unsharded bitwise {one['bitwise_equal']}, "
          f"{one['iterations']} iterations, mean NFE {one['mean_nfe']:.2f}; launches in the "
          f"sharded solve: K4 {launches['sharded_solver_step']}, K1 {launches['solver_step']}, "
          f"flash {launches['flash_attention']}")
    if launches["sharded_solver_step"] < one["iterations"] or launches["flash_attention"] <= 0:
        fail(f"the sharded main path did not run its kernels: {launches}")
    print(f"  world 2 (gloo, both ranks on this card): bitwise {two['bitwise_equal']}, "
          f"max|x diff| {two['max_abs_diff']:.3e}, max per-sample NFE diff "
          f"{two['max_nfe_diff']} (gate 4), converged {two['converged']}/8, finite "
          f"{two['finite']}; K4 feature combine max rel e2 "
          f"{runs[2]['fused_kernel']['max_rel_e2_feature']:.3e}. One card: no speed-up is "
          f"measured here.")
    mesh = mesh_serving(runs, card)
    dit_mesh = dit_mesh_checks(runs, card)
    graphed = graphed_mesh_checks(runs, card)
    dit_mesh["k3"] = k3_mesh_times(dev, gen, card)

    # timings, each beside the card's name and power limit
    sets_full, sets_half = [], []
    for _ in range(4):
        states = [torch.randn(B, D, generator=gen, device=dev) for _ in range(5)]
        coeffs = [torch.rand(B, generator=gen, device=dev) for _ in range(3)]
        eps = [step_ops.per_sample_tolerance(e, B, dev) for e in (0.0078, 0.05)]
        sets_full.append((*states, *coeffs, *eps))
        sets_half.append((*(t[:, : D // 2] for t in states), *coeffs, *eps))
    k4 = lambda *a: step_ops.error_step_sums(*a[:8], eps_abs=a[8], eps_rel=a[9])
    k4_plain_fn = lambda *a: step_ref.error_step_sums(*a)
    t = {}
    for name, sets, d in (("full", sets_full, D), ("half", sets_half, D // 2)):
        ms, plain = device_ms(k4, sets), device_ms(k4_plain_fn, sets)
        nbytes = 6 * B * d * 4 + 6 * B * 4
        nops = STEP_FLOPS_PER_ELEMENT * B * d
        bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOPS) * 1e3
        t[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_FLOPS
                       else "operations")
        print(f"  [{card}] K4 partial mode (8, {d}) fp32: {ms * 1e3:.2f} us on the device, bound "
              f"{bound * 1e3:.2f} us ({nbytes / 1e6:.1f} MB at 3.35 TB/s); plain "
              f"{plain * 1e3:.1f} us")
    ar = runs[1]["all_reduce_9"]
    print(f"  [{card}] all_reduce of 9 fp32 (world 1, NCCL): {ar['event_us']:.1f} us between "
          f"CUDA events, {ar['sync_wall_us']:.1f} us host wall with a synchronise each")
    walls = lambda ts: ", ".join(f"{t:.3f}" for t in ts)
    print(f"  [{card}] HIGHRES_DIT solve: phase 3 {main_wall_s:.3f} s; in the world-1 "
          f"selftest the first, cold unsharded solve {one['unsharded_wall_s']:.3f} s, then in "
          f"turns sharded (NCCL) {walls(one['sharded_walls_s'])} s and unsharded "
          f"{walls(one['unsharded_warm_walls_s'])} s (order S U U S); world 2 on one card, "
          f"sharded {walls(two['sharded_walls_s'])} s")
    return {"launches": launches["sharded_solver_step"], "max_abs_err": err[(torch.float32, 2)],
            "times": t, "all_reduce_9_us": ar["event_us"], "runs": runs, "mesh": mesh,
            "dit_mesh": dit_mesh, "graphed": graphed}


def dit_mesh_checks(runs: dict, card: str) -> dict:
    """Phase 8's checks 7 and 8 of the selftest (the pipelined and the
    tensor-parallel HIGHRES_DIT forward), read from both worlds' JSON:
    printed, gated, and returned for the kernels line."""
    from repro_torch.launch.sharded_selftest import NFE_SLACK, PIPE_MICROBATCHES

    layers = 12
    for world, run in sorted(runs.items()):
        for p in run["pipeline"]:
            print(f"  [{card}] check 7, world {world} ({run['backend']}), stage {p['stage']} of "
                  f"mesh {p['mesh']} (layers {p['layers'][0]}-{p['layers'][1] - 1}): pipelined "
                  f"forward bitwise the microbatched forward {p['bitwise_equal']}, K3 "
                  f"{p['k3_launches']}, handoffs sent {p['handoffs'][0]} "
                  f"({p['handoffs'][1] / 1e6:.2f} MB), broadcast {p['broadcasts'][0]} "
                  f"({p['broadcasts'][1] / 1e6:.2f} MB); wall {p['wall_s']:.4f} s against "
                  f"{p['microbatched_wall_s']:.4f} s unpipelined; check {p['seconds']:.1f} s")
            want = (p["layers"][1] - p["layers"][0]) * PIPE_MICROBATCHES
            sends = PIPE_MICROBATCHES if p["stage"] < world - 1 else 0
            if not (p["bitwise_equal"] and p["k3_launches"] == want
                    and p["handoffs"][0] == sends):
                fail(f"check 7 at world {world}: not bitwise, or K3 launched "
                     f"{p['k3_launches']} times (want {want}), or {p['handoffs'][0]} handoffs")
        for p in run["tensor_parallel"]:
            print(f"  [{card}] check 8, world {world} ({run['backend']}), rank {p['coordinate']} "
                  f"of mesh {p['mesh']}: {p['heads']} heads, F {p['ffn']}, ada {p['ada']} a rank; "
                  f"bitwise the unsharded forward {p['bitwise_equal']}, max|diff| "
                  f"{p['max_abs_diff']:.3e} (bound {p['bound']:.2e}); K3 {p['k3_launches']}; "
                  f"collectives a forward {p['books']}; meta count equal {p['meta_equal']}; "
                  f"wall {p['wall_s']:.4f} s against {p['unsharded_wall_s']:.4f} s unsharded; "
                  f"check {p['seconds']:.1f} s")
            if not (p["within_bound"] and p["meta_equal"] and p["k3_launches"] == layers
                    and (world > 1 or p["bitwise_equal"])):
                fail(f"check 8 at world {world}: out of bound, meta count unequal, or K3 "
                     f"launched {p['k3_launches']} times")
    sol = runs[1]["pipeline"][0]["solve"]
    for check, s in (("7", sol), ("8", runs[1]["tensor_parallel"][0]["solve"])):
        fwd = "pipelined" if check == "7" else "tensor-parallel"
        print(f"  [{card}] check {check}'s solve, sample(mesh=) through the {fwd} forward, "
              f"world 1: {s['iterations']} iterations, mean NFE {s['mean_nfe']:.2f} against "
              f"{s['unsharded_mean_nfe']:.2f} unsharded (max diff {s['max_nfe_diff']}, slack "
              f"{NFE_SLACK}), converged {s['converged']}/8, finite {s['finite']}; K4 "
              f"{s['k4_launches']}, K3 {s['k3_launches']}; unsharded "
              f"{s['unsharded_wall_s']:.3f} s; "
              + graphed_text(s["calls"]))
        if not (s["finite"] and s["converged"] == 8 and s["max_nfe_diff"] <= NFE_SLACK
                and s["k4_launches"] > 0 and s["k3_launches"] > 0 and s["graphed_ok"]):
            fail(f"check {check}'s solve missed convergence, finiteness, the NFE slack, a kernel "
                 f"or the graphed gates (captures 0, 1, 0, bitwise, reads, launches)")
    added = {w: sum(p["seconds"] for p in (runs[w]["pipeline"][0], runs[w]["tensor_parallel"][0]))
             for w in runs}
    print(f"  checks 7 and 8 took {added[1]:.1f} s in the world-1 selftest and {added[2]:.1f} s in "
          f"the world-2 one (rank 0)")
    return {"pipeline": {w: [p["k3_launches"] for p in runs[w]["pipeline"]] for w in runs},
            "tensor_parallel": {w: [p["k3_launches"] for p in runs[w]["tensor_parallel"]]
                                for w in runs},
            "solve": sol, "tp_solve": runs[1]["tensor_parallel"][0]["solve"], "seconds": added,
            "books": {w: runs[w]["tensor_parallel"][0]["books"] for w in runs}}


def graphed_text(rec: dict) -> str:
    """One line of a ``sharded_selftest.graphed_calls`` record."""
    return (f"drivers built {rec['builds']}, captures {rec['captures']}, bitwise the first "
            f"{rec['bitwise']}, host reads "
            f"{rec['host_reads']}, walls {', '.join(f'{w:.3f}' for w in rec['walls_s'])} s "
            f"(host-driven, capturing, replayed), window share (CUDA events) "
            f"{', '.join('-' if v is None else f'{v:.2f}' for v in rec['window_share'])}; launches "
            f"host-driven {rec['launches'][0]}, replayed {rec['launches'][-1]}")


def graphed_mesh_checks(runs: dict, card: str) -> dict:
    """Phase 8's check 9, read from both worlds' JSON: every sharded solve
    graphed on the world-1 NCCL mesh (the selftest's gates: captures 0, 1,
    0, bitwise the host-driven first call, at most 2 host reads a graphed
    call, the replay's K4/K3/K5/P1 launches the first call's, P2 once a
    horizon plus one), and host-driven on the world-2 gloo mesh."""
    from repro_torch.launch.sharded_selftest import graphed_ok

    one, two = runs[1]["graphed"][0], runs[2]["graphed"]
    for method in ("adaptive", "em", "pc", "ode"):
        rec = one[method]
        print(f"  [{card}] check 9, world 1 (NCCL) {method}: {rec['iterations']} iterations, "
              f"{rec['horizons']} horizons; " + graphed_text(rec))
        if not (one["graphed"] and graphed_ok(rec, rec["horizons"])):
            fail(f"check 9: the graphed {method} under the world-1 NCCL mesh missed a gate")
    for r, g in enumerate(two):
        rec = g["adaptive"]
        print(f"  [{card}] check 9, world 2 (gloo) rank {r}: graphed {g['graphed']} (gloo "
              f"collectives cannot be captured): adaptive {rec['builds']} drivers built, bitwise "
              f"{rec['bitwise']}, host reads {rec['host_reads']}, walls "
              f"{', '.join(f'{w:.3f}' for w in rec['walls_s'])} s")
        if g["graphed"] or not rec["ok"]:
            fail("check 9: the world-2 gloo mesh did not stay host-driven")
    return {"world1": one, "world2": two}


def k3_mesh_times(dev, gen, card: str) -> dict:
    """K3 at checks 7 and 8's shapes (``k3_times``)."""
    return k3_times(dev, gen, card, {"pipeline": PIPE_ATTN, "tensor_parallel": TP_ATTN})


def k3_times(dev, gen, card: str, shapes: dict) -> dict:
    """K3 at each of ``shapes`` ({name: (B, Hq, Hkv, S, D)}), fp32,
    non-causal: device ms beside its plain version, SDPA and the 3xTF32
    bound (3 x 4·B·H·S²·D at 495 TFLOP/s, or the bytes at 3.35 TB/s if
    larger)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref

    out = {}
    for name, (b, h, _, s, dh) in shapes.items():
        sets = [tuple(torch.randn(b, h, s, dh, generator=gen, device=dev) for _ in range(3))
                for _ in range(4)]
        ms = device_ms(lambda q, k, v: flash_ops.attention(q, k, v, causal=False), sets)
        plain = device_ms(lambda q, k, v: flash_ref.attention(q, k, v, causal=False), sets)
        lib = device_ms(torch.nn.functional.scaled_dot_product_attention, sets)
        ops, nbytes = 4 * b * h * s * s * dh, 4 * b * h * s * dh * 4
        t_ops, t_bytes = 3 * ops / TF32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"shape": [b, h, s, dh], "ms": ms, "plain_ms": plain, "library_ms": lib,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"  [{card}] flash_attention {(b, h, s, dh)} fp32 ({name}): {ms * 1e3:.2f} us on the "
              f"device; bound {max(t_ops, t_bytes) * 1e3:.2f} us (3 x {ops / 1e9:.3f} GFLOP at "
              f"495 TFLOP/s); plain {plain * 1e3:.1f} us; SDPA {lib * 1e3:.2f} us")
        del sets
    return out


def mesh_serving(runs: dict, card: str) -> dict:
    """Phase 8's serving half, read from the selftest's JSON (checks 3, 4,
    6 and check 5's EM): prints and gates it, and returns the launches of
    the mesh serves for the kernels line."""
    for world, run in sorted(runs.items()):
        b, dr = run["batcher"], run["device_resident"]
        print(f"  world {world} {run['backend']}: DiffusionBatcher(mesh=) on the Gaussian "
              f"({2 * world} slots, {6 * world} requests, horizon 4): bitwise the unsharded "
              f"batcher at horizon 1 {b['scheduling_invariant']}, refills per device "
              f"{b['refills_per_device']} (first fill {b['slots_per_device']} each)")
        if dr["capturable"]:
            print(f"    device-resident: bitwise the host-driven mesh server "
                  f"{dr['bitwise_equal']}, iterations equal {dr['iterations_equal']}, reads "
                  f"{dr['resident_transfers']} against {dr['host_transfers']}, "
                  f"{dr['graph_captures']} horizon graph(s) captured")
        else:
            print(f"    device-resident on this gloo mesh raises (a gloo collective cannot be "
                  f"captured): {dr['raises']}")
    one, two = runs[1]["arch_serve"], runs[2]["arch_serve"]
    ref = one["unsharded"]
    print(f"  [{card}] HIGHRES_DIT tiered serve, 16 requests, 8 slots, horizon 4: unsharded "
          f"(rank 0) {ref['wall_s']:.3f} s, {ref['host_transfers']} reads, "
          f"{ref['iterations']} iterations, mean NFE by tier {ref['mean_nfe']}")
    for world, serve in ((1, one), (2, two)):
        for name in ("host", "device_resident"):
            r = serve[name]
            if "launches" not in r:
                continue
            print(f"  [{card}] world {world} ({runs[world]['backend']}) {name}: {r['wall_s']:.3f} "
                  f"s, bitwise the unsharded serve per request {r['bitwise_equal']}, max NFE "
                  f"diff {r['max_nfe_diff']}, max|x diff| {r['max_abs_diff']:.3e}, delivered "
                  f"{r['delivered']}, reads {r['host_transfers']}, solver syncs "
                  f"{r['solver_syncs']}, windows {r['windows']}, iterations {r['iterations']}, "
                  f"graph captures {r['graph_captures']}, refills per device "
                  f"{r['refills_per_device']}; launches from 0 over the serve (rank 0): "
                  f"{r['launches']}")
    em = runs[1]["arch"]["em"]
    print(f"  [{card}] EM-{em['steps']} from HIGHRES_DIT under mesh= (world 1, NCCL): K5 "
          f"{em['launches']} launches, bitwise the unsharded EM {em['bitwise_equal']}, "
          f"{em['wall_s']:.3f} s against {em['unsharded_wall_s']:.3f} s")
    host, res = one["host"], one["device_resident"]
    if not (host["bitwise_equal"] and res["bitwise_equal"] and em["bitwise_equal"]):
        fail("the world-1 mesh serve or EM differs from the unsharded run")
    for name, r in (("host", host), ("device_resident", res)):
        n = r["launches"]
        if n["sharded_solver_step"] <= 0 or n["flash_attention"] <= 0 or n["philox_normal"] <= 0:
            fail(f"the world-1 mesh serve ({name}) did not run K4, K3 and P1: {n}")
    if res["launches"]["horizon_cond"] <= 0 or res["graph_captures"] != 1:
        fail("the device-resident mesh serve did not run the WHILE node's P2")
    if res["host_transfers"] >= host["host_transfers"]:
        fail("the device-resident mesh serve did not read less than the host-driven one")
    if em["launches"] != em["steps"]:
        fail(f"EM under the mesh launched K5 {em['launches']} times, not {em['steps']}")
    if not two["host"]["ok"]:
        fail("the world-2 mesh serve missed a request, a finite sample or the NFE slack")
    return {"k4": host["launches"]["sharded_solver_step"]
            + res["launches"]["sharded_solver_step"],
            "k3": host["launches"]["flash_attention"] + res["launches"]["flash_attention"],
            "p1": host["launches"]["philox_normal"] + res["launches"]["philox_normal"],
            "p2": res["launches"]["horizon_cond"], "k5": em["launches"],
            "host": host, "device_resident": res, "world2": two["host"],
            "unsharded": ref, "em": em}


def run_zoo(dev, card: str, adaptive_rec: dict) -> dict:
    """Phase 6d, the solver zoo: ``sample(method="momentum")`` and
    ``sample(method="heun")`` through ``launch.sample.run`` from
    HIGHRES_DIT (phase 3's seeded, livened weights, batch 8, eps_rel 0.05,
    fused step, flash attention, fp32): finite, converged, nfe = 2·(accepted
    + rejected) + 1 per sample, and exactly K1 once and K3 2·num_layers
    times a body iteration (``body_iterations``: the iterations graphed,
    whole groups of SYNC_EVERY host-driven) plus num_layers for the
    denoise, K5 never. Then the selection race: every ``ZOO`` row on
    the closed-form Gaussian score, VP and VE (DDIM on VP), each row's K1
    and K5 launches exactly its rule (K1 one a body iteration on the
    Algorithm-1 families, K5 one a step on EM, two on PC, one on PC-HMC),
    momentum and Heun under their W2 gates; the report printed. Last, each
    family served (``DiffusionBatcher(solver=...)``, the closed-form score
    at D ZOO_SERVE_D, ZOO_SERVE_SLOTS slots, sync horizon SERVE_HORIZON,
    ZOO_SERVE_REQUESTS requests) host-driven and device-resident: every
    delivery bitwise its batch-1 ``adaptive()`` on its own stream with its
    NFE, the device-resident drain bitwise the host-driven one, and the
    captured horizon holding P1 once a body iteration for momentum and
    never for Heun (no z, no projection). Returns the numbers for the
    kernels line."""
    from repro_torch.analysis import solver_select
    from repro_torch.configs.diffusion import HIGHRES_DIT
    from repro_torch.core import analytic
    from repro_torch.core.sampling import sample
    from repro_torch.core.sde import VESDE, VPSDE, bcast
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.core.solvers.base import SlotStreams
    from repro_torch.core.solvers.momentum import DEFAULT_BETA
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.launch import sample as launcher
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest

    t_phase = time.perf_counter()
    L = HIGHRES_DIT.num_layers
    out = {"dit": {}, "race": {}, "served": {}}
    print(f"  adaptive (phase 3): {adaptive_rec['iterations']} iterations, mean NFE "
          f"{adaptive_rec['mean_nfe']:.2f}, {adaptive_rec['wall_s']:.3f} s")
    for method in ("momentum", "heun"):
        step_ops.launches = step_ops.em_launches = flash_ops.launches = 0
        c0, r0 = ad.captures, ad.host_syncs
        rec = launcher.run("highres_dit", batch=8, precision="fp32", eps_rel=0.05,
                           max_iters=MAIN_MAX_ITERS, flash=True, fused=True, seed=0,
                           liven_seed=0, device=dev, method=method)
        got = {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches,
               "em_step": step_ops.em_launches}
        res, iters = rec["result"], rec["iterations"]
        body = body_iterations(iters, r0, c0)
        want = {"solver_step": body, "flash_attention": 2 * L * body + L, "em_step": 0}
        rule = bool(torch.equal(res.nfe, 2 * (res.accepted + res.rejected) + 1))
        print(f"  [{card}] {method} from HIGHRES_DIT: {iters} iterations, mean NFE "
              f"{rec['mean_nfe']:.2f} (adaptive {adaptive_rec['mean_nfe']:.2f}), "
              f"{rec['wall_s']:.3f} s (adaptive {adaptive_rec['wall_s']:.3f}), accepted "
              f"{int(res.accepted.sum())}, rejected {int(res.rejected.sum())}; nfe = "
              f"2·(accepted + rejected) + 1: {rule}; launches {got} (want {want}); finite "
              f"{rec['finite']}")
        if (not rec["finite"] or rec["shape"] != adaptive_rec["shape"] or not rule
                or iters >= MAIN_MAX_ITERS):
            fail(f"{method} from HIGHRES_DIT: finite {rec['finite']}, shape {rec['shape']}, "
                 f"nfe rule {rule}, {iters} iterations")
        if got != want:
            fail(f"{method} from HIGHRES_DIT launched {got}, not {want}")
        out["dit"][method] = dict(iterations=iters, mean_nfe=rec["mean_nfe"],
                                  wall_s=rec["wall_s"], launches=got)
        del rec, res
    # the graphed momentum and Heun solves against their host-driven chains
    cfg_d, model, score = launcher.build_score("highres_dit", flash=True, precision="fp32",
                                               seed=0, liven_seed=0, device=dev)
    dshape = (8, cfg_d.image_size, cfg_d.image_size, cfg_d.channels)
    out["graphed"] = {}
    for method, field in (("momentum", {"momentum": DEFAULT_BETA}),
                          ("heun", {"probability_flow": True})):
        gcfg = ad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, max_iters=MAIN_MAX_ITERS,
                                 telemetry_capacity=GRAPH_RING, **field)
        out["graphed"][method] = graphed_vs_host(
            f"HIGHRES_DIT {method}", card,
            lambda: sample(VPSDE(), score, dshape, seed=0, method=method, config=gcfg,
                           device=dev),
            lambda: host_chain(VPSDE(), score, dshape, 0, gcfg, dev))
    del model, score
    gc.collect()  # the graph cache's drivers of this net go with it
    torch.cuda.empty_cache()

    # the selection race on the closed-form score, each row's launches exact
    rows = []
    for sde_name, sde_c in (("vp", VPSDE()), ("ve", VESDE(sigma_max=10.0))):
        for solver, spec in solver_select.ZOO.items():
            if spec.get("vp_only") and sde_name != "vp":
                continue
            kw = {"use_fused_kernel": True} if solver in launcher.ADAPTIVE_FAMILY else {}
            step_ops.launches = step_ops.em_launches = 0
            c0, r0 = ad.captures, ad.host_syncs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            row = solver_select.conformance_row(solver, sde_name, sde_c, device=dev, **kw)
            torch.cuda.synchronize()
            row["wall_s"] = time.perf_counter() - t0
            row["launches"] = {"solver_step": step_ops.launches, "em_step": step_ops.em_launches}
            n = spec["kwargs"].get("n_steps", 0)
            want = {"solver_step": body_iterations(row["iterations"], r0, c0) if kw else 0,
                    "em_step": {"em": n, "pc": 2 * n, "pc_hmc": n}.get(solver, 0)}
            print(f"  [{card}] {sde_name} {solver:8s}: W2 {row['w2']:.4f} (gate {row['tol']}), "
                  f"mean NFE {row['mean_nfe']:.1f}, {row['wall_s']:.3f} s, launches "
                  f"{row['launches']} (want {want})")
            if row["launches"] != want:
                fail(f"the {sde_name} {solver} row launched {row['launches']}, not {want}")
            if solver in ("momentum", "heun") and not row["w2"] < row["tol"]:
                fail(f"{solver} on {sde_name} misses its W2 gate: {row['w2']:.4f}")
            rows.append(row)
    report = solver_select.select(rows)
    print("  " + solver_select.render_markdown(report).replace("\n", "\n  "))
    out["race"] = {f"{r['sde']}:{r['solver']}": {k: r[k] for k in (
        "w2", "tol", "mean_nfe", "iterations", "wall_s", "launches")} for r in rows}
    out["winners"] = {w: d["winner"] for w, d in report.items()}

    # each family served: seatmates bitwise solo, device-resident bitwise host-driven
    sde = VPSDE()
    fwd = analytic.gaussian_noise_pred(sde, MU0, S00)
    score = lambda x, t: -fwd(x, t) / bcast(sde.marginal(t)[1], x)  # make_sample_step's
    for family, field in (("momentum", {"momentum": DEFAULT_BETA}),
                          ("heun", {"probability_flow": True})):
        cfg = ad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, **field)
        step = make_sample_step(sde, cfg, forward_fn=lambda p, x, t: fwd(x, t))
        runs = {}
        for resident in (False, True):
            b = DiffusionBatcher(sde, step, None, (ZOO_SERVE_D,), slots=ZOO_SERVE_SLOTS,
                                 cfg=cfg, sync_horizon=SERVE_HORIZON, device=dev,
                                 solver=family, device_resident=resident)
            for u in range(ZOO_SERVE_REQUESTS):
                b.submit(ImageRequest(uid=u, seed=1000 + u))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = b.run_to_completion()
            torch.cuda.synchronize()
            runs[resident] = (b, done, time.perf_counter() - t0)
        (bh, host, wall_h), (bd, dev_done, wall_d) = runs[False], runs[True]
        solo_ok = True
        for u, req in host.items():
            x0 = sde.prior_sample((1, ZOO_SERVE_D), SlotStreams.of([req.seed], 0, device=dev))
            solo = ad.adaptive(sde, score, x0, SlotStreams.of([req.seed], 1, device=dev),
                               config=cfg, denoise=False, device=dev)
            solo_ok &= (np.array_equal(solo.x[0].cpu().numpy(), req.result)
                        and int(solo.nfe[0]) == req.nfe == 2 * (req.accepted + req.rejected))
        same = list(host) == list(dev_done) and all(
            np.array_equal(host[u].result, dev_done[u].result) and host[u].nfe == dev_done[u].nfe
            for u in host)
        recorded = {getattr(m, "__name__", str(m)).split(".")[-2]: n
                    for (m, c), n in bd._driver.graph.recorded.items() if c == "launches"}
        want_p1 = 1 if family == "momentum" else 0  # the unit: one body iteration
        print(f"  [{card}] {family} served ({ZOO_SERVE_REQUESTS} requests, {ZOO_SERVE_SLOTS} "
              f"slots, D {ZOO_SERVE_D}): nfe_per_iter {bh.nfe_per_iter}, wasted NFE "
              f"{bh.wasted_nfe_fraction:.4f}; host-driven {wall_h:.3f} s, "
              f"{bh.host_transfers + bh.solver_syncs} reads; device-resident {wall_d:.3f} s, "
              f"{bd.host_transfers + bd.solver_syncs} reads; every delivery bitwise its solo "
              f"adaptive() {solo_ok}; device-resident bitwise host-driven {same}; the "
              f"captured unit (one body iteration) holds {recorded} (P1 want {want_p1}); "
              f"{bd.device_units} units for {bd.total_iterations} iterations")
        if not (solo_ok and same and len(host) == ZOO_SERVE_REQUESTS):
            fail(f"{family} served: solo {solo_ok}, device-resident = host-driven {same}")
        if (recorded["philox"] != want_p1 or recorded["solver_step"] != 1
                or bd.device_units != bd.total_iterations):
            fail(f"{family}'s captured unit holds {recorded}, or its driver ran "
                 f"{bd.device_units} units for {bd.total_iterations} iterations")
        out["served"][family] = dict(host_wall_s=wall_h, device_wall_s=wall_d,
                                     host_reads=bh.host_transfers + bh.solver_syncs,
                                     device_reads=bd.host_transfers + bd.solver_syncs,
                                     recorded=recorded)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [{card}] zoo phase {out['phase_s']:.1f} s")
    return out


def run_plan_service(dev, card: str) -> dict:
    """Phase 6e, planning served through the batcher. First
    ``launch.plan.serve_planning`` at the reference's defaults (OU, the
    analytic returns-binned score, 6 environments, 4 rounds, 4 slots, sync
    horizon 4), and its steering gate (``tests/test_planning.py``'s: with
    guidance 1.5 on 4 environments and 4 rounds, bin 2's mean reward above
    bin 4's). Then ``RecedingHorizonPlanner`` at TRAJ_UNET's width
    (attention through K3, every GroupNorm → SiLU through K6, seeded and
    livened; only ``transition_dim`` is the environment's, PointMassEnv
    (dim PLAN_SERVE_DIM): 2·dim + dim), horizon 32, returns CFG PLAN_CFG
    (one forward over twice the slots), PLAN_SERVE_SLOTS slots,
    PLAN_SERVE_ENVS environments, PLAN_SERVE_ROUNDS rounds, sync horizon
    SERVE_HORIZON, host-driven, fused step: every plan finite and pinned
    exactly, nfe = 2·(accepted + rejected), and K1 once, K3 twice, K6
    34 times and P1 twice (z and the projection) a body iteration, P1 once
    more an admission. Last, the first round's requests drained through a
    fresh host-driven and a device-resident ``DiffusionBatcher`` with the
    same cfg and conditioner, in turns (host, device, device, host): every
    delivery bitwise the planner's, with its NFE, and the device-resident
    launches exactly the captured unit's (one body iteration) times the
    units run, which are the iterations with a plan active, plus the eager
    calls, and P2 one a unit and one a window. Printed: plans/s, mean NFE, reads, windows, the share
    of the wall outside the solver windows (CUDA events) in both modes, the
    host-driven idle share (torch.profiler). Returns the numbers for the
    kernels line."""
    from repro_torch.configs.diffusion import TRAJ_UNET
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.graph_loop import ops as loop_ops
    from repro_torch.kernels.groupnorm_silu import ops as gn_ops
    from repro_torch.kernels.philox import ops as ph
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.launch import plan as plan_launcher
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.models import temporal_unet as tu
    from repro_torch.observability.tracing import StageTracer
    from repro_torch.planning import (
        PlannerConfig, PlanRequest, PointMassEnv, RecedingHorizonPlanner,
    )
    from repro_torch.serving.diffusion_server import DiffusionBatcher

    t_phase = time.perf_counter()
    out = {}
    ou = plan_launcher.serve_planning(device=dev)
    if not (np.isfinite(ou["mean_reward"]) and ou["plans"] == 24):
        fail(f"serve_planning at the reference's defaults: {ou}")
    steer = {label: plan_launcher.serve_planning(envs=4, steps=4, cfg_scale=1.5,
                                                 returns_label=label, seed=4, device=dev)
             for label in (2, 4)}
    print(f"  steering gate: mean reward bin 2 {steer[2]['mean_reward']:.4f} > bin 4 "
          f"{steer[4]['mean_reward']:.4f}: {steer[2]['mean_reward'] > steer[4]['mean_reward']}")
    if not steer[2]["mean_reward"] > steer[4]["mean_reward"]:
        fail("returns guidance does not steer the OU reward (bin 2 not above bin 4)")
    out["ou"] = {k: ou[k] for k in ("plans", "plans_per_sec", "mean_nfe", "mean_reward",
                                    "wasted_nfe_fraction", "host_transfers", "solver_syncs",
                                    "wall_s")}
    out["steering"] = {str(k): v["mean_reward"] for k, v in steer.items()}

    # the closed loop at TRAJ_UNET's width
    env = PointMassEnv(dim=PLAN_SERVE_DIM)
    ucfg = dataclasses.replace(TRAJ_UNET, transition_dim=env.obs_dim + env.act_dim,
                               attention=True, use_flash=True, use_fused_norm=True)
    unet = tu.init_temporal_unet(ucfg, torch.Generator(device=dev).manual_seed(0))
    tu.liven_zero_init(unet, torch.Generator(device=dev).manual_seed(0))
    sde = VPSDE()
    pcfg = PlannerConfig(horizon=ucfg.horizon, obs_dim=env.obs_dim, act_dim=env.act_dim,
                         guidance_scale=PLAN_CFG)
    fwd = lambda p, x, t, y=None: p(x, t, y=y)
    label = ucfg.returns_bins - 1
    H = SERVE_HORIZON
    per_forward = 2 * (2 * len(ucfg.mults) + 2) + 1  # K6 launches of one forward
    rh = RecedingHorizonPlanner(sde, fwd, unet, pcfg, env,
                                cfg=AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True),
                                slots=PLAN_SERVE_SLOTS, sync_horizon=H, tracer=StageTracer(),
                                device=dev)
    print(f"  TRAJ_UNET at transition {ucfg.transition_dim} (PointMassEnv dim "
          f"{PLAN_SERVE_DIM}): {tu.param_count(unet):,} parameters; {PLAN_SERVE_ENVS} envs x "
          f"{PLAN_SERVE_ROUNDS} rounds on {PLAN_SERVE_SLOTS} slots, CFG {PLAN_CFG} over "
          f"{2 * PLAN_SERVE_SLOTS} rows, returns bin {label}")
    step_ops.launches = flash_ops.launches = gn_ops.launches = ph.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    roll = rh.rollout(0, n_envs=PLAN_SERVE_ENVS, n_steps=PLAN_SERVE_ROUNDS,
                      returns_label=label)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b = rh.batcher
    body = H * b.horizon_windows
    admits = b.tracer.stage_histograms()["serve/admission"]["count"]
    got = {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches,
           "groupnorm_silu": gn_ops.launches, "philox_normal": ph.launches}
    want = {"solver_step": body, "flash_attention": 2 * body,
            "groupnorm_silu": 2 * per_forward * body, "philox_normal": 2 * body + admits}
    n_plans = PLAN_SERVE_ENVS * PLAN_SERVE_ROUNDS
    reads = b.host_transfers + b.solver_syncs
    print(f"  [{card}] closed loop: {n_plans} plans in {wall:.3f} s ({n_plans / wall:.2f} "
          f"plans/s), mean NFE {roll['nfe'].mean():.2f}, mean reward "
          f"{roll['rewards'].mean():.3f} by round {roll['rewards'].mean(1).round(3).tolist()}, "
          f"{b.total_iterations} iterations with a plan active of {body} body iterations "
          f"({b.horizon_windows} chunks), wasted NFE {b.wasted_nfe_fraction:.4f}, reads "
          f"{b.host_transfers} + {b.solver_syncs} solver syncs = {reads}; launches {got} "
          f"(want {want})")
    if got != want:
        fail(f"the served closed loop launched {got}, not {want}")
    bad = []
    for uid, req in roll["finished"].items():
        m = np.asarray(req.cond["mask"]) == 1.0
        if (req.result.shape != pcfg.sample_shape or not np.isfinite(req.result).all()
                or not np.array_equal(req.result[m], np.asarray(req.cond["observed"])[m])
                or req.nfe != 2 * (req.accepted + req.rejected)):
            bad.append(uid)
    if bad or len(roll["finished"]) != n_plans or not np.isfinite(roll["rewards"]).all():
        fail(f"closed loop: plans {bad} not finite, not pinned or off the NFE rule")
    out["closed_loop"] = dict(plans=n_plans, wall_s=wall, plans_per_sec=n_plans / wall,
                              mean_nfe=float(roll["nfe"].mean()),
                              mean_reward=float(roll["rewards"].mean()),
                              iterations=b.total_iterations, body_iterations=body,
                              reads=reads, wasted_nfe_fraction=b.wasted_nfe_fraction,
                              launches=got, transition_dim=ucfg.transition_dim)

    # the first round through a host-driven and a device-resident batcher
    first = {u: roll["finished"][u] for u in range(PLAN_SERVE_ENVS)}
    step = make_sample_step(sde, rh.cfg, forward_fn=fwd)

    def server(resident):
        return DiffusionBatcher(sde, step, unet, pcfg.sample_shape, slots=PLAN_SERVE_SLOTS,
                                cfg=rh.cfg, sync_horizon=H, device=dev,
                                device_resident=resident, tracer=StageTracer())

    def drain(srv):
        for u, req in first.items():
            srv.submit(PlanRequest(uid=u, seed=req.seed, cond=req.cond))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = srv.run_to_completion()
        torch.cuda.synchronize()
        return done, time.perf_counter() - t0

    def describe(tag, srv, wall, span):
        reads = srv.host_transfers + srv.solver_syncs
        mode = (f"{srv.horizon_windows} driver windows, {srv.device_horizons} horizons, capture "
                f"{srv._driver.build_s:.3f} s before the run" if srv.device_resident
                else f"{srv.horizon_windows} chunks")
        share = 1 - span / 1e3 / wall
        print(f"  [{card}] {tag}: {len(first)} plans in {wall:.3f} s ({len(first) / wall:.2f} "
              f"plans/s), reads {srv.host_transfers} + {srv.solver_syncs} = {reads}; {mode}; "
              f"solver windows {span:.1f} ms on the device, share of the wall outside them "
              f"{share:.4f}")
        return dict(wall_s=wall, plans_per_sec=len(first) / wall, reads=reads,
                    windows=srv.horizon_windows, outside_windows_share=share,
                    build_s=srv._driver.build_s if srv.device_resident else 0.0)

    runs = {}
    for tag, resident in (("host", False), ("device", True), ("device_2", True),
                          ("host_2", False)):
        if tag == "device":  # the counts at 0 before the capture's warm-up iteration
            step_ops.launches = flash_ops.launches = gn_ops.launches = ph.launches = 0
            loop_ops.launches = 0
        srv = server(resident)
        times = timed_windows(srv)  # builds the device-resident driver (its capture)
        done, w = drain(srv)
        if tag == "device":
            dev_launches = {"solver_step": step_ops.launches,
                            "flash_attention": flash_ops.launches,
                            "groupnorm_silu": gn_ops.launches, "philox_normal": ph.launches,
                            "horizon_cond": loop_ops.launches}
        runs[tag] = (srv, done, describe(f"first round, {tag.replace('_2', ', again')}",
                                         srv, w, span_ms(times)))
    same = all(list(done) == list(runs["host"][1]) and all(
        np.array_equal(done[u].result, first[u].result) and done[u].nfe == first[u].nfe
        for u in first) for _, done, _ in runs.values())
    print(f"  first-round deliveries of every drain bitwise the planner's, NFE equal: {same}")
    if not same:
        fail("the device-resident (or a fresh host-driven) drain of the first round differs "
             "from the planner's deliveries")
    bd = runs["device"][0]
    names = {step_ops: "solver_step", flash_ops: "flash_attention", gn_ops: "groupnorm_silu",
             ph: "philox_normal"}
    recorded = {names[m]: n for (m, c), n in bd._driver.graph.recorded.items()
                if c == "launches"}
    per_iter = dict(recorded)  # the captured unit: one body iteration
    eager = {k: dev_launches[k] - recorded[k] * bd.device_units for k in recorded}
    admits = bd.tracer.stage_histograms()["serve/admission"]["count"]
    want_iter = {"solver_step": 1, "flash_attention": 2, "groupnorm_silu": 2 * per_forward,
                 "philox_normal": 2}
    want_eager = dict(want_iter, philox_normal=2 + admits)
    print(f"  device-resident launches {dev_launches}: the captured unit holds {per_iter} "
          f"(one body iteration; want {want_iter}), replayed {bd.device_units} times "
          f"({bd.total_iterations} iterations with a sample active, {bd.device_horizons} "
          f"horizons); eager {eager} (want {want_eager}: the capture's warm-up iteration and "
          f"P1 once an admission); P2 {dev_launches['horizon_cond']} (want "
          f"{bd.device_units + bd.horizon_windows}: one a unit and one a window)")
    if (per_iter != want_iter or eager != want_eager
            or bd.device_units != bd.total_iterations
            or dev_launches["horizon_cond"] != bd.device_units + bd.horizon_windows):
        fail(f"device-resident planning launched {dev_launches}")
    if bd.graph_captures != 1:
        fail(f"the device-resident planning server captured {bd.graph_captures} horizons")
    # the host-driven drain's idle share: profiler kernel time over its wall
    by_name, busy_us = profile_device(lambda: drain(server(False)))
    host_wall = runs["host"][2]["wall_s"]
    idle = 1 - busy_us * 1e-6 / host_wall
    print(f"  [{card}] host-driven first round: device busy {busy_us / 1e3:.1f} ms of "
          f"{host_wall * 1e3:.1f} ms, idle share {idle:.3f} (profiler); device-resident idle "
          f"share: not measured (the profiler cannot trace the WHILE-node graph); by device "
          f"time:")
    for name, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"    {us / 1e3:8.1f} ms {c:6d}x  {name[:90]}")
    out["first_round"] = {tag: rec for tag, (_, _, rec) in runs.items()}
    out["first_round"]["host"]["idle_share"] = idle
    out["device_resident_launches"] = dict(dev_launches, per_body_iteration_in_graph=per_iter,
                                           eager=eager)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [{card}] planning-service phase {out['phase_s']:.1f} s")
    del unet, rh, runs
    torch.cuda.empty_cache()
    return out


def bf16_logit_bound(num_layers: int, scale: float) -> float:
    """The bound on max|bf16 logit − fp32 logit| of an LM of
    ``num_layers`` layers whose fp32 logits reach ``scale``: every
    residual update rounds to bf16 (2^-8 relative), two a layer,
    independent roundings add in quadrature, and the largest of the
    vocabulary's errors is taken at BF16_LOGIT_C standard deviations."""
    return BF16_LOGIT_C * math.sqrt(2 * num_layers) * 2.0 ** -8 * scale


def precision_dit(dev, card: str, fp32_rec: dict) -> dict:
    """Phase 9a: HIGHRES_DIT, batch 8, phase 3's seeded and livened
    weights, through ``launch.sample.run(precision=…)`` under ``bf16`` and
    ``bf16_full``, beside phase 3's fp32 record. Gates: finite, delivered
    in fp32, mean NFE ≤ PRECISION_NFE_RATIO × fp32's, K1 exactly one
    launch a body iteration (``body_iterations``: the iterations graphed,
    8·⌈iterations/8⌉ host-driven) and K3 12 a forward (one a
    layer: 2 a body iteration and the denoise), TF32 off after each policy
    is built. Then a forward at batch 8 under each preset and fp32 as
    replayed CUDA graphs, for phase 9f's shares."""
    from repro_torch.configs.diffusion import HIGHRES_DIT
    from repro_torch.core.precision import resolve_policy
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.launch import sample as launcher

    B = 8
    out = {}
    print(f"  fp32 (phase 3): {fp32_rec['iterations']} iterations, mean NFE "
          f"{fp32_rec['mean_nfe']:.2f}, {fp32_rec['wall_s']:.3f} s")
    for preset in PRESETS_BF16:
        step_ops.launches = 0
        flash_ops.launches = 0
        c0, r0 = ad.captures, ad.host_syncs
        rec = launcher.run("highres_dit", batch=B, precision=preset, eps_rel=0.05,
                           max_iters=MAIN_MAX_ITERS, flash=True, fused=True, seed=0,
                           liven_seed=0, device=dev)
        launches = {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches}
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            fail(f"TF32 is on after building the {preset} policy")
        res, iters = rec["result"], rec["iterations"]
        body = body_iterations(iters, r0, c0)
        forwards = 2 * body + 1
        want = {"solver_step": body, "flash_attention": HIGHRES_DIT.num_layers * forwards}
        carry = ad.init_carry(VPSDE(), torch.zeros(B, 4, device=dev), None, precision=preset)
        dtypes = {k: str(getattr(carry, k).dtype)[6:] for k in ("x", "t", "h")}
        ratio = rec["mean_nfe"] / fp32_rec["mean_nfe"]
        print(f"  {preset}: {iters} iterations, mean NFE {rec['mean_nfe']:.2f} ({ratio:.3f}× "
              f"fp32's; gate ≤ {PRECISION_NFE_RATIO}), wall {rec['wall_s']:.3f} s, "
              f"{rec['wall_s'] / forwards * 1e3:.2f} ms per NFE (a batch forward, {forwards} "
              f"run); launches {launches} (want {want}); carry dtypes {dtypes}, delivered "
              f"{str(res.x.dtype)[6:]}, finite {rec['finite']}")
        if not rec["finite"] or res.x.dtype != torch.float32 or res.x.shape[0] != B:
            fail(f"{preset}: the sample is not finite, or not delivered in fp32")
        if ratio > PRECISION_NFE_RATIO:
            fail(f"{preset}: mean NFE {rec['mean_nfe']:.2f} above {PRECISION_NFE_RATIO}× fp32's")
        if launches != want:
            fail(f"{preset}: launches {launches}, want {want}")
        if dtypes["t"] != "float32" or dtypes["h"] != "float32":
            fail(f"{preset}: the control path is not fp32: {dtypes}")
        out[preset] = {"iterations": iters, "mean_nfe": rec["mean_nfe"], "wall_s": rec["wall_s"],
                       "ms_per_nfe": rec["wall_s"] / forwards * 1e3, "launches": launches,
                       "dtypes": dtypes}
        del rec, res
    # one forward at batch 8 under each policy, as a replayed graph
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(B, 256, 256, 3, generator=g, device=dev)
    t = torch.linspace(0.05, 1.0, B, device=dev)
    for preset in ("fp32", *PRESETS_BF16):
        _, model, _ = launcher.build_score("highres_dit", flash=True, precision=preset, seed=0,
                                           liven_seed=0, device=dev)
        policy = resolve_policy(preset)
        with torch.no_grad():
            ms = device_ms(lambda x, t: model(x, t, policy=policy), [(x, t)], reps=10, replays=3)
        out.setdefault(preset, {})["forward_device_ms"] = ms
        print(f"  [{card}] a DiT forward at batch {B}, {preset}: {ms:.3f} ms on the device "
              f"(replayed graph)")
        del model
    torch.cuda.empty_cache()
    return out


def precision_gate(dev) -> dict:
    """Phase 9b: the reference's analytic precision gate on the card, on
    the port's own RNG: the closed-form VP and VE Gaussians (512 × 8, no
    denoise, the fused step: K1 with bf16 state under ``bf16_full``) under
    each bf16 preset: W2 ≤ 2 × fp32's W2 + the Monte-Carlo floor 3·s/√(B·D)
    and mean NFE ≤ PRECISION_NFE_RATIO × fp32's."""
    from repro_torch.analysis import solver_select
    from repro_torch.core import analytic
    from repro_torch.core.sde import VESDE, VPSDE

    rows = {}
    for name, sde in (("vp", VPSDE()), ("ve", VESDE(sigma_max=10.0))):
        r32 = solver_select.conformance_row("adaptive", name, sde, device=dev,
                                            use_fused_kernel=True)
        _, s_a = analytic.gaussian_marginal_moments(sde, solver_select.MU, solver_select.S0)
        floor = 3.0 * s_a / math.sqrt(solver_select.BATCH * solver_select.DIM)
        rows[(name, "fp32")] = r32
        for preset in PRESETS_BF16:
            r = solver_select.conformance_row("adaptive", name, sde, device=dev,
                                              use_fused_kernel=True, precision=preset)
            tol = 2.0 * r32["w2"] + floor
            ok = r["w2"] <= tol and r["mean_nfe"] <= PRECISION_NFE_RATIO * r32["mean_nfe"]
            print(f"  {name} {preset}: W2 {r['w2']:.4f} (gate 2·{r32['w2']:.4f} + {floor:.4f} = "
                  f"{tol:.4f}), mean NFE {r['mean_nfe']:.2f} against fp32's "
                  f"{r32['mean_nfe']:.2f} (gate ≤ {PRECISION_NFE_RATIO}×) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the precision gate: {name} {preset} misses W2 or the NFE ratio")
            rows[(name, preset)] = {**r, "tol": tol}
    return {f"{n} {p}": {k: r[k] for k in ("w2", "mean_nfe", "tol")} for (n, p), r in rows.items()}


def precision_serve(dev, card: str) -> dict:
    """Phase 9c: phase 6a's tiered serve of SERVE_REQUESTS requests under
    ``bf16_full`` (weights, carry and compute in bf16: K2 with bf16
    state, K3 in bf16, P1's noise cast after the draw): every request
    finite, K2 one launch and K3 24 a body iteration, and the SERVE_SOLO
    requests served alone bitwise the mixed run's."""
    from repro_torch.configs.diffusion import HIGHRES_DIT
    from repro_torch.core.precision import resolve_policy
    from repro_torch.core.sde import VPSDE
    from repro_torch.core.solvers.adaptive import AdaptiveConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.launch.sample import make_sample_step
    from repro_torch.models.dit import init_dit, liven_zero_init
    from repro_torch.serving.diffusion_server import DiffusionBatcher, ImageRequest
    from repro_torch.serving.scheduler import EdfPriorityAdmission

    net = dataclasses.replace(HIGHRES_DIT, use_flash=True)
    model = init_dit(net, torch.Generator(device=dev).manual_seed(0))
    liven_zero_init(model, torch.Generator(device=dev).manual_seed(0))
    resolve_policy("bf16_full").cast_params(model)
    sde = VPSDE()
    cfg = AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, precision="bf16_full")
    step = make_sample_step(sde, cfg)
    shape = (net.image_size, net.image_size, net.channels)

    def serve(uids):
        b = DiffusionBatcher(sde, step, model, shape, slots=SERVE_SLOTS, cfg=cfg,
                             sync_horizon=SERVE_HORIZON, tolerance_classes=True,
                             admission=EdfPriorityAdmission(aging_s=5.0), device=dev)
        for u in uids:
            b.submit(ImageRequest(uid=u, seed=u, tier=SERVE_TIERS[u % 3],
                                  deadline_ms=SERVE_DEADLINE_MS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = b.run_to_completion()
        torch.cuda.synchronize()
        return b, done, time.perf_counter() - t0

    uids = list(range(SERVE_REQUESTS))
    step_ops.launches = 0
    flash_ops.launches = 0
    b, done, wall = serve(uids)
    launches = {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches}
    body = SERVE_HORIZON * b.horizon_windows
    want = {"solver_step": body, "flash_attention": 2 * net.num_layers * body}
    means = {t: b.class_stats[t]["mean_nfe"] for t in SERVE_TIERS}
    print(f"  [{card}] bf16_full: served {len(done)}/{len(uids)} in {wall:.3f} s "
          f"({len(done) / wall:.2f} requests/s), {body} body iterations, carry x "
          f"{str(b._carry.x.dtype)[6:]}; mean NFE by tier "
          + ", ".join(f"{t} {m:.2f}" for t, m in means.items())
          + f"; launches {launches} (want {want})")
    bad = [u for u in uids if u not in done or not np.isfinite(done[u].result).all()
           or done[u].result.shape != shape]
    if bad or b._carry.x.dtype != torch.bfloat16:
        fail(f"bf16_full serve: requests {bad} missing or not finite, or the carry is not bf16")
    if launches != want:
        fail(f"bf16_full serve: launches {launches}, want {want}")
    solo_same = {}
    for u in SERVE_SOLO:
        _, solo, _ = serve([u])
        solo_same[u] = (np.array_equal(solo[u].result, done[u].result)
                        and solo[u].nfe == done[u].nfe)
    print(f"  solo runs bitwise the mixed run's: {solo_same}")
    if not all(solo_same.values()):
        fail("bf16_full serve: a request served alone differs from the mixed run")
    del model, b
    torch.cuda.empty_cache()
    return {"wall_s": wall, "requests_per_s": len(done) / wall, "mean_nfe": means,
            "launches": launches, "body_iterations": body}


def bf16_lm(dev, card: str, arch: str, prompts_shape, fp32: dict) -> dict:
    """Phase 9d/9e: ``arch`` at full width in bf16 (``ModelConfig.dtype``;
    the seeded weights of phases 7/7b rounded once, since ``init_model``
    draws in fp32): the prefill of ``prompts_shape`` through K3 ("A"/"L",
    one a layer) or K7 (one a layer) in bf16, each of those calls held
    against its plain version on the inputs the model gave it
    (``held_kernel_calls``), its last-position logits against the fp32
    prefill's of the same weights and prompts within ``bf16_logit_bound``
    with the same greedy token wherever the fp32 top-2 gap exceeds it, and
    beside the bf16 plain path's (a reading: the two bf16 paths round
    differently in every layer); the prefill's wall, device time by kernel and
    peak; serve_batch 4 × (16 + 16); a decode step's wall, device time and
    the decode's idle share."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import forward, init_decode_state, init_model
    from repro_torch.models.transformer import _map, param_count

    cfg = get_config(arch).replace(dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_model(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n = param_count(params)
    print(f"  {arch} in bf16: {n:,} parameters, {torch.cuda.memory_allocated(dev) / 2**30:.2f} "
          f"GiB allocated, made in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(0)  # phases 7/7b's prompts
    prompts = torch.randint(0, cfg.vocab_size, prompts_shape, generator=g, device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    prefill(params, {"tokens": prompts[:, :256]})  # cuBLAS and the allocator warm up
    torch.cuda.reset_peak_memory_stats(dev)
    flash_ops.launches = 0
    ssd_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {"K3": flash_ops.launches, "K7": ssd_ops.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    attn = sum(m in ("A", "L") for m in cfg.mixer_pattern) * cfg.num_repeats
    ssd = sum(m == "M" for m in cfg.mixer_pattern) * cfg.num_repeats
    n_tok = prompts_shape[0] * prompts_shape[1]
    print(f"  prefill {prompts_shape} in bf16: {prefill_s:.3f} s ({n_tok / prefill_s:.0f} "
          f"tokens/s; fp32 {fp32['prefill_s']:.3f} s), peak {peak:.2f} GiB; launches {launches} "
          f"(want K3 {attn}, K7 {ssd}: one a layer)")
    if launches != {"K3": attn, "K7": ssd}:
        fail(f"{arch} bf16 prefill: launches {launches}, want K3 {attn}, K7 {ssd}")
    if not bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()):
        fail(f"{arch} bf16 prefill: tokens {nxt.tolist()} out of range")
    with torch.no_grad():
        (got, _), held = held_kernel_calls(
            lambda: forward(params, prompts, cfg, last_logits_only=True))
        plain, _ = forward(params, prompts, cfg, last_logits_only=True, use_flash=False,
                           use_kernel_ssd=False)
    print(f"  each kernel call of the bf16 prefill held against its plain version on the "
          f"inputs the model gave it (phase 2's bounds, element by element): "
          + ", ".join(f"{k} {n} calls, worst {w:.3f} of the bound" for k, (n, w) in held.items()))
    if held["K3"][0] != attn or held["K7"][0] != ssd:
        fail(f"{arch} bf16 prefill: held {held}, want K3 {attn}, K7 {ssd} calls")
    if max(w for _, w in held.values()) > 1:
        fail(f"{arch} bf16 prefill: a kernel call in the model disagrees with its plain version")
    want = fp32["fp32_logits"].to(dev)
    got, plain = got.float(), plain.float()
    kp_err, plain_err = (got - plain).abs().max().item(), (plain - want).abs().max().item()
    print(f"  last-position logits, bf16 kernel path against the bf16 plain path: max abs "
          f"diff {kp_err:.3e} ({kp_err / max(plain_err, 1e-30):.3f} of the plain path's own "
          f"{plain_err:.3e} against fp32)")
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    bound = bf16_logit_bound(cfg.num_layers, scale)
    finite = bool(torch.isfinite(got).all())
    rows = want.reshape(-1, want.shape[-1])
    same = (got.reshape(rows.shape).argmax(-1) == rows.argmax(-1)).tolist()
    gaps = [top2_gap(r) for r in rows]
    print(f"  last-position logits, bf16 against fp32 (the same seeded weights): max abs err "
          f"{err:.3e} = {err / scale:.4f} of max|logit| {scale:.3f} (bound {BF16_LOGIT_C}·"
          f"sqrt(2·{cfg.num_layers})·2^-8·max|logit| = {bound:.3e}), finite {finite}; greedy "
          f"tokens equal {same} at top-2 gaps {[f'{v:.3e}' for v in gaps]}")
    if not finite or err > bound:
        fail(f"{arch}: the bf16 prefill's logits are not within the bound of fp32's")
    if any(not s and gap > bound for s, gap in zip(same, gaps)):
        fail(f"{arch}: a bf16 greedy token differs from fp32's past the bound")
    by_name, total_us = profile_device(lambda: prefill(params, {"tokens": prompts}))
    kern_us = {"K3": sum(us for nm, (_, us) in by_name.items() if "flash_fwd" in nm),
               "K7": sum(us for nm, (_, us) in by_name.items() if "ssd_scan" in nm)}
    gemm_us = sum(us for nm, (_, us) in by_name.items()
                  if any(w in nm.lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"  [{card}] one bf16 prefill: {total_us / 1e3:.1f} ms of device time (fp32 "
          f"{fp32['prefill_device_ms']:.1f} ms); K3 {kern_us['K3'] / 1e3:.1f} ms, K7 "
          f"{kern_us['K7'] / 1e3:.1f} ms, GEMMs {gemm_us / 1e3:.1f} ms "
          f"({100 * gemm_us / total_us:.1f} %); largest: " + "; ".join(
              f"{nm[:50]} x{c} {us / 1e3:.1f} ms" for nm, (c, us) in top))
    del got, want, plain

    R, P, G = LM_SERVE
    sprompts = torch.randint(0, cfg.vocab_size, (R, P), generator=g, device=dev)
    for _ in range(2):  # warm-up at the timed call's key: eager, then its capture
        serve_batch(cfg, params, sprompts[:, :2], gen_len=2, cache_len=P + G, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve_batch(cfg, params, sprompts, gen_len=G, device=dev)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    step_ms = serve_s / (P + G - 1) * 1e3
    if toks.shape != (R, G) or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"{arch} bf16 serve_batch: tokens out of range")
    step = make_serve_step(cfg, device=dev).eager  # the profiler traces eager steps
    state = init_decode_state(cfg, R, P + G, device=dev)
    states = []
    _map(lambda a: states.append(str(a.dtype)[6:]), state)

    def decode_loop(n=LM_IDLE_STEPS):
        nonlocal state
        tok = toks[:, :1]
        for _ in range(n):
            tok, state = step(params, {"tokens": tok}, state)

    decode_loop(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_loop()
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    by_name, busy_us = profile_device(decode_loop)
    idle = 1 - busy_us / 1e3 / loop_ms
    print(f"  [{card}] serve_batch {R} × ({P} + {G}) in bf16: {serve_s:.3f} s, {step_ms:.2f} ms "
          f"a decode step (graphed); eager decode {LM_IDLE_STEPS} steps {loop_ms:.1f} ms wall, "
          f"device {busy_us / 1e3 / LM_IDLE_STEPS:.2f} ms a step, idle share {idle:.2f}; decode "
          f"state "
          f"dtypes {sorted(set(states))}")
    del params, state
    torch.cuda.empty_cache()
    return {"params": n, "prefill_s": prefill_s, "prefill_device_ms": total_us / 1e3,
            "kernel_device_ms": {k: v / 1e3 for k, v in kern_us.items()},
            "gemm_device_ms": gemm_us / 1e3, "peak_gib": peak, "launches": launches,
            "logit_err": err, "logit_bound": bound, "same_tokens": same,
            "held": held, "kernel_vs_plain_logit_diff": kp_err, "plain_logit_err": plain_err,
            "serve_ms_per_step": step_ms, "decode_device_ms_per_step":
                busy_us / 1e3 / LM_IDLE_STEPS, "decode_idle_share": idle}


def roofline_shares(card: str, dit: dict, gemma: dict, mamba: dict, alm: dict, lm: dict,
                    ) -> dict:
    """Phase 9f: the share of the card's peak reached by (a)'s forward, and
    by (d)'s and (e)'s prefills, bf16 and fp32: the dry run's counted
    FLOPs of the same config and shape (``launch/dryrun.py::step_cost`` on
    meta tensors, run here: K3's layers by their visible pairs, as the
    kernel computes them) over the measured device time and the dtype's
    peak (``analysis/roofline.py``: bf16 989, fp32 67 TFLOP/s), with
    ``analyze_record``'s bounding term; the plain path's dense S × S count
    printed beside it. A share above MAX_SHARE fails: the count would be
    too low."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, sample as launcher
    from repro_torch.launch.specs import build_dryrun

    rows = []
    for preset in ("fp32", *PRESETS_BF16):
        rec = launcher.dryrun(8, preset, save=False)
        dtype = "float32" if preset == "fp32" else "bfloat16"
        cost = {"flops": rec["per_nfe"]["flops"], "est_hbm_traffic_bytes": rec["per_nfe"]["bytes"]}
        rows.append((f"HIGHRES_DIT forward, batch 8, {preset}", dtype, cost,
                     dit[preset]["forward_device_ms"]))
    for arch, shp, b16, f32 in (("gemma3-12b", GEMMA_PREFILL, gemma, alm),
                                ("mamba2-2.7b", LM_PREFILL, mamba, lm)):
        shape = InputShape(f"prefill_{shp[1]}", shp[1], shp[0], "prefill")
        for dtype, ms in (("bfloat16", b16["prefill_device_ms"]),
                          ("float32", f32["prefill_device_ms"])):
            spec = build_dryrun(get_config(arch), shape, dtype=dtype)
            rows.append((f"{arch} prefill {shp}, {dtype}", dtype, dryrun.step_cost(spec, shape),
                         ms))
    out = {}
    for label, dtype, cost, ms in rows:
        a = roofline.analyze_record({"dtype": dtype, "cost": cost}, model_flops=0.0)
        flops, dense = cost["flops"], cost.get("plain_path", cost)["flops"]
        share = roofline.share_of_peak(flops, ms * 1e-3, dtype)
        roof = max(a["t_compute_s"], a["t_memory_s"]) / (ms * 1e-3)
        print(f"  [{card}] {label}: {flops / 1e12:.3f} TFLOP counted (dry run, meta; K3 by "
              f"visible pairs) in {ms:.3f} ms of device time: {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{share:.3f} of the {roofline.peak_flops(dtype) / 1e12:.0f} TFLOP/s peak (the "
              f"plain path's dense count {dense / 1e12:.3f} TFLOP would give "
              f"{roofline.share_of_peak(dense, ms * 1e-3, dtype):.3f}); bounding term "
              f"{a['dominant']} ({a['t_compute_s'] * 1e3:.3f} ms compute, "
              f"{a['t_memory_s'] * 1e3:.3f} ms memory): {roof:.3f} of the roofline")
        if share > MAX_SHARE or roof > MAX_SHARE:
            fail(f"{label}: {share:.3f} of the peak, {roof:.3f} of the roofline: the count is "
                 f"too low")
        out[label] = {"tflop": flops / 1e12, "dense_tflop": dense / 1e12, "device_ms": ms,
                      "share": share, "roofline_share": roof,
                      "bound_by": "operations" if a["dominant"] == "compute" else "bytes"}
    return out


def bf16_kernel_times(dev, card: str) -> dict:
    """The kernels at phase 9's bf16 shapes, device time from replayed
    CUDA graphs beside the bound (bytes: each input read once, each output
    written once; operations at the peak of their type), the plain version
    and the library call where one exists: K1 at (8, 196,608) with bf16
    state, scalar and per-row (K2: the tiers' eps) tolerances; K3 at
    gemma3-12b's "L" and "A" (``k3_lm_times``); K7 at mamba2-2.7b's
    prefill shape."""
    from repro_torch.configs.diffusion import HIGHRES_DIT, TOLERANCE_CLASSES
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    gen = torch.Generator(device=dev).manual_seed(27)
    out = {}
    B, D = 8, HIGHRES_DIT.image_size ** 2 * HIGHRES_DIT.channels
    rel = torch.tensor([TOLERANCE_CLASSES[SERVE_TIERS[i % 3]].eps_rel for i in range(B)],
                       device=dev)
    atol = torch.full((B,), 0.0078, device=dev)
    sets = [(*[torch.randn(B, D, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(5)],
             *[torch.rand(B, generator=gen, device=dev) for _ in range(3)]) for _ in range(4)]
    nbytes = 6 * B * D * 2 + 5 * B * 4 + B * 4
    nops = STEP_FLOPS_PER_ELEMENT * B * D
    bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOPS) * 1e3
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_FLOPS else "operations"
    for name, fn, plain in (
            ("K1", lambda *a: step_ops.error_step(*a, eps_abs=0.0078, eps_rel=0.05),
             lambda *a: step_ref.error_step(*a, atol, torch.full((B,), 0.05, device=dev))),
            ("K2", lambda *a: step_ops.error_step(*a, eps_abs=atol, eps_rel=rel),
             lambda *a: step_ref.error_step(*a, atol, rel))):
        ms, plain_ms = device_ms(fn, sets), device_ms(plain, sets)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library_ms=None)
        print(f"  [{card}] solver_step {name} ({B}, {D}) bf16 state: {ms * 1e3:.2f} us on the "
              f"device, bound {bound * 1e3:.2f} us ({by}); plain {plain_ms * 1e3:.1f} us")
    del sets
    out["K3"] = k3_lm_times(dev, gen, card, torch.bfloat16)
    shape = SSD_SHAPES[0]
    sets = [ssd_inputs(*shape, gen=gen, dtype=torch.bfloat16) for _ in range(2)]
    ms = device_ms(lambda *a: ssd_ops.ssd_scan(*a), sets, reps=20, replays=2)
    plain_ms = device_ms(lambda *a: ssd_ref.ssd_chunked(*a), sets, reps=4, replays=2)
    flops, _ = ssd_work(*shape)
    b_, s_, h_, p_, g_, n_ = shape
    nbytes = 2 * (2 * b_ * s_ * h_ * p_ + 2 * b_ * s_ * g_ * n_) + 4 * (b_ * s_ * h_ + h_)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    out["K7"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None,
                     ranges=ssd_ops.ranges_for(sets[0][0]))
    print(f"  [{card}] ssd_scan {shape} bf16: {ms:.3f} ms on the device; bound "
          f"{out['K7']['bound_ms']:.3f} ms ({out['K7']['bound_by']}: {flops / 1e9:.1f} GFLOP at "
          f"989 TFLOP/s, {nbytes / 1e6:.1f} MB); plain {plain_ms:.3f} ms")
    del sets
    torch.cuda.empty_cache()
    return out


def run_precision(dev, card: str, fp32_dit: dict, alm: dict, lm: dict) -> dict:
    """Phase 9, the precision seams in bf16 at full width (a–f)."""
    t_phase = time.perf_counter()
    held_below_1gib(dev, "the precision phase")
    print("  (a) HIGHRES_DIT sampled under bf16 and bf16_full")
    dit = precision_dit(dev, card, fp32_dit)
    print("  (b) the analytic precision gate (VP, VE × bf16, bf16_full)")
    gate = precision_gate(dev)
    print("  (c) the tiered serve under bf16_full")
    srv = precision_serve(dev, card)
    print("  the kernels at the bf16 shapes")
    times = bf16_kernel_times(dev, card)
    print("  (d) gemma3-12b in bf16")
    held_below_1gib(dev, "gemma3-12b in bf16")
    gemma = bf16_lm(dev, card, "gemma3-12b", GEMMA_PREFILL, alm)
    print("  (e) mamba2-2.7b in bf16")
    held_below_1gib(dev, "mamba2-2.7b in bf16")
    mamba = bf16_lm(dev, card, "mamba2-2.7b", LM_PREFILL, lm)
    print("  (f) roofline shares")
    shares = roofline_shares(card, dit, gemma, mamba, alm, lm)
    phase_s = time.perf_counter() - t_phase
    print(f"  [{card}] precision phase {phase_s:.1f} s")
    return {"dit": dit, "gate": gate, "serve": srv, "gemma3-12b": gemma,
            "mamba2-2.7b": mamba, "shares": shares, "times": times, "phase_s": phase_s}


def meta_gate(runs: list, world: int, backend: str, what: str) -> float:
    """Phases 10 and 11's meta = books gate: each run's every rank counted
    the dry run's steps (``specs.build_dryrun``) on meta tensors for its
    coordinate (``sharded_selftest.meta_books``); prints each step's
    ``meta_equal`` and the counts' seconds a rank, and fails where a count
    differs from the books. Returns the slowest rank's seconds over the
    runs (runs without a count, ``train_loop``'s, are skipped)."""
    per_rank = None
    for r in runs:
        ranks = [p for p in r["ranks"] if "meta_equal" in p]
        if not ranks:
            continue
        per_rank = [0.0] * len(ranks) if per_rank is None else per_rank
        steps = {}
        for i, p in enumerate(ranks):
            eq = p["meta_equal"] if isinstance(p["meta_equal"], dict) else {
                "train step": p["meta_equal"]}
            for step, same in eq.items():
                steps.setdefault(step, []).append(bool(same))
            per_rank[i] += p["meta_s"]
        label = (f"{r['arch']} ({r.get('layers') or 'all'} layers) mesh "
                 f"{r['mesh'][0]}x{r['mesh'][1]}" + (f" {r['layout']}" if "layout" in r else "")
                 + (f" remat={r['remat']}" if r.get("remat", "none") != "none" else "")
                 + (" flash-decode" if r.get("flash_decode") else ""))
        print(f"  {what} world {world} over {backend} {label}: meta_equal "
              f"{ {k: v for k, v in steps.items()} }, counted in "
              f"{[round(p['meta_s'], 2) for p in ranks]} s a rank")
        for step, same in steps.items():
            if not all(same):
                fail(f"{what} world {world} over {backend} {label}: the {step}'s meta count "
                     f"differs from its books")
    return max(per_rank or [0.0])


def lm_mesh_plan(runs, mesh, records: dict, out_dir: str, *, flash: bool = True,
                 graphed: bool = False) -> list:
    """The selftest's ``--lm-plan`` for ``runs`` on ``mesh``, each compared
    with its unsharded record and writing rank 0's record; ``flash``
    keeps the runs' second decode with ``decode_flash_shard="model"``;
    ``graphed`` adds the serve step under the mesh graphed against its
    eager step (``sharded_selftest.graphed_decode``)."""
    plan = []
    for arch, layers, prefill, decode, also_flash in runs:
        key = (arch, layers)
        plan.append(dict(arch=arch, layers=layers, mesh=list(mesh), prefill=list(prefill),
                         decode=list(decode), record=records[key],
                         out=os.path.join(out_dir, f"{arch}-{layers}-{mesh[0]}x{mesh[1]}.pt"),
                         also_flash=flash and also_flash, tol=LM_LOGIT_TOL, graphed=graphed))
    return plan


def run_world1(run, plan: list, what: str) -> dict:
    """A selftest plan at world 1 over NCCL in this process
    (``sharded_selftest.run_lm`` or ``run_train``: at world 1 the rank runs
    in the caller's process, which spares a new process seconds of
    reaching the card); fails on a raise or a failed check."""
    t0 = time.perf_counter()
    try:
        res = run(1, plan, device="cuda", backend="nccl")
    except Exception as e:  # noqa: BLE001  (any failure of the run fails the phase)
        fail(f"{what} at world 1 over NCCL raised {type(e).__name__}: {e}")
    res["wall_s"] = time.perf_counter() - t0
    print(f"  {what} world 1 over nccl (in this process), ok {res['ok']} in "
          f"{res['wall_s']:.1f} s")
    if not res["ok"]:
        print(json.dumps(res, default=str)[:4000])
        fail(f"{what} at world 1 over NCCL failed its checks")
    return res


def run_lm_selftest(world: int, backend: str, plan: list, out_dir: str) -> dict:
    """The sharded selftest's LM check in a subprocess: ``world`` ranks over
    ``backend`` on this card, one spawn for the whole ``plan``."""
    path = os.path.join(out_dir, f"plan-{world}-{backend}.json")
    with open(path, "w") as f:
        json.dump(plan, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.sharded_selftest", "--device", "cuda",
           "--backend", backend, "--world", str(world), "--lm-plan", path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=LM_MESH_TIMEOUT_S)
    line = (proc.stdout.strip().splitlines() or ["{}"])[-1]
    wall = time.perf_counter() - t0
    print(f"  LM selftest world {world} over {backend}, exit {proc.returncode} in {wall:.1f} s")
    if proc.returncode != 0:
        print(line[:4000])
        print(proc.stderr[-6000:], file=sys.stderr)
        fail(f"the LM sharded selftest at world {world} over {backend} failed")
    res = json.loads(line)
    res["wall_s"] = wall
    return res


def run_lm_mesh(dev, card: str) -> dict:
    """Phase 10: the language models served under a ("data", "model") mesh
    (fp32, TF32 off, seeded weights). (a) Each model of ``LM_MESH_RUNS``
    and ``LM_ROWS_RUN`` unsharded here (``sharded_selftest.lm_record``:
    the prefill through K3/K7, then greedy decode steps), its record
    written and the model freed before any spawn; (b) world 1 over NCCL in
    this process (``run_world1``), mesh (1, 1): every record bitwise the
    unsharded one; (c) world 2 over
    gloo with both ranks on this card, mesh (1, 2), in one spawn that
    builds and frees the models in turn (gemma3-12b decoded a second time
    with decode_flash_shard="model"), and (d) ``LM_ROWS_RUN`` on mesh
    (2, 1) in the same spawn: logits within LM_LOGIT_TOL·max|logit|,
    greedy tokens equal except below the top-2 gap, deepseek's prefill
    held by ``hold_moe_logits``; K3 and K7 launched on every rank, once a
    layer; every rank's residual and tokens the same bits. Returns the
    numbers of the kernels line and PERF.md."""
    import tempfile

    from repro_torch.launch import sharded_selftest as st
    from repro_torch.models import init_model
    from repro_torch.models.transformer import param_count

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="lm_mesh_")
    records, unsharded = {}, {}
    for arch, layers, prefill, decode, _ in LM_MESH_RUNS + (LM_ROWS_RUN,):
        held_below_1gib(dev, f"{arch} ({layers or 'all'} layers) unsharded")
        cfg = st.lm_config(arch, layers=layers)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_model(cfg, 0, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rec = st.lm_record(cfg, params, st.lm_inputs(cfg, prefill, decode), decode[1], dev)
        n = param_count(params)
        want = {"K3": sum(m in ("A", "L") for m in cfg.mixer_pattern) * cfg.num_repeats,
                "K7": cfg.mixer_pattern.count("M") * cfg.num_repeats}
        got = {k: rec["prefill_counts"][k] for k in want}
        print(f"  [{card}] {arch} ({cfg.num_layers} layers) unsharded: {n:,} parameters "
              f"({n * 4 / 2**30:.2f} GiB fp32), built in {build_s:.1f} s; prefill {prefill} "
              f"{rec['prefill_s']:.3f} s (cold), K3 {got['K3']} K7 {got['K7']}; {decode[1]} "
              f"decode steps of {decode[0]} in {rec['decode_s']:.3f} s; peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        if got != want:
            fail(f"{arch}: the unsharded prefill launched {got}, want {want}")
        path = os.path.join(out_dir, f"{arch}-{layers}-unsharded.pt")
        torch.save(rec, path)
        records[(arch, layers)] = path
        unsharded[(arch, layers)] = {"prefill_s": rec["prefill_s"], "decode_s": rec["decode_s"],
                                     "params": n, "build_s": build_s, "record": rec}
        del params
        torch.cuda.empty_cache()
    held_below_1gib(dev, "the spawns")

    one = run_world1(st.run_lm, lm_mesh_plan(LM_MESH_RUNS, (1, 1), records, out_dir,
                                             flash=False, graphed=True), "LM selftest")
    graphed = {}
    for r in one["lm"]:
        c = r["compare"]
        print(f"  world 1 (NCCL) {r['arch']}: bitwise {c['bitwise']}, picks the argmax "
              f"{r['pick_bitwise']}, prefill err "
              f"{c['prefill_logits']['max_abs_err']:.3e}, decode err "
              f"{c['decode_logits']['max_abs_err']:.3e}, launches {r['ranks'][0]['prefill_counts']}")
        if not c["bitwise"]:
            fail(f"world 1: {r['arch']} under the (1, 1) mesh is not the unsharded record bitwise")
        g = r["graphed_decode"][0]
        graphed[r["arch"]] = g
        print(f"  [{card}] world 1 (NCCL) {r['arch']} serve step under the mesh, graphed "
              f"{g['graphed']}: tokens bitwise the eager step {g.get('tokens_bitwise')}, state "
              f"bitwise {g.get('state_bitwise')}, captures {g.get('captures')} (build "
              f"{g.get('build_s', 0.0):.3f} s), a replay's books = the dry run's meta count "
              f"{g.get('meta_equal')}; {g.get('graphed_ms_per_step', 0.0):.2f} ms a step graphed, "
              f"{g.get('eager_ms_per_step', 0.0):.2f} ms eager")
        if not (g["graphed"] and g["tokens_bitwise"] and g["state_bitwise"]
                and g["captures"] == 1 and g["meta_equal"]):
            fail(f"world 1: {r['arch']}'s graphed serve step under the mesh missed a gate")
    meta1 = meta_gate(one["lm"], 1, "nccl", "LM")
    plan2 = (lm_mesh_plan(LM_MESH_RUNS, (1, 2), records, out_dir)
             + lm_mesh_plan((LM_ROWS_RUN,), (2, 1), records, out_dir))
    held_below_1gib(dev, "the world-2 spawn")
    two = run_lm_selftest(2, "gloo", plan2, out_dir)
    out = {"world1": one, "world2": two, "unsharded": {}, "graphed_decode": graphed}
    for r in two["lm"]:
        arch, key = r["arch"], (r["arch"], r["layers"])
        label = f"world 2 (gloo) {arch} mesh {tuple(r['mesh'])}" + (
            " flash-decode" if r["flash_decode"] else "")
        c = r["compare"]
        ranks = r["ranks"]
        pc = [p["prefill_counts"] for p in ranks]
        dc = [p["decode_step_counts"] for p in ranks]
        print(f"  {label}: prefill err {c['prefill_logits']['max_abs_err']:.3e} (bound "
              f"{c['prefill_logits']['bound']:.3e}), decode err "
              f"{c['decode_logits']['max_abs_err']:.3e} (bound {c['decode_logits']['bound']:.3e}); "
              f"tokens differing {c['token_mismatches']} beyond the top-2 gap, "
              f"{c['token_mismatches_near_tie']} at near ties; ranks agree {r['ranks_agree']}; "
              f"every pick over the vocab columns the gathered argmax {r['pick_bitwise']}")
        print(f"  [{card}] {label}: prefill {[round(p['prefill_s'], 3) for p in ranks]} s a rank "
              f"(unsharded {unsharded[key]['prefill_s']:.3f} s, both cold), decode "
              f"{[round(p['decode_s'], 3) for p in ranks]} s (unsharded "
              f"{unsharded[key]['decode_s']:.3f} s); a prefill's collectives {pc[0]['collectives']}"
              f" ({pc[0]['collective_bytes'] / 1e6:.1f} MB a rank), a decode step's "
              f"{dc[0]['collectives']:.0f} ({dc[0]['collective_bytes'] / 1e6:.3f} MB); K3 "
              f"{[p['K3'] for p in pc]}, K7 {[p['K7'] for p in pc]} a rank; parameters a rank "
              f"{ranks[0]['params_local']:,}; peak {[round(p['peak_gib'], 2) for p in ranks]} GiB "
              f"serving, {[round(p['build_peak_gib'], 2) for p in ranks]} GiB building")
        if not r["ranks_agree"]:
            fail(f"{label}: the ranks' residuals or tokens differ")
        if not r["pick_bitwise"]:
            fail(f"{label}: a vocab-parallel pick is not the gathered logits' argmax")
        if arch == "deepseek-moe-16b":
            got = torch.load(r["out"])
            want = unsharded[key]["record"]
            hold = hold_moe_logits(label, got["prefill_logits"][:, None],
                                   want["prefill_logits"][:, None], got["routing"],
                                   want["routing"])
            if not c["decode_logits"]["ok"] or c["token_mismatches"]:
                fail(f"{label}: decode misses the bound ({c})")
            r["hold_moe"] = hold
        elif not c["ok"]:
            fail(f"{label}: {c}")
    meta2 = meta_gate(two["lm"], 2, "gloo", "LM")
    if not two["ok"]:
        fail("the world-2 LM selftest did not pass its own checks (launch counts, agreement, "
             "meta = books)")
    out["meta_s"] = {"world1": meta1, "world2": meta2}
    for key, u in unsharded.items():
        out["unsharded"][f"{key[0]}:{key[1] or 'all'}"] = {k: u[k] for k in (
            "prefill_s", "decode_s", "params", "build_s")}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [{card}] LM mesh phase {out['phase_s']:.1f} s (selftests {one['wall_s']:.1f} s, "
          f"{two['wall_s']:.1f} s; the meta counts {meta1:.1f} s at world 1, {meta2:.1f} s a "
          f"rank at world 2)")
    return out


def train_mesh_plan() -> list:
    """Phase 11's world-2 training plan (``sharded_selftest --train-plan``):
    musicgen-medium at ``TRAIN_MESH_TP_LAYERS`` layers on 1×2 "tp" (kept)
    and with ``remat="full"`` (its bits, a lower peak), at
    ``TRAIN_MESH_DATA_LAYERS`` layers on 2×1 plain data parallelism,
    "fsdp" and "zero1"; then each of ``TRAIN_MESH_MIXERS`` one step at 1×2,
    gradients only in its record. Every run against the unsharded port
    trained by each rank, the ranks at once, on this card."""
    B, S = TRAIN_MESH_SHAPE
    base = dict(arch=TRAIN_MESH_ARCH, steps=TRAIN_MESH_STEPS, batch=B, seq=S,
                lr=TRAIN_MESH_LR, reference="self")
    tp = dict(base, mesh=[1, 2], layers=TRAIN_MESH_TP_LAYERS)
    cut = dict(base, mesh=[2, 1], layers=TRAIN_MESH_DATA_LAYERS)
    plan = [dict(tp, layout="tp", keep=True),
            dict(tp, layout="tp", remat="full", same_bits_as=0),
            dict(cut, layout="tp"), dict(cut, layout="fsdp"), dict(cut, layout="zero1")]
    for arch, layers in TRAIN_MESH_MIXERS:
        plan.append(dict(arch=arch, layers=layers, mesh=[1, 2], layout="tp", steps=1, batch=B,
                         seq=S, lr=TRAIN_MESH_LR, reference="self", grads_only=True))
    return plan


def run_train_selftest(world: int, backend: str, plan: list, out_dir: str) -> dict:
    """The sharded selftest's training plan in a subprocess: ``world`` ranks
    over ``backend`` on this card, one spawn for the whole ``plan``."""
    path = os.path.join(out_dir, f"train-plan-{world}-{backend}.json")
    with open(path, "w") as f:
        json.dump(plan, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.sharded_selftest", "--device", "cuda",
           "--backend", backend, "--world", str(world), "--train-plan", path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=TRAIN_MESH_TIMEOUT_S)
    line = (proc.stdout.strip().splitlines() or ["{}"])[-1]
    wall = time.perf_counter() - t0
    print(f"  training selftest world {world} over {backend}, exit {proc.returncode} in "
          f"{wall:.1f} s")
    if proc.returncode != 0:
        print(line[:4000])
        print(proc.stderr[-6000:], file=sys.stderr)
        fail(f"the training selftest at world {world} over {backend} failed")
    res = json.loads(line)
    res["wall_s"] = wall
    print(f"  the spawn {res['seconds']:.1f} s of it; a run's wall on rank 0 (its unsharded "
          f"record included): {[round(r['ranks'][0]['run_s'], 1) for r in res['train']]} s")
    return res


def per_step_counts(counts: list) -> str:
    """A steady step's collectives by kind (the last step's): calls and MB."""
    last = counts[-1]
    return ", ".join(f"{k} {c} ({b / 1e6:.1f} MB)" for k, (c, b) in sorted(last.items()))


def run_train_mesh(dev, card: str) -> dict:
    """Phase 11: LM training under a ("data", "model") mesh (fp32, TF32 off,
    seeded weights, the plain attention and SSD: no kernel has a backward).
    (a) World 1 over NCCL in this process, mesh 1×1: musicgen-medium at
    ``TRAIN_MESH_TP_LAYERS`` layers, ``train_loop``
    for ``TRAIN_MESH_STEPS`` steps of ``TRAIN_MESH_SHAPE`` unsharded and
    under the mesh, every loss and the final parameters bitwise. (b) World
    2 over gloo, both ranks on this card (``train_mesh_plan``): every
    gradient and new block within the CPU tests' bounds of the unsharded
    port's, every step's loss within 1e-5 relative, the clip scale the same
    bits on every rank; remat "full" the same bits as "tp" with a lower
    peak; fsdp's and zero1's peak a rank below plain data parallelism's;
    K3 and K7 launched 0 times; at 1×2 (the vocab-parallel loss) no
    all-gather booked by the first step. Prints the walls (first and
    steady), peaks against the unsharded run's (and at 1×2 against the
    gathered loss's, ``TRAIN_MESH_GATHER_PEAK_GIB``), collectives and MB a
    step by kind, and the errors, each beside the card."""
    import tempfile

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="train_mesh_")
    held_below_1gib(dev, "the training spawns")
    B, S = TRAIN_MESH_SHAPE
    from repro_torch.launch import sharded_selftest as st

    one = run_world1(st.run_train, [dict(arch=TRAIN_MESH_ARCH, kind="train_loop", mesh=[1, 1],
                                         layers=TRAIN_MESH_TP_LAYERS, steps=TRAIN_MESH_STEPS,
                                         batch=B, seq=S, lr=TRAIN_MESH_LR)],
                     "training selftest")
    r = one["train"][0]
    print(f"  [{card}] world 1 (NCCL) {TRAIN_MESH_ARCH} ({r['layers']} layers) train_loop mesh "
          f"1x1, {TRAIN_MESH_STEPS} "
          f"steps of {B} x {S}: losses {r['losses']} (unsharded {r['plain_losses']}), losses "
          f"bitwise {r['losses_bitwise']}, parameters bitwise {r['params_bitwise']} (max abs "
          f"err {r['max_abs_err']:.3e}); step walls {[round(t, 3) for t in r['step_s']]} s "
          f"(unsharded {[round(t, 3) for t in r['plain_step_s']]} s); "
          f"loops {r['plain_s']:.1f} s unsharded, {r['mesh_s']:.1f} s under the mesh; peak "
          f"{r['peak_gib']:.2f} GiB")
    if not (one["ok"] and r["losses_bitwise"] and r["params_bitwise"]):
        fail("world 1: train_loop under the (1, 1) mesh is not the unsharded loop bitwise")
    held_below_1gib(dev, "the world-2 training spawn")
    two = run_train_selftest(2, "gloo", train_mesh_plan(), out_dir)
    runs = two["train"]
    for run in runs:
        ranks = run["ranks"]
        label = (f"world 2 (gloo) {run['arch']} ({run['layers']} layers) mesh "
                 f"{run['mesh'][0]}x{run['mesh'][1]} {run['layout']}"
                 + (f" remat={run['remat']}" if run["remat"] != "none" else ""))
        hold = [p["hold"] for p in ranks]
        new = ("not held (a gradients-only record)" if hold[0]["new_leaf"] is None else
               f"{max(h['new_err'] for h in hold):.3e} "
               f"({max(h['new_ratio'] for h in hold):.3e})")
        same = ("; the same bits as the kept run: " + str(all(p["same_bits"] for p in ranks))
                if "same_bits" in ranks[0] else "")
        print(f"  {label}: loss {run['loss']:.6f} (max rel err "
              f"{max(max(p['loss_rel']) for p in ranks):.2e} over {len(run['losses'])} steps), "
              f"clip {run['clip_scale']:.6f} (bits agree {run['ranks_agree']}); gradients max "
              f"abs err {max(h['grad_err'] for h in hold):.3e} "
              f"({max(h['grad_ratio'] for h in hold):.3e} of the bound, {hold[0]['grad_leaf']}), "
              f"parameters {new}{same}; K3/K7 {[p['kernel_launches'] for p in ranks]}")
        walls = [p["step_s"] for p in ranks]
        print(f"  [{card}] {label}: step walls a rank {[[round(t, 3) for t in w] for w in walls]} s "
              f"(first, then steady; unsharded {[round(t, 3) for t in ranks[0]['reference_step_s']]} "
              f"s); peak {[round(p['peak_gib'], 2) for p in ranks]} GiB a rank (unsharded "
              f"{ranks[0]['reference_peak_gib']:.2f}); built in "
              f"{[round(p['build_s'], 1) for p in ranks]} s (the unsharded record "
              f"{[round(p['reference_wall_s'] or 0.0, 1) for p in ranks]} s); parameters a rank "
              f"{ranks[0]['params_local']:,}; a step's collectives a rank: "
              f"{per_step_counts(ranks[0]['counts'])}")
        if not run["ok"]:
            fail(f"{label}: {[{k: p.get(k) for k in ('hold', 'loss_rel', 'first', 'same_bits')} for p in ranks]}")
        if run["mesh"] == [1, 2]:  # the head cut over "model": the vocab-parallel loss
            was = TRAIN_MESH_GATHER_PEAK_GIB.get((run["arch"], run["layers"], run["remat"]))
            print(f"  [{card}] {label}: the first step's books by op kind "
                  f"{[p['ops'] for p in ranks]}; peak {[p['peak_gib'] for p in ranks]} GiB "
                  f"({[int(p['peak_gib'] * 2**30) for p in ranks]} B) a rank with the "
                  f"vocab-parallel loss, "
                  + ("not measured at this depth" if was is None else f"{was} GiB")
                  + " when the logits were gathered")
            if any("all-gather" in p["ops"] for p in ranks):
                fail(f"{label}: the train step booked an all-gather (the logits' gather over "
                     f"\"model\" is gone with the vocab-parallel loss)")
    dp, fsdp, zero1 = runs[2], runs[3], runs[4]
    for name, z in (("fsdp", fsdp), ("zero1", zero1)):
        for a, b in zip(z["ranks"], dp["ranks"]):
            if not a["peak_gib"] < b["peak_gib"]:
                fail(f"{name}'s peak {a['peak_gib']:.2f} GiB a rank is not below data "
                     f"parallelism's {b['peak_gib']:.2f} GiB at 2x1")
    meta2 = meta_gate(runs, 2, "gloo", "training")
    if not two["ok"]:
        fail("the world-2 training selftest did not pass its own checks")
    out = {"world1": one, "world2": two, "phase_s": time.perf_counter() - t_phase,
           "meta_s": {"world2": meta2}}
    print(f"  [{card}] training mesh phase {out['phase_s']:.1f} s (selftests "
          f"{one['wall_s']:.1f} s, {two['wall_s']:.1f} s; the meta counts {meta2:.1f} s a rank "
          f"at world 2)")
    return out


def train_mesh_launches(rec: dict, kernel: str) -> dict:
    """A kernel's launches in phase 11 (0: training runs the plain paths)."""
    return {"launched_as": "none: LM training under a (data, model) mesh runs the plain "
                           "attention and SSD (no kernel has a backward; phase 11)",
            "launches_per_rank": [p["kernel_launches"][kernel] for r in rec["world2"]["train"]
                                  for p in r["ranks"]]}


def lm_mesh_launches(rec: dict, kernel: str) -> dict:
    """A kernel's per-rank launches in phase 10, by run."""
    out = {}
    for world, key in ((1, "world1"), (2, "world2")):
        for r in rec[key]["lm"]:
            n = [p["prefill_counts"][kernel] for p in r["ranks"]]
            if any(n):
                out[f"world{world} {r['arch']} mesh {r['mesh'][0]}x{r['mesh'][1]}"] = n
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device; chip_smoke.py runs on a machine with an NVIDIA card")
    from repro_torch.analysis import solver_select
    from repro_torch.configs.diffusion import HIGHRES_DIT, TRAJ_UNET
    from repro_torch.core import analytic
    from repro_torch.core.sampling import sample
    from repro_torch.benchmarks import kernel_times, table2_highdim
    from repro_torch.core.sde import VESDE, VPSDE
    from repro_torch.core.solvers import solver_nfe_per_iteration
    from repro_torch.core.solvers import adaptive as ad
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.groupnorm_silu import ops as gn_ops
    from repro_torch.kernels.groupnorm_silu import ref as gn_ref
    from repro_torch.kernels.philox import ops as ph_ops
    from repro_torch.kernels.solver_step import ops as step_ops
    from repro_torch.kernels.solver_step import ref as step_ref
    from repro_torch.launch import sample as launcher
    from repro_torch.models import temporal_unet as tu
    from repro_torch.planning import PlannerConfig, plan, plan_conditioner
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    only_lm_mesh = "--only-lm-mesh" in sys.argv[1:]
    only_train_mesh = "--only-train-mesh" in sys.argv[1:]
    only_guided = "--only-guided" in sys.argv[1:]

    # ------------------------------------------------------------ 1. build
    phase("build")
    path, seconds, log = _build.build()
    print(f"built {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
    for line in log.splitlines():
        if ("Compiling entry function" in line or "ptxas info    : Used" in line
                or "spill" in line or line.startswith("==")):
            print("  " + line.strip())
    if only_lm_mesh:  # a partial run for development: no result line
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        phase("the LMs served under a (data, model) mesh (only this phase)")
        print(json.dumps({"lm_mesh_partial": run_lm_mesh(dev, card)}, default=str)[:20000])
        return
    if only_train_mesh:  # the same for phase 11
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        phase("LM training under a (data, model) mesh (only this phase)")
        run_train_mesh(dev, card)
        return
    if only_guided:  # the same for phase 3b
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        phase("controlled generation from HIGHRES_DIT (only this phase)")
        run_guided(dev, card)
        phase(None)
        return

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]

    # ---------------------------------------------------------- 2. kernels
    phase("kernels vs plain versions")
    B, D = 8, HIGHRES_DIT.image_size ** 2 * HIGHRES_DIT.channels
    H, S, Dh = HIGHRES_DIT.num_heads, HIGHRES_DIT.tokens, HIGHRES_DIT.head_dim
    gen = torch.Generator(device=dev).manual_seed(0)
    step_err = {}
    for dtype, xtol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for d in (D, 4_999):
            states = [torch.randn(B, d, generator=gen, device=dev).to(dtype) for _ in range(5)]
            coeffs = [torch.rand(B, generator=gen, device=dev) for _ in range(3)]
            for vector in (False, True):
                if vector:
                    ea = torch.rand(B, generator=gen, device=dev) * 0.1 + 1e-3
                    er = torch.rand(B, generator=gen, device=dev) * 0.5 + 0.01
                else:
                    ea, er = 0.0078, 0.05
                xh, e2 = step_ops.error_step(*states, *coeffs, eps_abs=ea, eps_rel=er)
                xr, e2r = step_ref.error_step(
                    *states, *coeffs, step_ops.per_sample_tolerance(ea, B, dev),
                    step_ops.per_sample_tolerance(er, B, dev))
                torch.cuda.synchronize()
                x_err = (xh.float() - xr.float()).abs().max().item()
                x_bound = xtol * (1 + xr.float().abs().max().item())
                e_rel = ((e2 - e2r).abs() / e2r.abs()).max().item()
                ok = x_err <= x_bound and e_rel <= 1e-5
                print(f"  solver_step {str(dtype)[6:]:8s} D={d:7d} "
                      f"{'vector' if vector else 'scalar'}: max|x''-plain| {x_err:.3e} "
                      f"(bound {x_bound:.1e}), max rel e2 {e_rel:.3e} (bound 1e-5) "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail("solver_step kernel disagrees with its plain version")
                step_err[(dtype, d, vector)] = x_err
    if SERVED_STEP_SHAPES[0] != (solver_select.BATCH, solver_select.DIM):
        fail(f"the selection race's state is {(solver_select.BATCH, solver_select.DIM)}, "
             f"not {SERVED_STEP_SHAPES[0]}")
    k1_bf16_err = check_k1_bf16_state(dev, gen, B, D)
    step_per_call = check_solver_step_edges(dev, gen)
    k2_err = check_k2_tiers(dev, gen, D)
    streams = check_streams_and_grids(dev, gen)
    attn_err = {}
    plan_attn = (2 * PLAN_BATCH, TRAJ_UNET.attn_heads, TRAJ_UNET.attn_heads,
                 TRAJ_UNET.horizon // 2 ** (len(TRAJ_UNET.mults) - 1),
                 TRAJ_UNET.base * TRAJ_UNET.mults[-1] // TRAJ_UNET.attn_heads)
    served_attn = (2 * PLAN_SERVE_SLOTS, *plan_attn[1:])  # phase 6e's CFG-doubled slots
    for (b, hq, hkv, s, dh, causal, window, true_len, dtype) in (
            (B, H, H, S, Dh, False, None, None, torch.float32),
            (B, H, H, S, Dh, False, None, None, torch.bfloat16),
            (*plan_attn, False, None, None, torch.float32),
            (*plan_attn, False, None, None, torch.bfloat16),
            (*served_attn, False, None, None, torch.float32),
            (*CFG_ATTN, False, None, None, torch.float32),  # phase 3b's CFG forward
            (*PIPE_ATTN, False, None, None, torch.float32),  # phase 8's check 7
            (*TP_ATTN, False, None, None, torch.float32),  # phase 8's check 8
            (2, 4, 2, 200, 32, True, 64, None, torch.float32),
            (2, 4, 2, 200, 32, True, 64, None, torch.bfloat16),
            (1, 2, 2, 25, 64, False, None, None, torch.float32),
            (2, 4, 4, 75, 64, False, None, 50, torch.float32),
            (2, 4, 4, 75, 64, True, None, 50, torch.bfloat16),
            (1, 4, 4, 64, 256, True, None, None, torch.float32),
            (1, 4, 4, 64, 256, False, None, None, torch.bfloat16),
            (*GEMMA_ATTN, True, GEMMA_WINDOW, None, torch.float32),  # phase 7b's "L"
            (*GEMMA_ATTN, True, None, None, torch.float32),  # phase 7b's "A"
            (*GEMMA_ATTN, True, GEMMA_WINDOW, None, torch.bfloat16),  # phase 9d's "L"
            (*GEMMA_ATTN, True, None, None, torch.bfloat16),  # phase 9d's "A"
            *((*shape, True, None, None, torch.float32)  # phase 7d's prefills
              for shape in kernel_times.MOE_ATTN_SHAPES.values()),
            *((*shape, True, None, None, torch.float32)  # phase 7e's prefills
              for shape in kernel_times.VLM_AUDIO_ATTN_SHAPES.values())):
        q = torch.randn(b, hq, s, dh, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        kw = dict(causal=causal, window=window, true_len=true_len)
        out = flash_ops.attention(q, k, v, **kw)
        want = flash_ref.attention(q, k, v, **kw)
        again = flash_ops.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        share = attn_share(q, k, v, out, want, **kw)
        same = torch.equal(again, out)
        ok = share <= 1 and same
        print(f"  flash_attention {(b, hq, hkv, s, dh)} causal={causal} window={window} "
              f"true_len={true_len} {str(dtype)[6:]}: max abs err {err:.3e}, {share:.3f} of the "
              f"bound ({'3e-5·(1+max|plain|)' if dtype == torch.float32 else 'one bf16 ulp + (2^-8 + 3e-5)·Σp|v|/l, element by element'}), "
              f"same bits on a second call {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("flash attention kernel disagrees with its plain version or itself")
        key = (s, dtype, causal, window)
        attn_err[key] = max(attn_err.get(key, 0.0), err)
        attn_err[(b, hq, hkv, s, dh, dtype, causal, window)] = err
    # the bf16 bound sees a mask one key tile off at gemma3's shape: the
    # kernel run with the window a tile wider or narrower ("L"), or with the
    # oldest tile of the last rows dropped ("A", window S − tile), held
    # against the plain version of the true mask, must exceed it
    b, hq, hkv, s, dh = GEMMA_ATTN
    q = torch.randn(b, hq, s, dh, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, hkv, s, dh, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    tile = K3_BF16_TILE_256
    for true_w, fault_w in ((GEMMA_WINDOW, GEMMA_WINDOW + tile),
                            (GEMMA_WINDOW, GEMMA_WINDOW - tile), (None, s - tile)):
        want = flash_ref.attention(q, k, v, causal=True, window=true_w)
        bad = flash_ops.attention(q, k, v, causal=True, window=fault_w)
        share = attn_share(q, k, v, bad, want, causal=True, window=true_w)
        print(f"  flash_attention bf16 {GEMMA_ATTN} window {fault_w} held against the plain "
              f"version at window {true_w}: {share:.2f} of the bf16 bound (must exceed 1)")
        if share <= 1:
            fail(f"the bf16 attention bound misses a mask {tile} keys off")
    del q, k, v, want, bad
    # GroupNorm → SiLU at the 17 (H, C) of one TRAJ_UNET forward, 2·64 rows
    # (phase 4's plans) and 2·16 (phase 6e's served slots), on the path the
    # wrapper picks (the register kernel at every one of them) and on the
    # general kernel, forced
    gn_shapes = kernel_times.TRAJ_GN_SHAPES
    gn_rows = 2 * PLAN_BATCH
    gn_err = {}
    gn_paths, gn_paths_served = ({f"{h}x{c}": gn_ops.kernel_config(
        rows, h, c, TRAJ_UNET.groups, torch.float32, True)["path"] for h, c in gn_shapes}
        for rows in (gn_rows, 2 * PLAN_SERVE_SLOTS))
    for path, rows in ((None, gn_rows), ("general", gn_rows), (None, 2 * PLAN_SERVE_SLOTS),
                       ("general", 2 * PLAN_SERVE_SLOTS)):
        gn = lambda x, s, b: gn_ops._launch(x, s, b, groups=TRAJ_UNET.groups, eps=1e-6,
                                            path=path)
        name = "chosen path" if path is None else "general path"
        for dtype in (torch.float32, torch.bfloat16):
            worst = 0.0
            for i, (h, c) in enumerate(gn_shapes):
                x = torch.randn(rows, h, c, generator=gen, device=dev).to(dtype)
                sc = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
                bi = 0.1 * torch.randn(c, generator=gen, device=dev)
                out = gn(x, sc, bi)
                again = gn(x, sc, bi)
                want = gn_ref.groupnorm_silu(x, sc, bi, groups=TRAJ_UNET.groups)
                torch.cuda.synchronize()
                diff = (out.float() - want.float()).abs()
                if dtype == torch.float32:
                    bound = torch.full_like(diff, 1e-5)
                else:  # one bf16 ulp plus the fp32 bound: both round once
                    mag = torch.maximum(out.float().abs(), want.float().abs())
                    bound = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7) + 1e-5
                if not (diff <= bound).all() or not torch.equal(again, out):
                    fail(f"groupnorm_silu ({name}) {str(dtype)[6:]} at {(rows, h, c)}: "
                         f"max abs err {diff.max().item():.3e} over its bound, or other bits "
                         f"on a second call")
                worst = max(worst, diff.max().item())
                key = (path, dtype, h, c)
                gn_err[key] = max(gn_err.get(key, 0.0), diff.max().item())
            print(f"  groupnorm_silu ({name}) {str(dtype)[6:]:8s} 17 TRAJ_UNET shapes at "
                  f"{rows} rows: max abs err {worst:.3e} (bound "
                  f"{'1e-5' if dtype == torch.float32 else 'one bf16 ulp + 1e-5'}), the same "
                  f"bits on a second call ok")
        x = 1e3 + torch.randn(rows, 32, 64, generator=gen, device=dev)
        ones, zeros = torch.ones(64, device=dev), torch.zeros(64, device=dev)
        out = gn(x, ones, zeros)
        err = (out - gn_ref.groupnorm_silu(x, ones, zeros, groups=TRAJ_UNET.groups)).abs().max().item()
        spread = out.std().item()
        print(f"  groupnorm_silu ({name}) fp32 x = 1e3 + N(0,1) at {(rows, 32, 64)}: max "
              f"abs err {err:.3e} (bound 2e-3: sums near 1e3·n in another order), output std "
              f"{spread:.3f}")
        if not err <= 2e-3 or not 0.3 < spread < 1.2:
            fail("groupnorm_silu loses the variance at a large offset")
        if not torch.equal(gn(x, ones, zeros), out):
            fail("groupnorm_silu gives other bits on the same inputs")
    print(f"  groupnorm_silu paths the wrapper picks at the forward's shapes: {gn_paths}; "
          f"at {2 * PLAN_SERVE_SLOTS} rows: {gn_paths_served}")
    if set(gn_paths.values()) | set(gn_paths_served.values()) != {"register"}:
        fail("a TRAJ_UNET shape does not take the register kernel")

    # K5 em_step at the DiT state, the Table-2 state, a plan, ragged D, the
    # tables' 2-column states, rows narrower than a pack, B = 70,000
    # (above the former kernel's 65,535 rows) and the selection race's
    # state (phase 6d's EM, PC and PC-HMC rows); each shape also as operands
    # off 16 bytes (single-element loads), which must give the same bits
    em_err = {}
    em_shapes = [(B, D), (table2_highdim.N, table2_highdim.D),
                 (PLAN_BATCH, TRAJ_UNET.horizon * TRAJ_UNET.transition_dim), (B, 1000),
                 (3, 999), (4096, 2), (2048, 2), (5, 3), (70_000, 2),
                 (solver_select.BATCH, solver_select.DIM)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, d in em_shapes:
            ops_in = [torch.randn(b, d, generator=gen, device=dev).to(dtype) for _ in range(3)]
            cs = [torch.rand(b, generator=gen, device=dev) * 2 - 0.5 for _ in range(3)]
            views = []
            for t in ops_in:  # contiguous, one element off a 16-byte boundary
                views.append(torch.empty(b * d + 1, dtype=dtype, device=dev)[1:].view(b, d))
                views[-1].copy_(t)
            before = step_ops.em_launches
            out = step_ops.em_step(*ops_in, *cs)
            again = step_ops.em_step(*ops_in, *cs)
            off = step_ops.em_step(*views, *cs)
            want = step_ref.em_step(*ops_in, *cs)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            bound = 2 * ulp(dtype, want.float().abs().max().item())
            ok = (err <= bound and torch.equal(out, again) and torch.equal(off, out)
                  and out.dtype == dtype and step_ops.em_launches == before + 3)
            cfg = step_ops.em_kernel_config(b, d, dtype, True)
            print(f"  em_step {str(dtype)[6:]:8s} {(b, d)}: max|x'-plain| {err:.3e} "
                  f"(bound 2 ulp of max|x'|: {bound:.1e}), same bits twice "
                  f"{torch.equal(out, again)}, off 16 bytes bitwise {torch.equal(off, out)} "
                  f"{'ok' if ok else 'FAIL'}; launch grid {cfg['grid']} x {cfg['threads']} "
                  f"threads, {cfg['elems_per_thread']} elements a thread, {cfg['passes']} "
                  f"pass(es), {cfg['load_bytes']}-byte loads (aligned), evict-first "
                  f"{cfg['evict_first']}")
            if not ok:
                fail("em_step kernel disagrees with its plain version, itself or its "
                     "unaligned call")
            em_err[(dtype, b, d)] = err
    wide = torch.randn(B, 2000, generator=gen, device=dev)[:, :1000]
    cs = [torch.ones(B, device=dev)] * 3
    before = step_ops.em_launches
    try:
        step_ops.em_step(wide, wide, wide, *cs)
    except ValueError as e:
        print(f"  em_step on a non-contiguous view raises: {e}")
    else:
        fail("em_step accepted a non-contiguous view")
    if step_ops.em_launches != before:
        fail("a refused em_step call was counted as a launch")
    t1_state_err = check_tables_state_and_guard(dev, gen)

    # K7 ssd_scan at every SSD_SHAPES entry, with the range count the wrapper
    # picks. Bounds: each of kernel and plain version is within the
    # reference's 3e-4 of the sequential oracle, and they chunk differently
    # (64 and 128 rows), so against each other 6e-4·(1 + |y|); against the
    # oracle 3e-4, y and the final state.
    ssd_err = {}
    for shape in SSD_SHAPES:
        args = ssd_inputs(*shape, gen=gen)
        y, st = ssd_ops.ssd_scan(*args, return_state=True)
        y2, st2 = ssd_ops.ssd_scan(*args, return_state=True)
        want = ssd_ref.ssd_chunked(*args)
        ys, ss = ssd_ref.ssd_scan(*(a.transpose(1, 2) if a.ndim > 1 else a for a in args))
        torch.cuda.synchronize()
        err, worst = excess(y, want, SSD_TOL)
        _, wy = excess(y, ys.transpose(1, 2), 3e-4)
        _, ws = excess(st, ss, 3e-4)
        same = torch.equal(y, y2) and torch.equal(st, st2)
        ok = worst <= 1 and wy <= 1 and ws <= 1 and same
        print(f"  ssd_scan {shape} ({ssd_ops.ranges_for(args[0])} ranges a sequence): "
              f"max|y-plain| {err:.3e}, of the {SSD_TOL}·(1+|plain|) bound {worst:.3f}; against "
              f"the sequential oracle, of the 3e-4·(1+|.|) bound: y {wy:.3f}, final state "
              f"{ws:.3f}; same bits twice {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("ssd_scan kernel disagrees with its plain version or the sequential oracle")
        ssd_err[shape] = err
        del args, y, y2, st, st2, want, ys, ss
    x7, dt7, A7, B7, C7 = ssd_inputs(2, 150, 8, 32, 2, 32, gen=gen)
    y7, st7 = ssd_ops.ssd_scan(x7, dt7, A7, B7, C7, return_state=True)
    ys7, ss7 = ssd_ref.ssd_scan(x7.transpose(1, 2), dt7.transpose(1, 2), A7,
                                B7.transpose(1, 2), C7.transpose(1, 2))
    _, wy = excess(y7, ys7.transpose(1, 2), 3e-4)
    _, ws = excess(st7, ss7, 3e-4)
    print(f"  ssd_scan (2, 150, 8, 32, 2, 32) against the sequential oracle: y {wy:.3f}, "
          f"final state {ws:.3f} of the 3e-4·(1+|.|) bound")
    if not (wy <= 1 and ws <= 1):
        fail("ssd_scan kernel disagrees with the sequential oracle")
    buf = torch.empty(x7.numel() + 4, device=dev)
    view = buf[1:1 + x7.numel()].view(x7.shape)  # contiguous, 4 bytes off a 16-byte boundary
    view.copy_(x7)
    try:
        ssd_ops.ssd_scan(view, dt7, A7, B7, C7)
    except ValueError as e:
        print(f"  ssd_scan on a misaligned view raises: {e}")
    else:
        fail("ssd_scan accepted a misaligned view")
    # bf16, mamba2-2.7b's (4, 2048) prefill shape among them (phase 9e)
    for shape in ((2, 300, 8, 64, 1, 128), SSD_SHAPES[4], SSD_SHAPES[0]):
        args = ssd_inputs(*shape, gen=gen, dtype=torch.bfloat16)
        y, want = ssd_ops.ssd_scan(*args), ssd_ref.ssd_chunked(*args)
        same = torch.equal(ssd_ops.ssd_scan(*args), y)
        ok = ssd_share(y, want) <= 1 and y.dtype == torch.bfloat16 and same
        err = (y.float() - want.float()).abs().max().item()
        print(f"  ssd_scan bf16 {shape} ({ssd_ops.ranges_for(args[0])} ranges): max abs err "
              f"{err:.3e} (bound one bf16 ulp + {SSD_TOL}·(1+|y|)), same bits twice {same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("ssd_scan kernel in bf16 disagrees with its plain version or itself")
        ssd_err[(shape, torch.bfloat16)] = err
        del args, y, want

    # ------------------------------------------------------------- 3. main
    phase("main path: adaptive sampling from HIGHRES_DIT with both kernels")
    step_ops.launches = 0
    flash_ops.launches = 0
    rec = launcher.run("highres_dit", batch=B, precision="fp32", eps_rel=0.05,
                       max_iters=MAIN_MAX_ITERS, flash=True, fused=True, seed=0,
                       liven_seed=0, device=dev)
    launches = {"solver_step": step_ops.launches, "flash_attention": flash_ops.launches}
    print(json.dumps({k: v for k, v in rec.items() if k != "result"}))
    print(f"  launches in the main path: {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the main path was never launched: {launches}")
    iters = rec["iterations"]
    want_flash = 2 * HIGHRES_DIT.num_layers * iters + HIGHRES_DIT.num_layers
    print(f"  expected per run: solver_step ≥ {iters} (one per iteration), "
          f"flash_attention ≥ {want_flash} (24 per iteration + 12 for the denoise; "
          f"iterations after convergence in the last sync group add more)")
    if launches["solver_step"] < iters or launches["flash_attention"] < want_flash:
        fail("fewer launches than the iterations need")

    # the same weights on the plain paths: one forward, one iteration
    cfg, model, score_fast = launcher.build_score(
        "highres_dit", flash=True, precision="fp32", seed=0, liven_seed=0, device=dev)
    sde = VPSDE()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(B, cfg.image_size, cfg.image_size, cfg.channels, generator=g, device=dev)
    t = torch.linspace(0.05, 1.0, B, device=dev)
    with torch.no_grad():
        fast = model(x, t)
        model.cfg = dataclasses.replace(cfg, use_flash=False)
        plain = model(x, t)
    err = (fast - plain).abs().max().item()
    bound = 1e-4 * (1 + plain.abs().max().item())
    print(f"  DiT forward, flash kernel vs plain attention: max abs err {err:.3e} "
          f"(bound {bound:.1e}), mean |out| {plain.abs().mean().item():.3e}")
    if not err <= bound or plain.abs().mean().item() < 1e-3:
        fail("DiT forward through the kernel disagrees with the plain path")
    z = torch.randn(x.shape, generator=g, device=dev)
    carry = ad.init_carry(sde, x, None, eps_rel=0.05)
    steps = {}
    for fused, use_flash in ((True, True), (False, False)):
        model.cfg = dataclasses.replace(cfg, use_flash=use_flash)
        acfg = ad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=fused)
        body = ad._make_body(sde, score_fast, acfg, sde.abs_tolerance,
                             ad._step_math_fused if fused else ad._step_math_jnp,
                             noise_fn=lambda _x: z)
        with torch.no_grad():
            steps[fused] = body(carry)
    a, p = steps[True], steps[False]
    x_err = (a.x - p.x).abs().max().item()
    same = torch.equal(a.accepted, p.accepted) and torch.equal(a.rejected, p.rejected)
    print(f"  one Algorithm-1 iteration, kernels vs plain: accept bits equal {same}, "
          f"max|x diff| {x_err:.3e}, max|h diff| {(a.h - p.h).abs().max().item():.3e}")
    if not same or not x_err <= 1e-4 * (1 + p.x.abs().max().item()):
        fail("one iteration through the kernels disagrees with the plain path")
    model.cfg = dataclasses.replace(cfg, use_flash=True)
    with torch.no_grad():
        fwd_ms = timed_ms(model, [(x, t)], 10)
    print(f"  where the time goes: one DiT forward (batch {B}, flash) {fwd_ms:.2f} ms; "
          f"main path {rec['wall_s'] / max(iters, 1) * 1e3:.2f} ms per iteration "
          f"(two forwards + one solver step + the host sync share)")
    # the graphed solve (one WHILE-node launch, one host read) against the
    # host-driven chain on the same streams
    gcfg = ad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True, max_iters=MAIN_MAX_ITERS,
                             telemetry_capacity=GRAPH_RING)
    dshape = (B, cfg.image_size, cfg.image_size, cfg.channels)
    graphed = {"adaptive": graphed_vs_host(
        "HIGHRES_DIT adaptive", "phase 3",
        lambda: sample(sde, score_fast, dshape, seed=0, config=gcfg, device=dev),
        lambda: host_chain(sde, score_fast, dshape, 0, gcfg, dev))}
    # the graph cache holds score functions weakly: dropping the net drops
    # its driver (graph, pool and carry) with it
    cached = len(ad._drivers)
    del model, score_fast, body
    gc.collect()
    print(f"  graph drivers cached: {cached} with the net, {len(ad._drivers)} after dropping it")
    if len(ad._drivers) != cached - 1:
        fail("dropping the score net did not drop its cached graph driver")

    # ------------------------------------------------------------ 3b. guided
    phase("controlled generation from HIGHRES_DIT: classifier-free guidance and inpainting, "
          "graphed and served (K1, K3, P1, P2)")
    guided = run_guided(dev, card)

    # ------------------------------------------------------------- 4. plan
    phase("main path: guided planning through TRAJ_UNET with all three kernels")
    ucfg = dataclasses.replace(TRAJ_UNET, attention=True, use_flash=True,
                               use_fused_norm=True)
    unet = tu.init_temporal_unet(ucfg, torch.Generator(device=dev).manual_seed(0))
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the fp32 convolutions would not be fp32")
    tu.liven_zero_init(unet, torch.Generator(device=dev).manual_seed(0))
    plan_score = tu.make_score_fn(unet, sde)
    pcfg = PlannerConfig(horizon=ucfg.horizon, obs_dim=PLAN_OBS,
                         act_dim=ucfg.transition_dim - PLAN_OBS, guidance_scale=PLAN_CFG)
    g = torch.Generator(device=dev).manual_seed(0)
    obs = 0.5 * torch.randn(PLAN_BATCH, PLAN_OBS, generator=g, device=dev)
    bins = torch.randint(0, ucfg.returns_bins, (PLAN_BATCH,), generator=g, device=dev)
    plan_cfg = ad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=True,
                                 max_iters=MAIN_MAX_ITERS)
    print(f"  TRAJ_UNET {tu.param_count(unet):,} parameters; plans {PLAN_BATCH} x "
          f"{pcfg.sample_shape}, CFG {PLAN_CFG} over {2 * PLAN_BATCH} rows")
    # a first, cold call (allocator, cuDNN's first use of each conv shape;
    # the key's first solve, so host-driven: the one-shot wall a planning
    # process pays), then the measured call (the key's second: it captures)
    # with the counts at 0
    t0 = time.perf_counter()
    cold = plan(sde, plan_score, obs, pcfg=pcfg, returns=bins, config=plan_cfg, device=dev)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    step_ops.launches = flash_ops.launches = gn_ops.launches = ph_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = plan(sde, plan_score, obs, pcfg=pcfg, returns=bins, config=plan_cfg, device=dev)
    torch.cuda.synchronize()
    plan_wall = time.perf_counter() - t0
    plan_launches = {"solver_step": step_ops.launches,
                     "flash_attention": flash_ops.launches,
                     "groupnorm_silu": gn_ops.launches, "philox_normal": ph_ops.launches}
    p_iters = int(pres.iterations)
    print(f"  iterations {p_iters}, mean NFE {float(pres.mean_nfe):.2f}, "
          f"accepted {int(pres.accepted.sum())}, rejected {int(pres.rejected.sum())}, "
          f"wall {plan_wall:.3f} s ({plan_wall / max(p_iters, 1) * 1e3:.2f} ms per iteration); "
          f"the cold first call {cold_wall:.3f} s (host-driven: the one-shot rule); the "
          f"measured call captured the graph; the two calls bitwise equal: "
          f"{torch.equal(cold.x, pres.x) and torch.equal(cold.nfe, pres.nfe)}")
    print(f"  launches in the planning path: {plan_launches}")
    if min(plan_launches.values()) <= 0:
        fail(f"a kernel of the planning path was never launched: {plan_launches}")
    n_blocks = 2 * len(ucfg.mults) + 2  # down path, two mid blocks, up path
    per_forward = 2 * n_blocks + 1
    if (plan_launches["solver_step"] < p_iters
            or plan_launches["flash_attention"] < 2 * p_iters + 1
            or plan_launches["groupnorm_silu"] != per_forward * plan_launches["flash_attention"]):
        fail(f"launch counts do not fit {p_iters} iterations of two forwards "
             f"({per_forward} GroupNorm → SiLU and 1 attention each) plus the denoise")
    px = pres.x
    if px.shape != (PLAN_BATCH,) + pcfg.sample_shape or not torch.isfinite(px).all():
        fail(f"planning output: shape {tuple(px.shape)}, finite {bool(torch.isfinite(px).all())}")
    if not torch.equal(px[:, 0, :PLAN_OBS], obs):
        fail("the pinned observation coordinates differ from obs")
    print(f"  plans finite, shape {tuple(px.shape)}, x[:, 0, :{PLAN_OBS}] == obs exactly, "
          f"all converged before the cap: {p_iters < MAIN_MAX_ITERS}")
    # the graphed planning solve against the host-driven chain on its streams
    plan_gcfg = dataclasses.replace(plan_cfg, telemetry_capacity=GRAPH_RING)
    pcond_c, pcond = plan_conditioner(pcfg, state=obs, returns=bins)
    graphed["planning"] = graphed_vs_host(
        "TRAJ_UNET planning", "phase 4",
        lambda: plan(sde, plan_score, obs, pcfg=pcfg, returns=bins, config=plan_gcfg,
                     device=dev),
        lambda: host_chain(sde, plan_score, (PLAN_BATCH,) + pcfg.sample_shape, 0,
                           dataclasses.replace(plan_gcfg, conditioner=pcond_c), dev,
                           cond=pcond))

    # the same weights on the plain paths: one forward, one iteration
    xu = torch.randn(2 * PLAN_BATCH, *pcfg.sample_shape, generator=g, device=dev)
    tt = torch.rand(2 * PLAN_BATCH, generator=g, device=dev) * 0.99 + 0.01
    yy = torch.cat([bins, torch.full_like(bins, -1)])
    with torch.no_grad():
        unet.cfg = ucfg
        fast = unet(xu, tt, y=yy)
        unet.cfg = dataclasses.replace(ucfg, use_flash=False, use_fused_norm=False)
        plain = unet(xu, tt, y=yy)
    err = (fast - plain).abs().max().item()
    bound = 1e-4 * (1 + plain.abs().max().item())
    print(f"  TRAJ_UNET forward at {2 * PLAN_BATCH} rows, K6 + K3 vs plain: max abs err "
          f"{err:.3e} (bound {bound:.1e}), mean |out| {plain.abs().mean().item():.3e}")
    if not err <= bound or plain.abs().mean().item() < 1e-3:
        fail("the TRAJ_UNET forward through the kernels disagrees with the plain path")
    conditioner, cond = plan_conditioner(pcfg, state=obs, returns=bins)
    xs = sde.prior_sample((PLAN_BATCH,) + pcfg.sample_shape, g)
    zs = [torch.randn(xs.shape, generator=g, device=dev) for _ in range(2)]
    steps = {}
    for fused in (True, False):
        unet.cfg = dataclasses.replace(ucfg, use_flash=fused, use_fused_norm=fused)
        acfg = ad.AdaptiveConfig(eps_rel=0.05, use_fused_kernel=fused,
                                 conditioner=conditioner)
        carry = ad.init_carry(sde, xs, None, config=acfg, cond=cond)
        draws = iter(zs)  # z, then the projection's draw
        body = ad._make_body(sde, plan_score, acfg, sde.abs_tolerance,
                             ad._step_math_fused if fused else ad._step_math_jnp,
                             noise_fn=lambda _x: next(draws))
        with torch.no_grad():
            steps[fused] = body(carry)
    a, p = steps[True], steps[False]
    x_err = (a.x - p.x).abs().max().item()
    same = torch.equal(a.accepted, p.accepted) and torch.equal(a.rejected, p.rejected)
    print(f"  one guided, projected Algorithm-1 iteration, kernels vs plain: accept bits "
          f"equal {same} ({int(a.accepted.sum())}/{PLAN_BATCH} accepted), "
          f"max|x diff| {x_err:.3e}, max|h diff| {(a.h - p.h).abs().max().item():.3e}")
    if not same or not x_err <= 1e-4 * (1 + p.x.abs().max().item()):
        fail("one planning iteration through the kernels disagrees with the plain path")
    unet.cfg = ucfg

    # -------------------------------------------------------- 4b. baselines
    phase("baselines: EM, DDIM and PC from HIGHRES_DIT, Table 2, conformance (K5)")
    n_em = round(rec["mean_nfe"])  # the paper's "EM at matched NFE"
    adaptive_s_per_nfe = rec["wall_s"] / rec["mean_nfe"]
    print(f"  adaptive (phase 3): {rec['iterations']} iterations, mean NFE {rec['mean_nfe']:.2f}, "
          f"{rec['wall_s']:.3f} s, {adaptive_s_per_nfe * 1e3:.2f} ms per NFE")
    k5_launches = {}
    for method, kw, k5_want in (("em", dict(n_steps=n_em), n_em),
                                ("ddim", dict(n_steps=n_em), 0),
                                ("pc", dict(n_steps=n_em // 2), 2 * (n_em // 2))):
        step_ops.launches = step_ops.em_launches = flash_ops.launches = 0
        brec = launcher.run("highres_dit", batch=B, precision="fp32", flash=True, seed=0,
                            liven_seed=0, device=dev, method=method, **kw)
        counts = {"em_step": step_ops.em_launches, "solver_step": step_ops.launches,
                  "flash_attention": flash_ops.launches}
        if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
            fail("TF32 is on: the DiT's fp32 products would not be fp32")
        res = brec["result"]
        nfe_want = solver_nfe_per_iteration(method) * kw["n_steps"] + 1  # + the denoise
        per_nfe = brec["wall_s"] / brec["mean_nfe"]
        print(f"  {method:4s} n_steps {kw['n_steps']}: NFE {brec['mean_nfe']:.0f} (rule {nfe_want}), "
              f"{brec['wall_s']:.3f} s, {per_nfe * 1e3:.2f} ms per NFE (adaptive "
              f"{adaptive_s_per_nfe * 1e3:.2f}); launches {counts}; finite {brec['finite']}")
        if (counts["em_step"] != k5_want or brec["launches"]["em_step"] != k5_want
                or counts["solver_step"] != 0):
            fail(f"{method}: {counts['em_step']} K5 launches, want exactly {k5_want}")
        if not (res.nfe == nfe_want).all() or not brec["finite"] or brec["shape"] != rec["shape"]:
            fail(f"{method} from HIGHRES_DIT: nfe {res.nfe.tolist()} (want {nfe_want}), "
                 f"finite {brec['finite']}, shape {brec['shape']}")
        k5_launches[method] = counts["em_step"]
        del brec, res

    # each baseline graphed against its host-driven loop on the same streams
    # (the one-shot rule: the first solve at a key host-driven, the second
    # captures, the third replays), then Algorithm 2
    cfg_b, model_b, score_b = launcher.build_score(
        "highres_dit", flash=True, precision="fp32", seed=0, liven_seed=0, device=dev)
    bshape = (B, cfg_b.image_size, cfg_b.image_size, cfg_b.channels)
    graphed_baselines = {}
    for name, method, kw in GRAPHED_BASELINES:
        graphed_baselines[name] = graphed_baseline(
            f"HIGHRES_DIT {name}", card,
            lambda: sample(VPSDE(), score_b, bshape, seed=0, method=method, device=dev, **kw))
    del model_b, score_b
    gc.collect()
    torch.cuda.empty_cache()
    graphed_baselines["algorithm2"] = forward_graphed(dev, card)

    # the Table-2 analog at its full size, every row on the card, each row's
    # key warmed up first (two cheap solves: host-driven, then the capture)
    t0 = time.perf_counter()
    t2_rows = table2_highdim.run(dev)
    t2_wall = time.perf_counter() - t0
    for r in t2_rows:
        print("  " + table2_highdim.format_row(r) + f";iterations={r['iterations']};"
              f"captures={r['captures']};host_reads={r['host_reads']};K5={r['em_step']}")
    want_k5 = lambda r: {"pc": 2 * 1000, "em": int(r["nfe"]) - 1}.get(r["method"], 0)
    k5_t2 = sum(r["em_step"] for r in t2_rows)
    print(f"  Table 2 on the card: {len(t2_rows)} rows in {t2_wall:.1f} s, K5 launches over "
          f"its timed rows {k5_t2} (want {sum(want_k5(r) for r in t2_rows)}), captures "
          f"{[r['captures'] for r in t2_rows]}, host reads {[r['host_reads'] for r in t2_rows]}")
    if (not all(r["finite"] for r in t2_rows) or any(r["em_step"] != want_k5(r) for r in t2_rows)
            or t2_rows[0]["nfe"] != 2001 or t2_rows[1]["nfe"] != 2001):
        fail("the Table-2 analog on the card")
    if any(r["captures"] or r["host_reads"] != 1 for r in t2_rows):
        fail("a timed Table-2 row captured a graph or read the host more than once")

    # conformance through K5 on the closed-form Gaussian score, each solver
    # against its gate in the conformance table (analysis.solver_select.ZOO):
    # EM 0.08; the PC family 0.25, since its Langevin corrector inflates the
    # variance on VE at any grid (the reference's own conformance suite
    # gives W2 0.13 there)
    w2s = {}
    gates = {m: solver_select.ZOO[m]["tol"] for m in ("em", "pc")}
    for sde_c in (VPSDE(), VESDE(sigma_max=10.0)):
        mu_a, s_a = analytic.gaussian_marginal_moments(sde_c, MU0, S00)
        for method, n_steps in (("em", 1000), ("pc", 500)):
            step_ops.em_launches = 0
            r = sample(sde_c, analytic.gaussian_score(sde_c, MU0, S00), (512, 8), seed=0,
                       method=method, n_steps=n_steps, denoise=False, device=dev)
            xs = r.x.double()
            w2 = analytic.gaussian_w2(xs.mean().item(), xs.std(unbiased=False).item(),
                                      mu_a, s_a)
            name = f"{type(sde_c).__name__[:2].lower()}-{method}"
            w2s[name] = w2
            print(f"  {name}-{n_steps}: W2 {w2:.4f} (gate {gates[method]}), K5 launches "
                  f"{step_ops.em_launches}")
            if not w2 < gates[method] or step_ops.em_launches != 1000:
                fail(f"{name} through K5 misses the conformance gate")

    # ------------------------------------------------------------ 5. check
    phase("checks of the output")
    res = rec["result"]
    want_shape = [B, HIGHRES_DIT.image_size, HIGHRES_DIT.image_size, HIGHRES_DIT.channels]
    if not rec["finite"] or rec["shape"] != want_shape:
        fail(f"main path output: finite={rec['finite']} shape={rec['shape']}")
    print(f"  main path samples finite, shape {rec['shape']}, "
          f"mean NFE {float(res.mean_nfe):.1f}, converged {rec['converged']}/{B}")
    mu0, s0 = 0.3, 0.5
    before = step_ops.launches
    r = sample(sde, analytic.gaussian_score(sde, mu0, s0), (512, 8), seed=0,
               device=dev, denoise=False, eps_rel=0.05, use_fused_kernel=True)
    mu_a, s_a = analytic.gaussian_marginal_moments(sde, mu0, s0)
    xs = r.x.double()
    w2 = analytic.gaussian_w2(xs.mean().item(), xs.std(unbiased=False).item(), mu_a, s_a)
    gate = solver_select.ZOO["adaptive"]["tol"]
    print(f"  analytic Gaussian, fused kernel on the card: W2 {w2:.4f} (gate {gate}), "
          f"mean NFE {float(r.mean_nfe):.1f}, kernel launches {step_ops.launches - before}")
    if not w2 < gate or step_ops.launches == before:
        fail("the adaptive solve on the card misses the conformance gate")

    # ----------------------------------------------------------- 6. timing
    phase("timing at the main path's shape (CUDA graphs and events)")

    sets = []
    for _ in range(4):
        states = [torch.randn(B, D, generator=gen, device=dev) for _ in range(5)]
        coeffs = [torch.rand(B, generator=gen, device=dev) for _ in range(3)]
        eps = [step_ops.per_sample_tolerance(e, B, dev) for e in (0.0078, 0.05)]
        sets.append((*states, *coeffs, *eps))
    k1 = lambda *a: step_ops.error_step(*a[:8], eps_abs=a[8], eps_rel=a[9])
    k1_plain_fn = lambda *a: step_ref.error_step(*a)
    k1_ms, k1_plain = device_ms(k1, sets), device_ms(k1_plain_fn, sets)
    k1_host, k1_plain_host = timed_ms(k1, sets, 200), timed_ms(k1_plain_fn, sets, 50)
    k1_bytes = 6 * B * D * 4 + 5 * B * 4 + B * 4
    k1_ops = STEP_FLOPS_PER_ELEMENT * B * D
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / FP32_FLOPS) * 1e3

    sets = []
    for _ in range(4):
        sets.append(tuple(torch.randn(B, H, S, Dh, generator=gen, device=dev)
                          for _ in range(3)))
    k3 = lambda q, k, v: flash_ops.attention(q, k, v, causal=False)
    k3_plain_fn = lambda q, k, v: flash_ref.attention(q, k, v, causal=False)
    k3_lib_fn = torch.nn.functional.scaled_dot_product_attention
    k3_ms, k3_plain, k3_lib = (device_ms(f, sets) for f in (k3, k3_plain_fn, k3_lib_fn))
    k3_host = timed_ms(k3, sets, 200)
    k3_bytes = 4 * B * H * S * Dh * 4
    k3_ops = 4 * B * H * S * S * Dh
    # fp32 as 3xTF32: three tensor-core products for each of the two
    k3_bound = max(k3_bytes / HBM_BYTES_PER_S, 3 * k3_ops / TF32_FLOPS) * 1e3
    k3_bound_cuda_cores = max(k3_bytes / HBM_BYTES_PER_S, k3_ops / FP32_FLOPS) * 1e3
    sets = [tuple(a.to(torch.bfloat16) for a in st) for st in sets for _ in range(2)]
    k3b_ms, k3b_plain, k3b_lib = (device_ms(f, sets) for f in (k3, k3_plain_fn, k3_lib_fn))
    k3b_bound = max(k3_bytes / 2 / HBM_BYTES_PER_S, k3_ops / BF16_FLOPS) * 1e3
    del sets
    print(f"  solver_step (8, {D}) fp32, per-sample eps: {k1_ms * 1e3:.1f} us on the device, "
          f"bound {k1_bound * 1e3:.1f} us ({k1_bytes / 1e6:.1f} MB at 3.35 TB/s), "
          f"{k1_bytes / (k1_ms * 1e-3) / 1e12:.2f} TB/s achieved; plain {k1_plain * 1e3:.1f} us; "
          f"eager loop with host gaps: kernel {k1_host * 1e3:.1f} us, plain {k1_plain_host * 1e3:.1f} us")
    print(f"  flash_attention {(B, H, S, Dh)} fp32 (mma.sync 3xTF32): {k3_ms * 1e3:.2f} us on "
          f"the device; bounds: 3xTF32 on the tensor cores {k3_bound * 1e3:.2f} us (3 x "
          f"{k3_ops / 1e9:.2f} GFLOP at 495 TFLOP/s; {k3_bound / k3_ms:.0%} of it reached), fp32 "
          f"on the CUDA cores {k3_bound_cuda_cores * 1e3:.2f} us (67 TFLOP/s); "
          f"{k3_ops / (k3_ms * 1e-3) / 1e12:.1f} TFLOP/s achieved; plain {k3_plain * 1e3:.1f} us; "
          f"SDPA {k3_lib * 1e3:.2f} us; eager loop with host gaps: kernel {k3_host * 1e3:.1f} us")
    print(f"  flash_attention {(B, H, S, Dh)} bf16 (mma.sync bf16): {k3b_ms * 1e3:.2f} us on the "
          f"device; bound {k3b_bound * 1e3:.2f} us ({k3_bytes / 2e6:.1f} MB at 3.35 TB/s; "
          f"{k3_ops / BF16_FLOPS * 1e6:.2f} us by operations at 989 TFLOP/s; "
          f"{k3b_bound / k3b_ms:.0%} of it reached); plain {k3b_plain * 1e3:.1f} us; SDPA bf16 "
          f"{k3b_lib * 1e3:.2f} us")
    flash_build_summary(log)

    # K5 at the DiT state, the Table-2 state and the tables' states, fp32
    # and bf16 (kernel_times.EM_SHAPES), on the launch the wrapper picks
    k5 = lambda *a: step_ops.em_step(*a)
    k5_plain_fn = lambda *a: step_ref.em_step(*a)
    k5_t = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, d in kernel_times.EM_SHAPES:
            sets = kernel_times.em_sets(dev, gen, b, d, dtype)
            ms, plain = device_ms(k5, sets), device_ms(k5_plain_fn, sets)
            host = timed_ms(k5, sets, 200)
            nbytes = 4 * b * d * dtype.itemsize + 3 * b * 4
            nops = EM_FLOPS_PER_ELEMENT * b * d
            bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOPS) * 1e3
            cfg = step_ops.em_kernel_config(b, d, dtype, True)
            k5_t[(dtype, b, d)] = dict(
                ms=ms, plain_ms=plain, host_ms=host, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= nops / FP32_FLOPS
                else "operations", grid=cfg["grid"], evict_first=cfg["evict_first"])
            print(f"  em_step ({b}, {d}) {str(dtype)[6:]}: {ms * 1e3:.2f} us on the device, "
                  f"bound {bound * 1e3:.3f} us ({nbytes / 1e6:.3f} MB at 3.35 TB/s; "
                  f"{bound / ms:.0%} of it reached), {nbytes / (ms * 1e-3) / 1e12:.2f} TB/s "
                  f"achieved; plain {plain * 1e3:.1f} us; eager loop with host gaps "
                  f"{host * 1e3:.1f} us; grid {cfg['grid']} x {cfg['threads']}, evict-first "
                  f"{cfg['evict_first']}")

    # the launch floor: the device time of the smallest kernel (a one-
    # element zero_()) in the same graph harness, beside the sub-µs bounds
    floor_ms = kernel_times.launch_floor_ms(dev)
    print(f"  [{card}] launch floor: a one-element zero_() {floor_ms * 1e3:.2f} us on the "
          f"device (replayed CUDA graph of 40)")

    # the planning path's shapes: K6 at every distinct (H, C) of a forward,
    # on the register kernel the wrapper picks and on the general kernel
    gn_b, gn_h, gn_c = 2 * PLAN_BATCH, 32, 64
    k6_shapes = kernel_times.groupnorm_times(dev, gen)
    k6_general = kernel_times.groupnorm_times(
        dev, gen, fn=lambda x, s, b: gn_ops._launch(x, s, b, groups=TRAJ_UNET.groups,
                                                    eps=1e-6, path="general"))
    moved = lambda h, c: 2 * gn_b * h * c * 4 + 2 * c * 4  # x in, out, scale, bias
    for h, c in dict.fromkeys(gn_shapes):
        key = f"{h}x{c}"
        print(f"  [{card}] groupnorm_silu ({gn_b}, {h}, {c}) fp32 ({gn_paths[key]} path): "
              f"{k6_shapes[key] * 1e3:.2f} us on the device; general path "
              f"{k6_general[key] * 1e3:.2f} us; bound {moved(h, c) / HBM_BYTES_PER_S * 1e6:.2f} "
              f"us (bytes)")
    fwd_bytes = sum(moved(h, c) for h, c in gn_shapes)
    print(f"  [{card}] groupnorm_silu, one forward's 17 launches: {k6_shapes['forward'] * 1e3:.2f} "
          f"us on the device (general path {k6_general['forward'] * 1e3:.2f} us); bound "
          f"{fwd_bytes / HBM_BYTES_PER_S * 1e6:.2f} us ({fwd_bytes / 1e6:.2f} MB at 3.35 TB/s); "
          f"17 launch floors {17 * floor_ms * 1e3:.2f} us")
    sets = [(torch.randn(gn_b, gn_h, gn_c, generator=gen, device=dev),
             1 + 0.1 * torch.randn(gn_c, generator=gen, device=dev),
             0.1 * torch.randn(gn_c, generator=gen, device=dev)) for _ in range(4)]
    k6 = lambda x, s, b: gn_ops.groupnorm_silu(x, s, b, groups=TRAJ_UNET.groups)
    k6_plain_fn = lambda x, s, b: gn_ref.groupnorm_silu(x, s, b, groups=TRAJ_UNET.groups)
    k6_ms, k6_plain = device_ms(k6, sets), device_ms(k6_plain_fn, sets)
    k6_host = timed_ms(k6, sets, 200)
    # the yardstick: torch's group_norm then silu, two calls, on the same
    # values laid out (B, C, H) as group_norm wants them (never used by the port)
    tsets = [(x.transpose(1, 2).contiguous(), s, b) for x, s, b in sets]
    two_calls = lambda x, s, b: torch.nn.functional.silu(
        torch.nn.functional.group_norm(x, TRAJ_UNET.groups, s, b, eps=1e-6))
    k6_two_calls = device_ms(two_calls, tsets)
    two_err = (two_calls(*tsets[0]).transpose(1, 2) - k6(*sets[0])).abs().max().item()
    k6_bytes = 2 * gn_b * gn_h * gn_c * 4 + 2 * gn_c * 4
    k6_ops = GN_FLOPS_PER_ELEMENT * gn_b * gn_h * gn_c
    k6_bound = max(k6_bytes / HBM_BYTES_PER_S, k6_ops / FP32_FLOPS) * 1e3
    print(f"  [{card}] groupnorm_silu ({gn_b}, {gn_h}, {gn_c}) fp32: {k6_ms * 1e3:.2f} us on "
          f"the device, bound {k6_bound * 1e3:.2f} us ({k6_bytes / 1e6:.2f} MB at 3.35 TB/s; "
          f"inputs L2-resident, as after the conv that makes them); plain {k6_plain * 1e3:.1f} "
          f"us; F.group_norm + F.silu, two calls on x laid out (B, C, H): "
          f"{k6_two_calls * 1e3:.2f} us (max abs diff from the kernel {two_err:.1e}); eager "
          f"loop with host gaps {k6_host * 1e3:.1f} us")

    D_plan = ucfg.horizon * ucfg.transition_dim
    sets = []
    for _ in range(4):
        states = [torch.randn(PLAN_BATCH, D_plan, generator=gen, device=dev) for _ in range(5)]
        coeffs = [torch.rand(PLAN_BATCH, generator=gen, device=dev) for _ in range(3)]
        eps = [step_ops.per_sample_tolerance(e, PLAN_BATCH, dev) for e in (0.0078, 0.05)]
        sets.append((*states, *coeffs, *eps))
    k1p_ms, k1p_plain = device_ms(k1, sets), device_ms(k1_plain_fn, sets)
    k1p_bytes = 6 * PLAN_BATCH * D_plan * 4 + 6 * PLAN_BATCH * 4
    k1p_bound = max(k1p_bytes / HBM_BYTES_PER_S,
                    STEP_FLOPS_PER_ELEMENT * PLAN_BATCH * D_plan / FP32_FLOPS) * 1e3
    ah, ahd = ucfg.attn_heads, ucfg.base * ucfg.mults[-1] // ucfg.attn_heads
    a_s = ucfg.horizon // 2 ** (len(ucfg.mults) - 1)
    sets = [tuple(torch.randn(2 * PLAN_BATCH, ah, a_s, ahd, generator=gen, device=dev)
                  for _ in range(3)) for _ in range(4)]
    k3p_ms, k3p_plain, k3p_lib = (device_ms(f, sets) for f in (k3, k3_plain_fn, k3_lib_fn))
    k3p_bytes = 4 * 2 * PLAN_BATCH * ah * a_s * ahd * 4
    k3p_bound = max(k3p_bytes / HBM_BYTES_PER_S,
                    3 * 4 * 2 * PLAN_BATCH * ah * a_s * a_s * ahd / TF32_FLOPS) * 1e3
    k1_design = {f"{b}x{d}": step_ops.kernel_config(b, d, d, torch.float32, True)["design"]
                 for b, d in ((B, D), (PLAN_BATCH, D_plan))}
    print(f"  [{card}] solver_step ({PLAN_BATCH}, {D_plan}) fp32 "
          f"({k1_design[f'{PLAN_BATCH}x{D_plan}']}, one launch): {k1p_ms * 1e3:.2f} us on the "
          f"device, bound {k1p_bound * 1e3:.2f} us, launch floor {floor_ms * 1e3:.2f} us; plain "
          f"{k1p_plain * 1e3:.1f} us; (8, {D}) ({k1_design[f'{B}x{D}']}, one launch): "
          f"{k1_ms * 1e3:.2f} us, bound {k1_bound * 1e3:.2f} us")
    small_ptxas = small_kernels_build_summary(log)
    print(f"  flash_attention {(2 * PLAN_BATCH, ah, a_s, ahd)} fp32: {k3p_ms * 1e3:.2f} us on "
          f"the device, bound {k3p_bound * 1e3:.3f} us (bytes); plain {k3p_plain * 1e3:.1f} us; "
          f"SDPA {k3p_lib * 1e3:.1f} us")

    # one TRAJ_UNET forward at 2·64 rows: eager (host launch gaps included)
    # and replayed from a CUDA graph (device time only)
    fsets = [(torch.randn(2 * PLAN_BATCH, *pcfg.sample_shape, generator=gen, device=dev),
              torch.rand(2 * PLAN_BATCH, generator=gen, device=dev) * 0.99 + 0.01, yy)
             for _ in range(2)]
    fwd = lambda x, t, y: unet(x, t, y=y)
    with torch.no_grad():
        unet_eager = timed_ms(fwd, fsets, 20)
        unet_dev = device_ms(fwd, fsets, reps=4, replays=5)
        unet.cfg = dataclasses.replace(ucfg, use_flash=False, use_fused_norm=False)
        unet_plain_eager = timed_ms(fwd, fsets, 20)
        unet_plain_dev = device_ms(fwd, fsets, reps=4, replays=5)
        unet.cfg = ucfg
    # the kernels of one eager forward, by name (torch.profiler, CUPTI)
    with torch.no_grad():
        by_name, dev_us = profile_device(lambda: fwd(*fsets[0]))
    n_kern = sum(n for n, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"  profiled eager forward: {n_kern} device operations, {dev_us:.0f} us of device "
          f"time; largest: " + "; ".join(f"{name[:60]} x{n} {us:.0f} us"
                                          for name, (n, us) in top))
    # the device's busy time over one whole host-driven planning solve (one
    # stream, so the kernel times add up) against its unprofiled wall; the
    # graphed solve's share is phase 4's (CUDA events: CUPTI cannot trace
    # the WHILE node)
    host_plan = lambda: host_chain(sde, plan_score, (PLAN_BATCH,) + pcfg.sample_shape, 0,
                                   dataclasses.replace(plan_cfg, conditioner=pcond_c), dev,
                                   cond=pcond)
    _, busy_us = profile_device(host_plan)
    busy_ms = busy_us / 1e3
    host_wall = graphed["planning"]["host_s"]
    print(f"  host-driven planning solve: device busy {busy_ms:.1f} ms of the "
          f"{host_wall * 1e3:.1f} ms unprofiled wall, idle share "
          f"{1 - busy_ms / (host_wall * 1e3):.2f}; graphed: window share "
          f"{graphed['planning']['window_share']:.2f} of {plan_wall * 1e3:.1f} ms")
    iter_ms = plan_wall / max(p_iters, 1) * 1e3
    print(f"  TRAJ_UNET forward at {2 * PLAN_BATCH} rows: eager {unet_eager:.3f} ms, "
          f"device (graph replay) {unet_dev:.3f} ms; all-plain forward: eager "
          f"{unet_plain_eager:.3f} ms, device {unet_plain_dev:.3f} ms; the planning path spends "
          f"{iter_ms:.2f} ms per iteration, of which two eager forwards are "
          f"{2 * unet_eager:.2f} ms ({200 * unet_eager / iter_ms:.0f} %)")

    # K7 at the prefill shape and at prefill_32k's length
    k7 = lambda *a: ssd_ops.ssd_scan(*a)
    k7_plain_fn = lambda *a: ssd_ref.ssd_chunked(*a)
    k7_t = {}
    for shape, n_sets, reps, plain_reps in ((SSD_SHAPES[0], 2, 20, 4),
                                            (SSD_SHAPES[3], 1, 6, 2)):
        sets = [ssd_inputs(*shape, gen=gen) for _ in range(n_sets)]  # each > the L2
        ms = device_ms(k7, sets, reps=reps, replays=2)
        # the same kernel on one range a sequence: what the ranges buy
        one = device_ms(lambda *a: ssd_ops._launch(*a, return_state=False, ranges=1), sets,
                        reps=reps, replays=2)
        plain = device_ms(k7_plain_fn, sets, reps=plain_reps, replays=2)
        host = timed_ms(k7, sets, reps)
        flops, nbytes = ssd_work(*shape)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        # fp32 as 3xTF32: three tensor-core products for each multiply-add
        bound = max(t_bytes, 3 * flops / TF32_FLOPS * 1e3)
        bound_cuda_cores = max(t_bytes, flops / FP32_FLOPS * 1e3)
        ranges = ssd_ops.ranges_for(sets[0][0])
        k7_t[shape] = dict(ms=ms, plain_ms=plain, host_ms=host, bound_ms=bound,
                           bound_fp32_cuda_cores_ms=bound_cuda_cores, ranges=ranges,
                           ms_one_range=one,
                           bound_by="bytes" if t_bytes >= bound else "operations")
        print(f"  ssd_scan {shape} fp32 (mma.sync 3xTF32, {ranges} ranges a sequence): "
              f"{ms:.3f} ms on the device; bounds: 3xTF32 on the tensor cores {bound:.3f} ms "
              f"(3 x {flops / 1e9:.1f} GFLOP at 495 TFLOP/s; {bound / ms:.0%} of it reached), "
              f"fp32 on the CUDA cores {bound_cuda_cores:.3f} ms (67 TFLOP/s), bytes "
              f"{t_bytes:.3f} ms ({nbytes / 1e6:.0f} MB at 3.35 TB/s); "
              f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s achieved; one range a sequence "
              f"{one:.3f} ms; plain {plain:.3f} ms; eager loop with host gaps {host:.3f} ms")
        del sets
    ssd_build_summary(log)
    del unet, plan_score, fsets, fwd
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 6a. serve
    phase("main path: the continuous-batching server on HIGHRES_DIT, tiered (K2, K3)")
    srv = run_serve(dev, card)

    # ------------------------------------------------------ 6c. device-resident serve
    phase("main path: the device-resident serve loop on HIGHRES_DIT (P1, P2, K2, K3; "
          "a WHILE-node CUDA graph a window)")
    dsrv = run_device_serve(dev, card, floor_ms)

    # ------------------------------------------------------------ 6d. zoo
    phase("the solver zoo: momentum and Heun from HIGHRES_DIT (K1, K3), the selection race "
          "(K1, K5), both families served")
    zoo = run_zoo(dev, card, rec)

    # ----------------------------------------------------- 6e. planning service
    phase("planning served through the batcher: the OU service, then the closed loop at "
          "TRAJ_UNET's width (K1, K3, K6, P1; host-driven and device-resident)")
    psrv = run_plan_service(dev, card)

    # ------------------------------------------------------ 6b. train/tables
    phase("train and tables: DIT_100M trained and sampled (K1, K3); Tables 1, 3, 4-5 (K1, K5)")
    tt = train_and_tables(dev, card)
    gc.collect()  # the graph cache's drivers go with their score nets
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7. lm
    phase("main path: mamba2-2.7b prefill through K7 and greedy serving")
    lm = run_lm(dev)

    # ------------------------------------------------------- 7b. attention lm
    phase("main path: gemma3-12b prefill through K3 (causal, windowed, GQA), serve_batch "
          "and the continuous batcher")
    alm = run_attention_lm(dev, card)

    # -------------------------------------------------------- 7c. diffusion lm
    phase("main path: the diffusion LM on olmo-1b's backbone, adaptive through K1")
    dlm_rec = run_diffusion_lm(dev)

    # ------------------------------------------------------------ 7d. moe lm
    phase("main path: the mixture-of-experts LMs: deepseek-moe-16b and granite-moe-3b-a800m "
          "through K3, jamba-v0.1-52b's hybrid period through K7 and K3")
    moe_rec = run_moe_lm(dev, card)

    # ------------------------------------------------- 7e. vlm, audio, training
    phase("main path: llama-3.2-vision-90b's period (cross-attention) and musicgen-medium "
          "(codebooks) through K3, and musicgen-medium trained at full width")
    xc_rec = run_vlm_audio_lm(dev, card)

    # ------------------------------------------------------------- 8. sharded
    phase("sharded sampling: K4 and sample(mesh=) over torch.distributed")
    k4 = run_sharded(dev, card, rec["wall_s"])
    # the agreement that ends a horizon under a mesh (one a horizon: a
    # condition after every iteration there would be a collective each)
    from repro_torch.benchmarks import loop_condition
    mesh_flags = loop_condition.mesh_flags_times(dev)
    print(f"  [{card}] world-1 NCCL mesh, MeshFlags.update on {mesh_flags['slots']} slots "
          f"(the all-reduce of 3 int32 and the catch-up): captured and replayed "
          f"{mesh_flags['captured_update_ms'] * 1e3:.2f} us, eager "
          f"{mesh_flags['eager_update_ms'] * 1e3:.2f} us, the captured all-reduce alone "
          f"{mesh_flags['captured_all_reduce_ms'] * 1e3:.2f} us (CUDA events, "
          f"{mesh_flags['reps']} calls); the captured graphs hold "
          f"{mesh_flags['update_nodes']} and {mesh_flags['all_reduce_nodes']} nodes (an "
          f"in-place all-reduce at world 1 may enqueue none)")

    # ----------------------------------------------------------- 9. precision
    phase("precision: HIGHRES_DIT under bf16 and bf16_full (K1, K3), the precision gate, the "
          "bf16_full tiered serve (K2, K3, P1), gemma3-12b (K3) and mamba2-2.7b (K7) in bf16, "
          "roofline shares")
    prec = run_precision(dev, card, rec, alm, lm)

    # ------------------------------------------------------------ 10. LM mesh
    phase("the LMs served under a (data, model) mesh: K3/K7 on each rank's heads, "
          "flash-decode, world 1 NCCL and world 2 gloo")
    lm_mesh = run_lm_mesh(dev, card)

    # ------------------------------------------------------- 11. training mesh
    phase("LM training under a (data, model) mesh: world 1 NCCL train_loop bitwise, world 2 "
          "gloo tp / remat / data parallel / fsdp / zero1 and the other mixers")
    train_mesh = run_train_mesh(dev, card)

    # the graphed loops of this slice, in one place: the solves' walls (first
    # call, replayed, host-driven) and the decode steps' ms (graphed, eager)
    graphed_all = {**{f"dit_{k}" if k == "adaptive" else k: v for k, v in graphed.items()},
                   **{f"dit_{m}": zoo["graphed"][m] for m in ("momentum", "heun")}}
    decodes = {"mamba2-2.7b": lm["decode"], "gemma3-12b": alm["decode"],
               "deepseek-moe-16b": moe_rec["deepseek-moe-16b"]["decode"],
               "jamba-v0.1-52b (one period)": moe_rec["jamba-v0.1-52b"]["decode"],
               **{k: v["decode"] for k, v in xc_rec.items()
                  if isinstance(v, dict) and "decode" in v}}
    print(f"graphed solves [{card}] (s: first call, replayed, host-driven; reads; window "
          f"share): " + "; ".join(
              f"{k} {v['first_s']:.3f}, {v['replay_s']:.3f}, {v['host_s']:.3f}; "
              f"{v['host_reads']} vs {v['host_driven_reads']}; {v['window_share']:.2f}"
              for k, v in graphed_all.items()))
    print(f"graphed guided solves [{card}] (s: first call, replayed, host-driven, replayed "
          f"with another payload; iterations; reads; window share): " + "; ".join(
              f"{k} {v['graphed']['first_s']:.3f}, {v['graphed']['replay_s']:.3f}, "
              f"{v['graphed']['host_s']:.3f}, {v['swap_s']:.3f}; {v['graphed']['iterations']}; "
              f"{v['graphed']['host_reads']} vs {v['graphed']['host_driven_reads']}; "
              f"{v['graphed']['window_share']:.2f}" for k, v in guided.items()
              if k in ("cfg", "inpaint")))
    print(f"graphed baselines [{card}] (s: host-driven, captured, replayed; host reads "
          f"host-driven / graphed): " + "; ".join(
              f"{k} {v['host_s']:.3f}, {v['second_s']:.3f}, {v['replay_s']:.3f}; "
              f"{v['host_driven_reads']} / {v['host_reads']}"
              for k, v in graphed_baselines.items()))
    print(f"graphed decode [{card}] (ms a step graphed / eager; graphed elapsed ms (events); "
          f"busy ms graphed / eager (profiler); build s): " + "; ".join(
              f"{k} {v['graphed_ms_per_step']:.2f} / {v['eager_ms_per_step']:.2f}; "
              f"{v['graphed_elapsed_ms_per_step']:.2f}; "
              f"{busy_text(v['graphed_busy_ms_per_step'])} / "
              f"{v['decode_device_ms_per_step']:.2f}; {v['build_s']:.3f}"
              for k, v in decodes.items()))
    mesh_solves = {**{m: k4["graphed"]["world1"][m] for m in ("adaptive", "em", "pc", "ode")},
                   "pipeline": k4["dit_mesh"]["solve"]["calls"],
                   "tp": k4["dit_mesh"]["tp_solve"]["calls"]}
    print(f"graphed under a mesh [{card}] (world 1, NCCL; s: host-driven, capturing, "
          f"replayed; host reads; window share replayed): " + "; ".join(
              f"{k} {', '.join(f'{w:.3f}' for w in v['walls_s'])}; {v['host_reads']}; "
              f"{v['window_share'][-1]:.2f}" for k, v in mesh_solves.items()))
    print(f"graphed decode under a mesh [{card}] (world 1, NCCL; ms a step graphed / eager; "
          f"build s): " + "; ".join(
              f"{k} {v['graphed_ms_per_step']:.2f} / {v['eager_ms_per_step']:.2f}; "
              f"{v['build_s']:.3f}" for k, v in lm_mesh["graphed_decode"].items()))

    def device_resident_launches(name):
        """A kernel's launches in phase 6c's device-resident drain."""
        got = dsrv["launches"]
        return {"launches": got[name], "per_body_iteration_in_graph":
                got["per_body_iteration_in_graph"][name], "eager": got["eager"][name]}

    kernels = [
        {"name": "solver_step", "route": "cuda",
         "source": "src/repro_torch/kernels/solver_step/csrc/solver_step.cu",
         "replaces": "src/repro/kernels/solver_step/kernel.py:158",
         "launches": launches["solver_step"],
         "graphed": {"launched_as": "error_step inside the WHILE node of the graphed solve: "
                                    "the replayed call's launches (phases 3, 4, 6d)",
                     **{k: v["launches"]["solver_step"] for k, v in graphed_all.items()}},
         "max_abs_err": step_err[(torch.float32, D, False)],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / FP32_FLOPS
         else "operations",
         "library_ms": None,
         "plain": PLAIN_STEP,
         "design": k1_design[f"{B}x{D}"],
         "cuda_kernels_per_call": step_per_call,
         "launch_floor_ms": floor_ms,
         "planning": {"launches": plan_launches["solver_step"], "ms": k1p_ms,
                      "plain_ms": k1p_plain, "bound_ms": k1p_bound,
                      "design": k1_design[f"{PLAN_BATCH}x{D_plan}"]},
         "tables": {"launches": tt["k1_tables"], "max_abs_err": t1_state_err["solver_step"],
                    **tt["k1_t1"]},
         "trained_dit_100m": {"launches": tt["dit_launches"]["solver_step"],
                              "iterations": tt["dit_iterations"]},
         "beyond_65535_rows": streams["k1_big"],
         "guided": guided_launches(guided, "solver_step", "error_step in every iteration of "
                                   "phase 3b's controlled generation from HIGHRES_DIT"),
         "zoo": {"launched_as": "error_step in every iteration of momentum and Heun "
                                "(phase 6d): from HIGHRES_DIT, in the selection race, served",
                 **{m: zoo["dit"][m]["launches"]["solver_step"] for m in ("momentum", "heun")},
                 "race": {k: v["launches"]["solver_step"] for k, v in zoo["race"].items()
                          if v["launches"]["solver_step"]}},
         "plan_service": {"launched_as": "error_step at (16, 768) in every iteration of the "
                                         "served closed loop at TRAJ_UNET's width (phase 6e)",
                          "launches": psrv["closed_loop"]["launches"]["solver_step"],
                          "device_resident": psrv["device_resident_launches"]["solver_step"]},
         "diffusion_lm": {"launched_as": "error_step at (4, 64·64) in every iteration of the "
                                         "diffusion LM's adaptive solve on olmo-1b's backbone "
                                         "(phase 7c), 8·⌈iterations/8⌉",
                          **dlm_rec},
         "ptxas": [r for r in small_ptxas if r["kernel"].startswith("error_step")],
         "precision": {"launched_as": "error_step in every iteration of HIGHRES_DIT's "
                                      "adaptive solve under bf16 (fp32 state) and bf16_full "
                                      "(bf16 state), 8·⌈iterations/8⌉ (phase 9a)",
                       **{p: prec["dit"][p]["launches"]["solver_step"] for p in PRESETS_BF16},
                       "max_abs_err_bf16_state": k1_bf16_err,
                       **{k: prec["times"]["K1"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by")}}},
        {"name": "solver_step_per_row_eps", "route": "cuda",
         "source": "src/repro_torch/kernels/solver_step/csrc/solver_step.cu",
         "replaces": "src/repro/kernels/solver_step/kernel.py:242",
         "launches": srv["launches"],
         "max_abs_err": k2_err,
         "ms": srv["ms"], "plain_ms": srv["plain_ms"], "bound_ms": srv["bound_ms"],
         "bound_by": srv["bound_by"], "library_ms": None,
         "plain": PLAIN_STEP,
         "launched_as": "error_step with (B,) eps: the solver_step kernel, eps by pointer; "
                        "the launches of the tiered serve (phase 6a)",
         "serve": {k: srv[k] for k in ("wall_s", "requests_per_s", "idle_share", "mean_nfe",
                                       "host_transfers", "solver_syncs", "iterations",
                                       "body_iterations", "wasted_nfe_fraction",
                                       "passenger_nfe_fraction",
                                       "wasted_nfe_fraction_no_compaction",
                                       "flash_launches")},
         "device_resident": device_resident_launches("solver_step"),
         "precision": {"launched_as": "error_step with (B,) eps on bf16 state: the tiered "
                                      "serve under bf16_full (phase 9c)",
                       "launches": prec["serve"]["launches"]["solver_step"],
                       **{k: prec["times"]["K2"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by")}}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:102",
         "launches": launches["flash_attention"],
         "max_abs_err": attn_err[(S, torch.float32, False, None)],
         "design": "mma.sync 3xTF32",
         "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound,
         "bound_by": "bytes" if k3_bytes / HBM_BYTES_PER_S >= 3 * k3_ops / TF32_FLOPS
         else "operations",
         "bound_of": "3xTF32 on the tensor cores (3 x 4·B·H·S²·D at 495 TFLOP/s)",
         "bound_fp32_cuda_cores_ms": k3_bound_cuda_cores,
         "library_ms": k3_lib,
         "bf16": {"design": "mma.sync bf16", "ms": k3b_ms, "plain_ms": k3b_plain,
                  "bound_ms": k3b_bound,
                  "bound_by": "bytes" if k3_bytes / 2 / HBM_BYTES_PER_S >= k3_ops / BF16_FLOPS
                  else "operations", "library_ms": k3b_lib,
                  "max_abs_err": attn_err[(S, torch.bfloat16, False, None)]},
         "planning": {"launches": plan_launches["flash_attention"], "ms": k3p_ms,
                      "plain_ms": k3p_plain, "bound_ms": k3p_bound, "library_ms": k3p_lib},
         "trained_dit_100m": {"launches": tt["dit_launches"]["flash_attention"],
                              "iterations": tt["dit_iterations"]},
         "beyond_65535_heads": streams["k3_big"],
         "guided": {**guided_launches(guided, "flash_attention",
                                      "the DiT's attention in phase 3b's controlled generation "
                                      "from HIGHRES_DIT (CFG: one forward over 2B = 16 rows "
                                      "an evaluation)"),
                    "cfg_shape": {"shape": list(CFG_ATTN),
                                  "max_abs_err": attn_err[(*CFG_ATTN, torch.float32, False, None)],
                                  **{k: guided["k3"][k] for k in (
                                      "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}},
         "graphed_baselines": {"launched_as": "the DiT's attention inside the WHILE node of "
                                              "each graphed baseline from HIGHRES_DIT: a "
                                              "replayed solve's launches (phase 4b)",
                               **{k: v["launches"]["flash_attention"]
                                  for k, v in graphed_baselines.items() if "launches" in v}},
         "device_resident": device_resident_launches("flash_attention"),
         "mesh_serve": {"launched_as": "the DiT's attention in the tiered HIGHRES_DIT serve on "
                                       "a world-1 NCCL mesh, host-driven then device-resident "
                                       "(phase 8)",
                        "launches": k4["mesh"]["k3"],
                        **{k: k4["mesh"][k]["launches"]["flash_attention"]
                           for k in ("host", "device_resident")}},
         "zoo": {"launched_as": "the DiT's attention in momentum and Heun from HIGHRES_DIT "
                                "(phase 6d)",
                 **{m: zoo["dit"][m]["launches"]["flash_attention"]
                    for m in ("momentum", "heun")}},
         "plan_service": {"launched_as": "TRAJ_UNET's bottleneck attention, once a forward, in "
                                         "the served closed loop (phase 6e)",
                          "launches": psrv["closed_loop"]["launches"]["flash_attention"],
                          "device_resident":
                              psrv["device_resident_launches"]["flash_attention"]},
         "lm_mesh": {"launched_as": "every 'A'/'L' layer of the phase-10 prefills on each "
                                    "rank's heads under a (data, model) mesh: gemma3-12b's "
                                    "6-layer period (8 of 16 query heads, 4 of 8 KV heads at "
                                    "mesh 1x2), "
                                    "deepseek-moe-16b's 2 layers (8 of 16), "
                                    "llama-3.2-vision-90b's period (32 of 64, 4 of 8)",
                     "launches_per_rank": lm_mesh_launches(lm_mesh, "K3")},
         "train_mesh": train_mesh_launches(train_mesh, "K3"),
         "dit_pipeline": {"launched_as": "the DiT's attention in phase 8's check 7: HIGHRES_DIT's "
                                         "pipelined forward, batch 8 in 4 microbatches of 2, "
                                         "one stage of 12 layers at world 1 (NCCL), two of 6 "
                                         "at world 2 (gloo)",
                          "launches_per_rank": k4["dit_mesh"]["pipeline"],
                          "max_abs_err": attn_err[(*PIPE_ATTN, torch.float32, False, None)],
                          **k4["dit_mesh"]["k3"]["pipeline"]},
         "dit_tensor_parallel": {"launched_as": "the DiT's attention in phase 8's check 8: "
                                                "HIGHRES_DIT's tensor-parallel forward, batch 8, "
                                                "all 12 heads at 1x1 (NCCL), 6 a rank at 1x2 "
                                                "(gloo)",
                                 "launches_per_rank": k4["dit_mesh"]["tensor_parallel"],
                                 "max_abs_err": attn_err[(*TP_ATTN, torch.float32, False, None)],
                                 **k4["dit_mesh"]["k3"]["tensor_parallel"]},
         "attention_lm": {"launched_as": "every attention layer of gemma3-12b's (1, 4096) "
                                         "prefill (phase 7b): causal with window 1024 on the "
                                         "40 'L' layers, causal on the 8 'A' layers, GQA 16:8, "
                                         "head_dim 256, fp32",
                          "launches": alm["launches"],
                          "max_abs_err": {
                              "L": attn_err[(GEMMA_ATTN[3], torch.float32, True, GEMMA_WINDOW)],
                              "A": attn_err[(GEMMA_ATTN[3], torch.float32, True, None)]},
                          **{kind: alm["k3"][kind] for kind in ("L", "A")},
                          **{k: alm[k] for k in ("prefill_s", "plain_prefill_s", "params",
                                                 "peak_gib", "logit_err", "serve_ms_per_step",
                                                 "decode_idle_share",
                                                 "decode_device_ms_per_step",
                                                 "batcher_s", "batcher_steps",
                                                 "wasted_step_fraction",
                                                 "batcher_tokens_per_s", "differ")}},
         "moe_lm": {"launched_as": "every attention layer of the MoE LMs' prefills (phase 7d), "
                                   "causal, fp32: deepseek-moe-16b (1, 4096), 28 'A' layers, MHA "
                                   "16 heads at head_dim 128; granite-moe-3b-a800m (1, 4096), 32 "
                                   "'A', GQA 24:8 at 64; jamba-v0.1-52b one period (1, 2048), 1 "
                                   "'A', GQA 32:8 at 128",
                    **{name: {"launches": moe_rec[name]["launches"]["K3"],
                              "max_abs_err": attn_err[(*shape, torch.float32, True, None)],
                              **{k: moe_rec["k3"][name][k] for k in (
                                  "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
                       for name, shape in kernel_times.MOE_ATTN_SHAPES.items()}},
         "vlm_audio_lm": {"launched_as": "every 'A' layer of the prefills of phase 7e, causal, "
                                         "fp32: llama-3.2-vision-90b's period (1, 4096), 4 'A' "
                                         "layers, GQA 64:8 at head_dim 128 (its 'X' layer takes "
                                         "the plain path); musicgen-medium (4, 1500, 4 "
                                         "codebooks), 48 'A', MHA 24 heads at 64, a ragged S",
                          **{name: {"shape": list(shape),
                                    "launches": xc_rec[name]["launches"],
                                    "max_abs_err": attn_err[(*shape, torch.float32, True, None)],
                                    **{k: xc_rec["k3"][name][k] for k in (
                                        "ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by")}}
                             for name, shape in kernel_times.VLM_AUDIO_ATTN_SHAPES.items()}},
         "precision": {"launched_as": "bf16: the DiT's attention under bf16 and bf16_full "
                                      "(phase 9a), the bf16_full serve (9c), every layer of "
                                      "gemma3-12b's (1, 4096) prefill in bf16 (9d)",
                       **{p: prec["dit"][p]["launches"]["flash_attention"]
                          for p in PRESETS_BF16},
                       "serve_bf16_full": prec["serve"]["launches"]["flash_attention"],
                       "gemma3-12b": {
                           "launches": prec["gemma3-12b"]["launches"]["K3"],
                           "max_abs_err": {
                               "L": attn_err[(GEMMA_ATTN[3], torch.bfloat16, True,
                                              GEMMA_WINDOW)],
                               "A": attn_err[(GEMMA_ATTN[3], torch.bfloat16, True, None)]},
                           **{kind: prec["times"]["K3"][kind] for kind in ("L", "A")}}}},
        {"name": "groupnorm_silu", "route": "cuda",
         "source": "src/repro_torch/kernels/groupnorm_silu/csrc/groupnorm_silu.cu",
         "replaces": "src/repro/kernels/groupnorm_silu/kernel.py:81",
         "launches": plan_launches["groupnorm_silu"],
         "max_abs_err": gn_err[(None, torch.float32, gn_h, gn_c)],
         "ms": k6_ms, "plain_ms": k6_plain, "bound_ms": k6_bound,
         "bound_by": "bytes" if k6_bytes / HBM_BYTES_PER_S >= k6_ops / FP32_FLOPS
         else "operations",
         "library_ms": None,
         "two_calls_ms": k6_two_calls,
         "two_calls": "F.group_norm then F.silu on x laid out (B, C, H)",
         "launch_floor_ms": floor_ms,
         "paths": gn_paths,
         "ms_by_shape": k6_shapes,
         "general_path_ms_by_shape": k6_general,
         "plan_service": {"launched_as": "every GroupNorm → SiLU of TRAJ_UNET (17 a forward) "
                                         "in the served closed loop (phase 6e), the first "
                                         "served path and the first captured horizon with K6",
                          "launches": psrv["closed_loop"]["launches"]["groupnorm_silu"],
                          "device_resident":
                              psrv["device_resident_launches"]["groupnorm_silu"]},
         "ptxas": [r for r in small_ptxas if r["kernel"].startswith("gn_silu")]},
        {"name": "em_step", "route": "cuda",
         "source": "src/repro_torch/kernels/solver_step/csrc/em_step.cu",
         "replaces": "src/repro/kernels/solver_step/kernel.py:92",
         "launches": k5_launches["em"],
         "max_abs_err": em_err[(torch.float32, B, D)],
         "ms": k5_t[(torch.float32, B, D)]["ms"],
         "plain_ms": k5_t[(torch.float32, B, D)]["plain_ms"],
         "bound_ms": k5_t[(torch.float32, B, D)]["bound_ms"],
         "bound_by": k5_t[(torch.float32, B, D)]["bound_by"],
         "library_ms": None,
         "design": "one flat pass over B·D on a 1-D grid, 16-byte packs where aligned",
         "pc_launches": k5_launches["pc"],
         "launch_floor_ms": floor_ms,
         "by_state": {f"{str(dt)[6:]} {b}x{d}": {k: v[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "grid", "evict_first")}
             for (dt, b, d), v in k5_t.items()},
         "table2": {k: k5_t[(torch.float32, table2_highdim.N, table2_highdim.D)][k]
                    for k in ("ms", "plain_ms", "bound_ms")},
         "tables": {"launches": tt["k5_tables"],
                    "max_abs_err": em_err[(torch.float32, 4096, 2)],
                    **{k: k5_t[(torch.float32, 4096, 2)][k]
                       for k in ("ms", "plain_ms", "bound_ms")},
                    "em1000_n4096": tt["em1000_idle"]},
         "mesh": {"launched_as": "EM-59 from HIGHRES_DIT under mesh= on a world-1 NCCL mesh "
                                 "(phase 8)",
                  "launches": k4["mesh"]["k5"], "bitwise_equal": k4["mesh"]["em"]["bitwise_equal"]},
         "graphed_baselines": {"launched_as": "em_step inside the WHILE node of EM-60, PC-30 "
                                              "and PC-HMC-21 from HIGHRES_DIT: a replayed "
                                              "solve's launches, the host-driven loop's "
                                              "(phase 4b)",
                               **{k: v["launches"]["em_step"]
                                  for k, v in graphed_baselines.items() if "launches" in v}},
         "zoo_race": {"launched_as": "em_step on the EM, PC and PC-HMC rows of the solver "
                                     "selection race (phase 6d)",
                      **{k: v["launches"]["em_step"] for k, v in zoo["race"].items()
                         if v["launches"]["em_step"]}},
         "ptxas": [r for r in small_ptxas if r["kernel"].startswith("em_step")]},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd/kernel.py:82",
         "launches": lm["k7_launches"],
         "lm_mesh": {"launched_as": "every layer of mamba2-2.7b's first 8 in its (4, 2048) "
                                    "prefill on each rank's heads (40 of 80 at mesh 1x2; "
                                    "phase 10)",
                     "launches_per_rank": lm_mesh_launches(lm_mesh, "K7")},
         "train_mesh": train_mesh_launches(train_mesh, "K7"),
         "max_abs_err": ssd_err[SSD_SHAPES[0]],
         "design": "mma.sync 3xTF32; C·Bᵀ once a group; sequence ranges",
         "cuda_kernels_per_call": lm["k7_cuda_kernels_per_call"],
         "ranges": k7_t[SSD_SHAPES[0]]["ranges"],
         "ms_one_range": k7_t[SSD_SHAPES[0]]["ms_one_range"],
         "ms": k7_t[SSD_SHAPES[0]]["ms"], "plain_ms": k7_t[SSD_SHAPES[0]]["plain_ms"],
         "bound_ms": k7_t[SSD_SHAPES[0]]["bound_ms"],
         "bound_by": k7_t[SSD_SHAPES[0]]["bound_by"],
         "bound_of": "3xTF32 on the tensor cores (3 x ssd_work's flops at 495 TFLOP/s)",
         "bound_fp32_cuda_cores_ms": k7_t[SSD_SHAPES[0]]["bound_fp32_cuda_cores_ms"],
         "library_ms": None,
         "prefill_32k": {k: k7_t[SSD_SHAPES[3]][k]
                         for k in ("ms", "plain_ms", "bound_ms", "bound_fp32_cuda_cores_ms",
                                   "ranges", "ms_one_range")},
         "jamba": {"launched_as": "the 7 'M' layers of jamba-v0.1-52b's (1, 2048) prefill, one "
                                  "8-layer period at full width, d_state 16 (phase 7d)",
                   "shape": list(kernel_times.JAMBA_SSD_SHAPE),
                   "launches": moe_rec["jamba-v0.1-52b"]["launches"]["K7"],
                   "max_abs_err": ssd_err[kernel_times.JAMBA_SSD_SHAPE],
                   **{k: moe_rec["k7"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "ranges")}},
         "precision": {"launched_as": "every layer of mamba2-2.7b's (4, 2048) prefill in bf16 "
                                      "(phase 9e)",
                       "launches": prec["mamba2-2.7b"]["launches"]["K7"],
                       "max_abs_err": ssd_err[(SSD_SHAPES[0], torch.bfloat16)],
                       **{k: prec["times"]["K7"][k] for k in ("ms", "plain_ms", "bound_ms",
                                                             "bound_by", "ranges")}}},
        {"name": "sharded_solver_step", "route": "cuda",
         "source": "src/repro_torch/kernels/solver_step/csrc/solver_step.cu",
         "replaces": "src/repro/kernels/solver_step/ops.py:123",
         "launches": k4["launches"],
         "max_abs_err": k4["max_abs_err"],
         "ms": k4["times"]["full"]["ms"], "plain_ms": k4["times"]["full"]["plain_ms"],
         "bound_ms": k4["times"]["full"]["bound_ms"],
         "bound_by": k4["times"]["full"]["bound_by"],
         "library_ms": None,
         "plain": PLAIN_STEP,
         "launched_as": "batch-only sharded_error_step: the solver_step kernel's full mode "
                        "on the rank's rows (timed in the solver_step row)",
         "ms_of": "the partial (feature-split) mode at the full state",
         "feature_half": {k: k4["times"]["half"][k] for k in ("ms", "plain_ms", "bound_ms")},
         "all_reduce_9_us": k4["all_reduce_9_us"],
         "mesh_serve": {"launched_as": "K4 with per-row tolerances in every body iteration "
                                       "of the tiered HIGHRES_DIT serve on a world-1 NCCL "
                                       "mesh, host-driven then device-resident (phase 8)",
                        "launches": k4["mesh"]["k4"],
                        **{k: k4["mesh"][k]["launches"]["sharded_solver_step"]
                           for k in ("host", "device_resident")}}},
        {"name": "philox_normal", "route": "cuda",
         "source": "src/repro_torch/kernels/philox/csrc/philox_normal.cu",
         "replaces": "none: XLA's threefry in _draw_noise, src/repro/core/solvers/adaptive.py:410",
         "launches": dsrv["launches"]["philox_normal"],
         "max_abs_err": streams["p1_err"][(SERVE_SLOTS, D)],
         "ms": dsrv["p1"]["ms"], "plain_ms": dsrv["p1"]["plain_ms"],
         "bound_ms": dsrv["p1"]["bound_ms"], "bound_by": dsrv["p1"]["bound_by"],
         "library_ms": None,
         "torch_randn_ms": dsrv["p1"]["randn_ms"],
         "launched_as": "per-slot noise (SlotStreams) of the device-resident serve (phase 6c): "
                        "the captured horizon's calls times the horizons run, plus the eager "
                        "calls (the capture's warm-up, admissions)",
         "sample_path": {"launched_as": "sample()'s per-row streams: the prior at counter 0, "
                                        "then the graphed solve's draws (phases 3, 4, 6d; "
                                        "Heun draws none)",
                         **{k: v["launches"]["philox_normal"] for k, v in graphed_all.items()}},
         "guided": guided_launches(guided, "philox_normal",
                                   "sample()'s per-row streams in phase 3b: the prior, then z "
                                   "an iteration (CFG) or z and the projection's draw "
                                   "(inpainting)"),
         "graphed_baselines": {"launched_as": "the baselines' per-row noise (EM, PC, PC-HMC "
                                              "from HIGHRES_DIT) in a replayed graphed solve, "
                                              "the prior included (phase 4b)",
                               **{k: v["launches"]["philox_normal"]
                                  for k, v in graphed_baselines.items() if "launches" in v}},
         "device_resident": device_resident_launches("philox_normal"),
         "plan_service": {"launches": psrv["closed_loop"]["launches"]["philox_normal"],
                          "device_resident": psrv["device_resident_launches"]["philox_normal"]},
         "mesh_serve": {"launches": k4["mesh"]["p1"],
                        **{k: k4["mesh"][k]["launches"]["philox_normal"]
                           for k in ("host", "device_resident")}},
         "max_abs_err_by_shape": {f"{b}x{d}": e for (b, d), e in streams["p1_err"].items()}},
        {"name": "horizon_cond", "route": "cuda",
         "source": "src/repro_torch/kernels/graph_loop/csrc/while_driver.cu",
         "replaces": "none: the lax.while_loop conditions of solve_chunk and solve_horizons, "
                     "src/repro/core/solvers/adaptive.py:640-648, :709-721",
         "launches": dsrv["launches"]["horizon_cond"],
         "max_abs_err": float(streams["p2_err"]),
         "ms": dsrv["p2"]["ms"], "plain_ms": dsrv["p2"]["plain_ms"],
         "bound_ms": dsrv["p2"]["bound_ms"], "bound_by": dsrv["p2"]["bound_by"],
         "library_ms": None,
         "launch_floor_ms": floor_ms,
         "driver_windows": dsrv["launches"]["windows"],
         "graphed_solve": {"launched_as": "the WHILE node's condition of sample()'s graphed "
                                          "solve, after every iteration: the iterations + 1 "
                                          "a replayed solve (phases 3, 4, 6d)",
                           **{k: v["horizon_cond"] for k, v in graphed_all.items()}},
         "guided": {"launched_as": "the WHILE node's condition of phase 3b's graphed guided "
                                   "solves: the iterations + 1 a replayed call",
                    **{k: guided[k]["graphed"]["horizon_cond"] for k in ("cfg", "inpaint")}},
         "graphed_baselines": {"launched_as": "the WHILE node's condition of each graphed "
                                              "baseline from HIGHRES_DIT: one a step + 1 (the "
                                              "grids), one an attempt + 1 (the ODE) (phase 4b)",
                               **{k: v["horizon_cond"]
                                  for k, v in graphed_baselines.items() if "horizon_cond" in v}},
         "cuda_versions": dsrv["cuda_versions"],
         "mesh_horizon_agreement": mesh_flags,
         "serve": dsrv["rec"], "sync_check": dsrv["sync_check"],
         "plan_service": {"launches": psrv["device_resident_launches"]["horizon_cond"],
                          "first_round": psrv["first_round"]},
         "mesh_serve": {"launched_as": "the WHILE node's condition of the device-resident "
                                       "tiered HIGHRES_DIT serve on a world-1 NCCL mesh, after "
                                       "the captured all-reduce (phase 8)",
                        "launches": k4["mesh"]["p2"],
                        "serve": {k: {f: k4["mesh"][k][f] for f in (
                            "wall_s", "host_transfers", "windows", "iterations",
                            "bitwise_equal")} for k in ("host", "device_resident")},
                        "unsharded": {f: k4["mesh"]["unsharded"][f]
                                      for f in ("wall_s", "host_transfers", "iterations")},
                        "world2_gloo": {f: k4["mesh"]["world2"][f] for f in (
                            "wall_s", "bitwise_equal", "max_nfe_diff", "refills_per_device")}}},
    ]
    for k in kernels:
        if not all(math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            fail(f"non-finite measurement for {k['name']}")
    print(f"meta = books (phases 10, 11): every step equal; counted in "
          f"{lm_mesh['meta_s']['world1']:.1f} s at world 1 (NCCL, phase 10; phase 11's "
          f"world-1 train_loop has no collective to compare), "
          f"{lm_mesh['meta_s']['world2']:.1f} + {train_mesh['meta_s']['world2']:.1f} s a rank "
          f"at world 2 (gloo); phase 10 {lm_mesh['phase_s']:.1f} s, phase 11 "
          f"{train_mesh['phase_s']:.1f} s")
    phase(None)
    ode = graphed_baselines["ODE"]
    print(f"loop condition walls [{card}]: HIGHRES_DIT adaptive replayed "
          f"{graphed['adaptive']['replay_s']:.3f} s, host-driven {graphed['adaptive']['host_s']:.3f} "
          f"s ({graphed['adaptive']['iterations']} iterations); ODE replayed "
          f"{ode['replay_s']:.3f} s, host-driven {ode['host_s']:.3f} s ({ode['iterations']} "
          f"attempts); Table 1's adaptive rows replayed / host-driven us: "
          + ", ".join(f"{w['name'].split('/', 1)[1]} {w['replay_us']:.0f} / {w['host_us']:.0f}"
                      for w in tt["table1_walls"])
          + f"; world-1 mesh horizon agreement captured "
          f"{mesh_flags['captured_update_ms'] * 1e3:.2f} us, eager "
          f"{mesh_flags['eager_update_ms'] * 1e3:.2f} us")
    print("phase seconds: " + "; ".join(f"{name[:48]} {s:.1f}" for name, s in PHASE_SECONDS))
    print(f"chip_smoke: {time.perf_counter() - T0:.1f} s to the result lines")
    print(card)
    # the graphed sharded solves of phase 8 (check 9, checks 7 and 8's solves),
    # world 1 over NCCL: each kernel's launches in the replayed call
    graphed_solves = {**{m: k4["graphed"]["world1"][m] for m in ("adaptive", "em", "pc", "ode")},
                      "pipeline_solve": k4["dit_mesh"]["solve"]["calls"],
                      "tp_solve": k4["dit_mesh"]["tp_solve"]["calls"]}
    for entry in kernels:
        key = {"sharded_solver_step": "K4", "flash_attention": "K3", "em_step": "K5",
               "philox_normal": "P1", "horizon_cond": "P2"}.get(entry["name"])
        if key is not None:
            entry["graphed_mesh"] = {
                "launched_as": "the replayed call of phase 8's graphed sharded solves of "
                               "HIGHRES_DIT under sample(mesh=) (world 1, NCCL; checks 7, 8, 9), "
                               "each the host-driven call's launches",
                **{name: rec["launches"][-1][key] for name, rec in graphed_solves.items()},
                "host_driven": {name: rec["launches"][0][key]
                                for name, rec in graphed_solves.items()}}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke: done in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
