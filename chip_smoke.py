#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (six sources
     and a shared header, ten kernels) and report the build time and
     ptxas's registers and spills for each kernel instance;
  3. every kernel against its plain PyTorch version on the card.  The
     GNN's five at the shapes of a training step at batch 1024 and
     fanouts 25,10: on reddit ``--large-scale`` and on a reddit-sized
     R-MAT graph (2**18 nodes, 2**23 edges drawn, 602 features); ids,
     rows and the mean bit-equal (the mean against the plain k-order sum
     of true divisions by a divisor tensor).  The cached kernels read a
     cache built from the batch: ``neighbor_sample_cached`` every edge
     block the batch reaches resident at a permuted slot (the others at
     -1), at every chunk that phase 8's 128-block pinned edge cache plans
     for the batch's two hops (~224 launches of 19-285 targets on reddit)
     and, as count-0 yardsticks, at (1024,25) and (25600,10);
     ``feature_gather_cached`` the batch's unique rows at permuted slots,
     at each segment that a 4096-row pinned feature cache cuts the batch
     into (unpadded, as the path launches them) and at the padded
     unique-id length (count 0).  Both also at their edge cases, bit-equal
     to their plain versions: sampler widths off the block size, M 1,
     fanout 1, degree-0 tail targets, an unresolved slot, slot tables at
     and above the shared-memory budget; gathers of 1, 13 and 1001 rows at
     F 602, 100 and 7 with an unresolved id.  ``neighbor_sample`` and
     ``feature_gather_mean`` at theirs, bit-equal too: the sampler at M 1,
     fanout 1, widths off the block size, rand over all of int32,
     degree-0 tail targets and an edge array shorter than indptr says
     (positions clamped to E - 1); the mean at K 1, 7, 25 and 33, F 602,
     100 and 7, M 1 and 1001, a column of -0.0.  The LM's two:
     ``flash_attention_fwd`` (causal) at
     qwen2-0.5b's prefill (B 8, S 2048, 14 query over 2 kv heads, D 64),
     at D 128 (B 1, 32 over 8 heads) and D 256 (B 2, S 1024, 4 over 1) and
     at a ragged S 1000 and at moonshot-v1-16b-a3b's prefill (B 8, S
     2048, 16 over 16 heads, group 1, D 128), qwen2-vl-7b's (28 over 4,
     D 128) and seamless-m4t-large-v2's (16 over 16, D 64), out within
     2e-2 and lse within 1e-3; ``decode_attention`` over qwen2-0.5b's
     2,112-position cache at batch 8, valid_len 1, 1000 and 2112, window
     0 and 512, over moonshot's 2,064-position cache (16 over 16 heads, D
     128) at valid_len 2063, over qwen2-vl's (28 over 4, D 128) at 2063
     and over seamless's cross K/V (512 source frames, 16 over 16, D 64)
     at valid_len 512, within 2e-2, with its achieved GB/s and the host's
     enqueue time per call; the flash backward's
     ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` at the
     training shape (B 4, S 4096, 14 over 2 heads, D 64), at D 128 (32
     over 8), D 256, a ragged S 1000, one full (non-causal) case,
     moonshot's training-parity step (B 1, S 512, 16 over 16 heads, D
     128) and qwen2-vl's training step (B 1, S 4096, 28 over 4, D 128),
     dq, dk and dv within 1 % of the plain version's largest entry;
     ``ssd_chunk_scan`` at the layer-0 mixer inputs of mamba2-370m's and
     hymba-1.5b's serve entry points (B 8, S 2048; h 32, n 128 and h 50,
     n 16; p 64, chunk 256), at a group case (B 1, S 512, 8 heads over
     2 groups) and at two ragged cases (p 24, n 40, chunk 32 and p 100, n
     72, chunk 100: no tile multiples, the second past 64 in p and n) on
     random inputs, y and the
     final state within 1e-4 of the plain version's largest entry, with
     its achieved TFLOP/s, each of its two grids' mean device time (by
     kernel name, from ``torch.profiler``), and its bound at the 3xTF32
     tensor-core rate (three TF32 products for each of its four).  An
     empty kernel's time (``torch.cuda._sleep(0)``) is the card's launch
     floor.
     Each kernel is timed (median of 10
     launches, L2 flushed before each) beside its plain version, one
     PyTorch library call for the same function
     (``scaled_dot_product_attention`` for the LM's, its backward through
     ``torch.autograd.grad`` for the flash backward: one whole SDPA
     backward for each of the two kernels) and its bound; the flash
     kernels also report their achieved TFLOP/s (the counted flops over
     their time);
  4. three batches sampled and gathered on the card equal the CPU plain
     path's bit for bit, and four fp32 training steps on the card match
     the CPU's losses within 1e-4;
  5. the in-memory path through its entry point,
     ``repro_torch.launch.train.main``: reddit ``--large-scale``, F=602,
     hidden 256, fanouts 25,10, batch 1024, 8 steps, with the kernel
     launch counters reset just before and read just after;
  6. where the time goes: the same step timed at steady state, then
     profiled (device time by kernel, device busy share);
  7. out of core: three batches of the loader over a ``DiskStore`` (4 MB
     page cache) with a 4096-row feature cache and a 128-block edge
     cache, pinned, on the card equal the CPU plain path's bit for bit
     (ids, features, labels, every ``trace.io`` counter), and their ids
     equal the in-memory loader's on the card;
  8. the out-of-core path through its entry point: the phase-5 command
     with ``--graph-store disk --cache-mb 4 --device-cache-rows 4096
     --edge-cache-blocks 128 --device-cache-policy pinned``; 8 finite
     losses within 1e-5 of phase 5's, the cached kernels launched as
     often as the loader's chunks and segments, ``neighbor_sample`` not
     at all, ``feature_gather_rows`` 3 times a step;
  9. where the out-of-core step's time goes: the wall time of each stage
     (sample, resolve, admit, train step) with a device synchronize at
     each boundary, then a profile of two steps;
  10. serving on the card against the CPU's plain path: qwen2-0.5b's
     first 2 layers at full width (the full model's weights and scales:
     the reference scales a stacked leaf by 1/sqrt(its layers)), equal
     bf16 weights drawn on the card, batch 2, prompt 256, 8
     tokens, ``attn_impl`` flash and chunked; logits within 0.125 and the
     greedy ids equal (up to near-ties of the bf16 logits);
  11. the serving path through its entry point,
     ``repro_torch.launch.serve.main``: qwen2-0.5b ``--full-config``,
     batch 8, prompt 2048, 64 tokens, with the launch counters reset just
     before: ``flash_attention_fwd`` 24 times (one a layer in prefill),
     ``decode_attention`` 24 x 63 times, finite logits; prefill ms, decode
     ms per step and tok/s;
  12. where serving's time goes: a warm prefill and steady decode steps
     timed, then profiled (device time by kernel, device busy share);
  13. training on the card against the CPU's plain path: qwen2-0.5b's
     first 2 layers at full width, equal float32 weights, batch 1, 512
     tokens; ``attn_impl`` flash in bf16 and chunked in float32
     activations: the loss, the grad norm, each leaf's gradient (within
     0.25 relative L2 in bf16, 1e-3 in float32) and, in float32, the
     parameters after one AdamW step within stated tolerances (the bf16
     step stops at its gradients: the same update arithmetic, and a CPU
     update over a vocabulary table costs 10-20 s); the flash run's
     launches
     (forward 2 a layer, each backward kernel 1); a control, the float32
     step with TF32 products, whose grad norm or one of whose gradients
     must lie beyond the float32 limits;
  14. the training path through its entry point,
     ``repro_torch.launch.train.main``: qwen2-0.5b at full width, batch 4,
     4096 tokens (``train_4k``; its global batch of 256 cut to 4 for one
     card), 5 steps, ``--attn-impl flash``, with the launch counters reset
     just before: ``flash_attention_fwd`` 2 x 24 a step (the forward and
     its remat recompute), ``flash_attention_bwd_dq`` and
     ``flash_attention_bwd_dkv`` 24 a step, finite losses; step ms,
     tok/s and peak device memory;
  15. where a training step's time goes: steady steps timed, then one
     profiled (device time by kernel, device busy share);
  16. SSM serving on the card against the CPU's plain path: the first 2
     layers of mamba2-370m and hymba-1.5b at full width, equal bf16
     weights, batch 2, prompt 300, 8 tokens; logits within 0.125 and
     the greedy ids equal up to near-ties, as phase 10;
  17. the SSM serving paths through the entry point: ``--arch
     mamba2-370m --full-config --batch 8 --prompt-len 2048 --gen 64``
     (``ssd_chunk_scan`` 48 times, no other kernel) and ``--arch
     hymba-1.5b ... --gen 16`` (``ssd_chunk_scan`` and
     ``flash_attention_fwd`` 32 times each, ``decode_attention`` 32 x 15),
     the counters reset just before each; finite logits; prefill ms,
     decode ms per step and tok/s;
  18. where mamba2-370m's serving time goes, as phase 12;
  19. the spec files on the card: all twelve ``benchmarks/specs/*.json``
     (``smoke_pallas``, ``smoke_pallas_devcache_disk``,
     ``smoke_pallas_edgecache``, ``train_pallas_outofcore``,
     ``smoke_pallas_overlap``, ``smoke_pallas_overlap_faults`` with
     ``--steps 8``, ``smoke_pallas_optimal``, ``smoke_host``,
     ``smoke_disk_host``, ``smoke_pallas_overlap_obs`` with its files in a
     temp directory, ``smoke_pallas_isp``, the host backend over a
     spawned storage process, and ``smoke_isp``, the mesh ISP backend)
     through ``repro_torch.launch.train.main
     --spec ... --dataset reddit --steps 4``, each on the card and with
     ``--device cpu``, the model in float32 on both: finite losses within
     1e-5 of the CPU's, batch 0 of ``build_pipeline(spec)`` bit-equal
     between card and CPU, the kernels the spec implies launched (the
     cached ones where it has a device tier, ``neighbor_sample`` only
     without an edge tier, none on the host and isp backends), a
     ``DiskStore`` (or the isp store) opened where it says ``disk``, a
     whole trace where telemetry is on and, under ``optimal``, a replay
     lane without errors or timeouts;
  20. the overlapped out-of-core path at full width: phase 8's command
     with ``--io-threads 4``, once synchronously and once with
     ``--prefetch 2 --overlap 1 --stage-depth 2 --plan-ahead 2``; batches
     0-7 equal in hop ids, features, labels, per-batch kernel launches
     and the ``trace.io`` counters that do not depend on how the lanes
     interleave over the shared page cache (devcache, edgecache, faults,
     store requests and blocks touched); equal losses; the kernels
     launched from the lanes only; no lane restart and no degrade; then
     one timed run of each mode (steps/s, consumer idle, host
     seconds per stage), and both modes'
     device busy share over one profiled step;
  21. faults: ``smoke_pallas_overlap_faults.json`` (EIO, short reads,
     bit flips, stalls, verify, and a 2.5 s sample-lane stall at batch 4
     against a 1 s lane timeout) against its fault-free twin
     ``smoke_pallas_overlap.json``, 8 steps each: batches 0-7 equal (ids,
     features, labels), losses equal, at least one watchdog restart, not
     degraded, no lane failure, EIO, short-read and corrupt-block counts
     above 0; phase 8's command with ``--verify-blocks 1 --fault-seed 7
     --fault-eio 0.08 --fault-short-read 0.04 --fault-bitflip 0.04
     --io-retry-backoff 0``: losses and launches equal phase 8's, its
     steps/s beside phase 8's; phase 8's command with the feature-cache
     fetch forced to fail from batch 3 on: the bypass's one warning, no
     ``feature_gather_cached`` launch and 3 ``feature_gather_rows``
     launches in each batch after it, losses equal phase 8's;
  22. direct I/O: phase 8's command with ``--direct-io 1``: the mode the
     store's filesystem gave (``O_DIRECT``, or buffered with the store's
     warning), losses and launches equal phase 8's;
  23. resume: phase 5's command, and the chaos spec overlapped (resumed
     without ``--spec``, from the manifest's ``pipeline_spec``), 8 steps
     straight against 4 steps and ``--resume``: the logged losses of
     steps 5-8 equal; the step-8 checkpoint written on the card restored
     with ``device="cpu"`` bit-equal to the card's parameters; qwen2-0.5b
     ``--reduced --batch 4 --seq-len 128``, 8 steps against 4 and a
     resume: the final loss within 1e-3 (the reference's tolerance), and
     whether steps 5-8 are repr-equal;
  24. the Belady oracle and the host backend.  a: phase 8's command
     with ``--cache-policy optimal --cache-oracle-window 8
     --device-cache-policy optimal --device-cache-oracle-window 8``
     against the same with ``--device-cache-policy lru``: losses
     repr-equal, batches 0-7's ids equal, each tier's hits + misses
     equal, batches 0-2's ``trace.io`` equal the CPU's run of the same
     command, replay errors and timeouts 0; steps/s, misses, the cached
     kernels' launches and the replay lane's seconds a window (the
     optimal run with its replay done before training is no longer
     timed: phase 32 took its seconds).  b: the R-MAT graph out of core (4 MB page cache, a device feature tier
     sized between one batch's unique rows and the first window's union,
     no edge tier), batch 1024, fanouts 25,10, window 4, 4 steps,
     optimal against lru: losses equal, replay errors 0, the feature
     tier's and the page cache's misses under optimal no more than
     under lru.  c: the host backend at phase 5's width, 4 steps (cut
     from 8 to pay for phase 31), in memory, over the disk store with
     phase 8's page cache and with that cache optimal (one producer over
     the disk store): no kernel launched, batches 0-2's ids (and
     counters) equal the CPU's, losses within 1e-4 of a 2-step CPU run
     (float32, as phase 19), lru and
     optimal losses equal; steps/s and consumer idle beside phases 5
     and 8 (the paper's Fig. 7 comparison);
  25. telemetry: phase 20's overlapped command (4 pread threads) with and
     without ``--trace-out --metrics-out --metrics-interval 0.5``, one run
     of each in turns: losses repr-equal; each trace JSON of complete and
     metadata events only, with the ``sample``, ``resolve``, ``admit``,
     ``consume.step``, ``devcache.plan`` and ``disk.pread`` spans (a
     pread with its batch) on the ``overlap-*`` and ``consumer`` tracks;
     the last JSONL snapshot with the store's hits, misses, bytes, hit
     rate and retries and the device cache's hit rate; steps/s on and
     off and their ratio (reported, not checked);
  26. the ISP service.  a: phase 8's command with ``--store-mode isp``
     (unix socket) against the local store: 8 batches (ids, features,
     labels) and losses equal, the cached kernels launched as there,
     batches 0-2's ids, ``trace.io`` and the requests and bytes the
     client sent equal a CPU run's, the storage process exits 0; wire
     bytes beside the server's bytes from flash.  b: the host backend
     pushed down to the storage process at phase 24c's width and
     steps (one producer): no launch, losses equal 24c's local-store run, batches
     0-2 equal the CPU's, exit 0; its steps/s beside 24c's.  c:
     ``smoke_pallas_isp`` over the shm rings: losses equal the unix
     socket's, exit 0;
  27. the mesh ISP backend: phase 5's command with ``--backend isp`` at
     ``--devices 1`` and ``--devices 4`` (four shards on the one card)
     against ``--backend pallas``: losses equal (``==``), batch 0's hop
     ids and features bit-equal, no kernel launched by the isp runs;
     steps/s of the three side by side, and the peak device memory of
     each; then phase 8's command with ``--storage-engine isp``: a
     simulated storage delay above 0, losses and launches equal phase
     8's;
  28. the MoE family.  a: serving on the card against the CPU's plain
     path, the first 2 layers of moonshot-v1-16b-a3b and mixtral-8x7b at
     full width, equal bf16 weights drawn on the card, batch 2, prompt
     128, 8 tokens: the card's prefill with each layer's MoE and
     the logits also run on the CPU on equal inputs (expert ids equal but
     at near-ties of the CPU's float32 router scores, within 1e-4,
     counted; with none, keep flags and slot tables bit-equal; outputs of
     tokens routed alike within 2e-2 plus one bf16 ulp; logits within
     0.125); the tokens each layer of the two devices' own prefills
     routes apart, counted; greedy serving, the CPU fed the card's ids:
     the ids equal up to near-ties, as phase 10, and each step's logits
     reported (a token routed apart at a router near-tie moves by O(1)).
     b: ``repro_torch.launch.serve.main --arch moonshot-v1-16b-a3b
     --full-config --batch 8 --prompt-len 2048 --gen 16`` cut to 4 of
     its 48 layers, the counters reset just before:
     ``flash_attention_fwd`` 4, ``decode_attention`` 4 x 15, no other
     kernel; finite logits; the weights' draw on the
     card (s), prefill ms, decode ms per step, tok/s, peak device
     memory.  c: the same for mixtral-8x7b at full width cut to 4 layers
     (its 87.0 GiB do not fit one card): ``decode_attention`` 4 x 15, no
     flash launch (its sliding window takes the chunked prefill, as in
     the reference).  d: moonshot's first layer: its MoE
     forward and backward on equal float32 inputs, card against CPU,
     within 1e-4 relative L2, then phase 13's step card against CPU in
     both activation types at phase 13's tolerances, its TF32 control
     and its launches (both steps stop at their gradients: phase 13
     holds the AdamW update);
  29. qwen2-vl-7b and seamless-m4t-large-v2, and training the SSM
     families.  a: serving on the card against the CPU's plain path, the
     first 2 layers of qwen2-vl and the first 2 encoder and 2 decoder
     layers of seamless at full width, equal bf16 weights drawn on the
     card, batch 2, prompt 256 (qwen2-vl's ``embeds``,
     seamless's tokens and ``src_embeds``), 8 tokens: logits within
     0.125 and the greedy ids equal up to near-ties, qwen2-vl's end to
     end, seamless's in its decode steps, each run on the CPU from a
     copy of the card's cache (its attention at seed-0 weights is near
     argmax: the two prefills' bf16 rounding tips it apart, and their
     logits are reported); seamless's decode attention calls, its
     cross-attention over the source's K/V at valid_len S_src, within
     2e-2 of the plain version on their inputs, and its prefill cross
     K/V within 2 % of each layer's largest entry.  b: the serve
     entry point for qwen2-vl ``--full-config --batch 8 --prompt-len
     2048 --gen 16``, the counters reset just before:
     ``flash_attention_fwd`` 28, ``decode_attention`` 28 x 15, no other
     kernel; finite logits; the weights' draw on the card (s), prefill
     ms, decode ms per step, tok/s, peak device memory.  c: the same for
     seamless: ``flash_attention_fwd`` 24 (the decoder; the encoder and
     cross-attention take the chunked path, as in the reference),
     ``decode_attention`` 2 x 24 x 15 (self- and cross-attention).  d:
     ``SSDChunkScan``'s output and gradients on the card against autograd
     through the plain scan, float32 random inputs at mamba2's and
     hymba's layer-0 shapes cut to B 1, S 512, within 1e-4 relative L2;
     then phase 13's step card against CPU in both activation types
     (stopped at the gradients, as 28d's), its
     TF32 control and its launches for qwen2-vl's first 2 layers on an
     ``embeds`` batch (``embed``'s gradient 0 on both) and seamless's
     first 2 + 2 layers on ``make_batch(kind="train")``, both at 64
     tokens, and the first 2 layers of mamba2-370m and hymba-1.5b at
     phase 13's 512 (``ssd_chunk_scan`` 2 a layer); seamless's bf16
     step stage by stage (each encoder and decoder block, the norms, the
     embedding and the head), the CPU's backward of each stage on the
     card's inputs and output cotangent, at phase 13's tolerances.  e:
     the train entry point for mamba2-370m and hymba-1.5b at
     full width and depth, ``--batch 4 --seq-len 4096 --steps 3``:
     ``ssd_chunk_scan`` 2 a layer a step (hymba also the flash forward 2
     and each backward kernel 1 a layer a step), no other kernel; finite
     losses; step ms, tok/s, peak memory.  f: ``build_train_step`` for 3
     steps: seamless whole on ``make_batch(kind="train")`` at B 2, S 2048
     (512 source frames), qwen2-vl at full width cut to 4 layers on
     ``TokenPipeline`` tokens at B 1, S 4096 (its whole float32 state
     does not fit one card): the flash kernels' launches, finite losses,
     step ms, peak memory;
  30. the LM on a process mesh and the "dots" remat policy.  a:
     qwen2-0.5b at full width, phase 14's B 4 x S 4096, 3 steps through
     ``build_train_step`` under ``remat="full"`` and ``"dots"`` (the
     reference's ``checkpoint_dots_with_no_batch_dims``): losses within
     1e-3 relative, the flash kernels' launches (the forward recomputed
     under both), step ms and peak memory of each.  b: the train entry
     point on the data mesh: phase 14's command with ``--mesh Nx1``, N
     the card count (one process a card, NCCL; the state sharded as the
     reference's rules give), 3 steps: losses within 1e-3 relative of
     phase 14's first 3, each rank's flash launches, each rank's peak
     memory, step ms and the world size; at 2 ranks too where there are
     2 cards, and at 4 where there are 4.  c: the sequence-sharded decode
     on a (1, 2) mesh (two processes that share the one card under gloo,
     or NCCL where each has a card): qwen2-0.5b at full width, phase
     11's batch and prompt, the cache (2,066 positions) split on S; the
     greedy ids equal phase 11's first up to near-ties; the sharded
     attention on equal random inputs (a rank wholly past the position,
     a window) within DECODE_CALL_REL_TOL of the plain version's; in
     float32 activations, each decode step's logits within F32_LOGIT_TOL
     of the unsharded decode fed the same ids; in bf16 the gap to the
     unsharded decode through the kernel reported (a 1-ulp flip of a
     bf16 attention output moves the logits downstream); no
     ``decode_attention`` launch (the partials are plain ops, as the
     reference's); decode ms/step beside phase 11's and the partial
     bytes that cross a step; 16 decode steps (cut from phase 11's 63
     to pay for phase 31);
  31. tensor parallelism over the mesh's ``model`` axis, on a (1, 2)
     mesh: two processes that share the one card under gloo (phase
     30c's spawn runs the three parts after 30c's, one process start
     for both phases; phase 31's seconds are its parts' own).  a: phase 14's command with ``--mesh 1x2``,
     qwen2-0.5b at full width and depth, B cut from 4 to 2 (two ranks'
     peaks share the card), S 4096, 3 steps, against one process at the
     same shape run just before: losses within TP_LOSS_REL_TOL relative,
     each rank's peak memory beside the one process's, step ms, each
     rank's flash launches (2 forward and 1 of each backward kernel a
     layer a step).  b: prefill and 16 decode steps of qwen2-0.5b at
     phase 11's B 8 and prompt 2048 with tensor-parallel weights (7 of
     14 q heads, 1 of 2 kv heads, half of ``mlp`` and ``vocab`` a rank)
     and the sequence-sharded cache (2,066 positions, 1,033 a rank): the
     greedy ids equal phase 11's up to near-ties of one process's logits
     fed the same ids; in float32 activations each step's logits within
     F32_LOGIT_TOL of one process's plain decode fed the same ids; the
     flash forward 24 launches a rank and no decode kernel.  c: one
     layer of each, at full width, on equal bf16 inputs at B 8 x 2048
     against one process (rank 0): moonshot-v1-16b-a3b's MoE block, its
     64 experts split 32 a rank (the kept assignments and expert ids
     equal on every rank and one process; the outputs within
     TP_LAYER_REL_TOL relative L2), and mamba2-370m's mixer, its 32
     heads split 16 a rank (the SSD kernel launched once a rank at 16
     heads; the outputs within TP_LAYER_REL_TOL, the rank's block of the
     final state within TP_LAYER_REL_TOL); then moonshot's MoE block
     data-parallel on the (2, 1) mesh, 6 rows of 2048 a rank at
     ``moe_groups`` 3 (group 1 straddles the ranks; inputs that crowd
     some experts, so assignments drop), against every rank's run of all
     12 rows as one process: the kept assignments equal (expert ids
     apart only at near-ties of the scores), the aux loss, and the
     outputs within TP_LAYER_REL_TOL relative L2;
  32. the dry-run (``repro_torch.launch.dryrun``), which traces a step
     on fake tensors.  a: each LM kernel entry of ``kernels.ops`` (the
     flash forward, the flash backward's two kernels, ``decode_attention``
     and ``ssd_chunk_scan``) on fake copies of phase 3's inputs: the
     outputs' shapes, dtypes and strides equal the real launch's and the
     FLOPs ``FlopCounterMode`` counts equal the operations behind phase
     3's bounds.  b: the dry-run of phase 14's configuration (qwen2-0.5b,
     flash, B 4 x S 4096, one process): its peak-memory estimate within
     DRYRUN_PEAK_REL_TOL of phase 14's measured peak, and its bound step
     time (the largest of the three H100 roofline terms) over phase 14's
     measured step ms, the roofline fraction.  c: ``python -m
     repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k`` on
     the (16, 16) production mesh and with ``--multi-pod`` on (2, 16,
     16), and seamless-m4t-large-v2's train_4k on (2, 16, 16) at full
     width and depth (16 microbatches of 16 rows over 32 ranks: 8
     passes of 1 row a rank), in three processes started before phase 2
     (they trace on the host's CPU while the kernels and phase 3's graphs
     are built; phase 3 waits for qwen2's before it times a kernel, and
     seamless's, the longest, is stopped there and goes on only during
     the card-against-CPU checks, which time nothing: phases 4, 10, 13,
     16, 28a, 28d, 29a and 29d, then in phase 32): each exits 0 with
     ``ok``, its per-card bytes and its bound term, seamless's with its
     8 passes of 1 row;
  33. a JSON line of the kernels' numbers (the GNN's per launch, with
     their sums per step beside them; the LM's launches in phases 28's
     and 29's runs beside the serve and train entry points'), the card
     line, and the result.  Each phase's start, in seconds from the
     script's, is printed and kept in the details file.

It needs one CUDA device and exits nonzero without one.  Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint.store import \
    _flatten as flatten_state  # noqa: E402  (the files' key layout)
from repro_torch import kernels, rng  # noqa: E402
from repro_torch.core import (CacheTierSpec, GNNConfig,  # noqa: E402
                              GraphSAGE, PallasSubgraphLoader, PipelineSpec,
                              attach_features, build_pipeline,
                              build_train_step, load_dataset, rmat_graph,
                              train_loop)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.feature_gather import (  # noqa: E402
    feature_gather_cached, feature_gather_mean, feature_gather_rows)
from repro_torch.kernels.neighbor_sample import (  # noqa: E402
    edge_block_count, neighbor_sample, neighbor_sample_cached)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, valid_range)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd)
from repro_torch.kernels.ssd_chunk_scan import ssd_chunk_scan  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import rank_device, run_on_mesh  # noqa: E402
from repro_torch.launch.shapes import make_batch  # noqa: E402
from repro_torch.models.params import (init_params,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.models import moe, ssm, transformer  # noqa: E402
from repro_torch.models.layers import activation, rmsnorm  # noqa: E402
from repro_torch.models.transformer import (COMPUTE_DTYPE,  # noqa: E402
                                            LM, build_defs)
from repro_torch.train.steps import (MOE_AUX_WEIGHT,  # noqa: E402
                                     build_prefill_step, build_serve_step,
                                     cross_entropy, init_train_state)
from repro_torch.train.steps import \
    build_train_step as build_lm_train_step  # noqa: E402
from repro_torch.optim import adamw, warmup_cosine  # noqa: E402
from repro_torch.optim.adamw import (MAX_GRAD_NORM,  # noqa: E402
                                     clip_by_global_norm)
from repro_torch.storage import (DeviceEdgeBlockCache,  # noqa: E402
                                 DeviceFeatureCache, DiskStore,
                                 StoreReadError, pad_pow2, save_graph)

BATCH, FANOUTS = 1024, (25, 10)
RMAT_NODES, RMAT_EDGES = 1 << 18, 1 << 23
# the out-of-core configuration: page cache (MB), device feature rows,
# device edge blocks, device policy
OOC_CACHE_MB, OOC_ROWS, OOC_BLOCKS, OOC_POLICY = 4, 4096, 128, "pinned"
OOC_TIER = CacheTierSpec.device(rows=OOC_ROWS, edge_blocks=OOC_BLOCKS,
                                policy=OOC_POLICY)
# the spec files (phase 19); the overlapped run's flags (phase 20) and
# the timed runs of each mode
PORTED_SPECS = ("smoke_pallas", "smoke_pallas_devcache_disk",
                "smoke_pallas_edgecache", "train_pallas_outofcore",
                "smoke_pallas_overlap", "smoke_pallas_overlap_faults",
                "smoke_pallas_optimal", "smoke_host", "smoke_disk_host",
                "smoke_pallas_overlap_obs", "smoke_pallas_isp", "smoke_isp")
SPEC_STEPS = 4
# the chaos spec (faults, verify, a 2.5 s sample-lane stall at batch 4
# against a 1 s lane timeout) and its fault-free twin, 8 steps each
# (phases 19, 21, 23: the stall needs batch 4)
CHAOS_SPEC, CHAOS_TWIN, CHAOS_STEPS = ("smoke_pallas_overlap_faults",
                                       "smoke_pallas_overlap", 8)
# phase 21: the chaos spec's EIO, short-read and bit-flip mix on phase 8's
# command (no stalls: ~10,000 edge-block preads a step at a 0.01 stall
# rate would stall ~12 s a step), and the bypass run's healthy fetches
# before the forced failure
FAULT_FLAGS = ["--verify-blocks", "1", "--fault-seed", "7", "--fault-eio",
               "0.08", "--fault-short-read", "0.04", "--fault-bitflip",
               "0.04", "--io-retry-backoff", "0"]
BYPASS_AFTER = 3
FAULT_COUNTERS = ("io_errors", "short_reads", "corrupt_blocks", "retries",
                  "timeouts")
# phase 23: resume at step 4 of 8, and the reduced LM's batch and sequence
# (the flash kernels are deterministic, so its resumed steps are held
# repr-equal, as the GNN's)
RESUME_AT, RESUME_STEPS = 4, 8
LM_RESUME_ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--batch", "4",
                  "--seq-len", "128", "--log-every", "1"]
GNN_KERNELS = ("neighbor_sample", "neighbor_sample_cached",
               "feature_gather_rows", "feature_gather_cached")
OVERLAP_FLAGS = ["--prefetch", "2", "--overlap", "1", "--stage-depth", "2",
                 "--plan-ahead", "2"]
# one timed run a mode (three until the script outgrew its time limit
# with phase 30)
OVERLAP_RUNS = ("sync", "overlap")
# the pread pool sizes timed: the checked configuration's 4 (1, phase
# 8's, was timed too until the script outgrew its time limit)
PREAD_THREADS = (4,)
# phase 24: the Belady oracle on phase 8's command (window 8), on the
# R-MAT graph out of core (window 4, 4 steps), and the host backend at
# phase 5's width (8 steps on the card, 2 on the CPU; batches 0-2
# compared)
ORACLE_FLAGS = ["--cache-policy", "optimal", "--cache-oracle-window", "8",
                "--device-cache-policy", "optimal",
                "--device-cache-oracle-window", "8"]
RMAT_WINDOW, RMAT_STEPS = 4, 4
HOST_CPU_STEPS, HOST_COMPARED = 2, 3
# phase 24c's runs: 4 steps each (cut from 8 to pay for phase 31; the
# host backend's optimal run takes ~2 s a step on the card host)
HOST_STEPS = 4
# phase 25: phase 20's overlapped command with telemetry on and off, one
# run of each, and the JSONL snapshot interval; the spans and
# lane tracks the trace must hold, and the metrics its last snapshot must
OBS_RUNS = ("off", "on")
OBS_INTERVAL = 0.5
OBS_SPANS = ("sample", "resolve", "admit", "consume.step", "devcache.plan",
             "disk.pread")
OBS_LANES = ("overlap-sample", "overlap-resolve", "overlap-admit",
             "consumer")
OBS_METRICS = ("store.hits", "store.misses", "store.bytes_fetched",
               "store.hit_rate", "devcache.hit_rate", "store.faults.retries")
# phase 26: the ISP service's spec, and the longest AF_UNIX socket path
ISP_SPEC = "smoke_pallas_isp"
UNIX_PATH_MAX = 107
DEVICE = "cuda"
# LM serving: the arch, the entry point's batch, prompt and generation,
# and the card-vs-CPU parity run (the first PARITY_LAYERS layers)
LM_ARCH = "qwen2-0.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 64
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT, PARITY_GEN = 2, 2, 256, 8
# LM training: the entry point's batch, tokens and steps (launch/shapes.py's
# train_4k, its global batch of 256 cut to 4 for one card), and the
# card-vs-CPU parity run (the first PARITY_LAYERS layers)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 5
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 1, 512
# attention kernels against their plain versions: bf16 outputs within a
# few bf16 ulps at |out| < 4, the float32 logsumexp within 1e-3
ATTN_OUT_TOL, LSE_TOL = 2e-2, 1e-3
# the flash backward's bf16 dq, dk and dv within 1 % of the plain
# version's largest |entry|: both kernels round an operand of their last
# tensor-core products to bf16 (dS before dS.K for dq, P^T and dS^T before
# the dV and dK products), about 2**-9 of the largest entry, and round
# their float32 sums to bf16 at the end, up to 2**-8 more
# (tests/test_torch_flash_precision.py emulates both on the CPU).  The
# float32 delta, exact products summed in another order, within 1e-4 of
# the largest; the library's backward, which keeps p and ds in bf16,
# within 10 % (a yardstick only)
GRAD_REL_TOL, DELTA_REL_TOL, LIB_GRAD_REL_TOL = 1e-2, 1e-4, 0.1
# card vs CPU training (phase 13).  In bf16 both round their activations
# apart (as the reference and the port do on the CPU, where
# tests/test_torch_lm_train.py states the same loss tolerance): the loss
# within 5e-3, the grad norm within 2 %, each leaf's gradient within 0.25
# relative L2 (the ill-conditioned query/key path moves most).  In
# float32 they differ in the order of their sums only: the loss and the
# grad norm within 1e-4 relative, each gradient within 1e-3 relative L2
# (the float32 steps of phases 13, 28d and 29d read up to 4.6e-4, their
# TF32 twins at least 1.9e-3: mamba2-370m's, whose scan is 3xTF32
# either way).  The TF32 control: the card's float32 step with TF32
# products must fail the float32 limits, in its grad norm or in a leaf's
# gradient
TRAIN_LOSS_TOL, GRAD_NORM_REL_TOL, TRAIN_GRAD_L2_TOL = 5e-3, 2e-2, 0.25
F32_TRAIN_REL_TOL, F32_GRAD_L2_TOL = 1e-4, 1e-3
# card vs CPU logits of the serving parity run: the logits are computed in
# bf16 (magnitude 4-8, one ulp 1/32) from activations that round apart
# on the two devices; 4 ulps
LOGIT_TOL = 0.125
# a decode attention call of the LM's decode step (phase 29a) against the
# plain version on its inputs: within 2**-6 of the largest |value| the
# call reads, two to four bf16 ulps at that magnitude (the kernel rounds
# its probabilities to bf16 for the PV product, 2**-9 of the largest
# value, and both round the output to bf16); a wrong valid_len or cache
# length moves the output by O(|value|)
DECODE_CALL_REL_TOL = 2**-6
# card vs CPU bf16 cache entries (the cross K/V of phase 29a), per layer:
# within 2 % of the largest entry, as tests/test_torch_lm.py holds the
# reference's
CACHE_REL_TOL = 0.02
# the MoE family (phase 28): moonshot-v1-16b-a3b through the serve entry
# point at full width with MOE_GEN tokens, mixtral-8x7b at full width cut
# to MIXTRAL_LAYERS layers (the whole model's 87.0 GiB does not fit one
# card); both at their first PARITY_LAYERS layers for the card-vs-CPU
# runs.  moonshot's attention is 16 query over 16 kv heads (group 1), D
# 128
MOE_ARCH, MIXTRAL = "moonshot-v1-16b-a3b", "mixtral-8x7b"
MOE_GEN, MIXTRAL_LAYERS = 16, 4
# moonshot through the serve entry point at full width cut to
# MOE_SERVE_LAYERS of its 48 layers (its whole 52.3 GiB served, the
# script would pass its time limit)
MOE_SERVE_LAYERS = 4
# moonshot's card-vs-CPU training step (28d) on its first layer (two
# until the script outgrew its time limit: its CPU step and AdamW over
# a 1.8 B-parameter tree took ~100 s on the card host)
MOE_TRAIN_LAYERS = 1
# qwen2-vl-7b (M-RoPE, embedding inputs; 28 query over 4 kv heads, D 128)
# and seamless-m4t-large-v2 (the encdec family; 16 over 16, D 64), phase
# 29: served whole with MM_GEN tokens, their first PARITY_LAYERS layers
# (of both stacks) card against CPU at MM_PARITY_PROMPTS; seamless
# trained whole through build_train_step at B 2, S 2048 (512 source
# frames), qwen2-vl at full width cut to VL_TRAIN_LAYERS layers at B 1, S
# 4096 (its whole float32 state, ~122 GB, does not fit one card), each
# MM_TRAIN_STEPS steps; mamba2-370m and hymba-1.5b trained whole through
# the entry point at SSM_TRAIN_*; SSDChunkScan's gradients on the card at
# each SSM arch's layer-0 shapes cut to B 1, S SSD_GRAD_SEQ, within
# SSD_GRAD_REL_TOL relative L2 of autograd through the plain scan
VL_ARCH, ENCDEC_ARCH = "qwen2-vl-7b", "seamless-m4t-large-v2"
MM_GEN = 16
MM_PARITY_PROMPTS = (256,)
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 2, 2048
VL_TRAIN_LAYERS, VL_TRAIN_BATCH, VL_TRAIN_SEQ = 4, 1, 4096
MM_TRAIN_STEPS = 3
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 4, 4096, 3
SSD_GRAD_SEQ, SSD_GRAD_REL_TOL = 512, 1e-4
# qwen2-vl's and seamless's card-vs-CPU training steps (29d) take 64
# tokens, an eighth of phase 13's, to keep the script in its time limit:
# their CPU steps (an AdamW update over 1.5 B parameters, bf16 products at
# their widths and vocabularies) take most of phase 29
MM_TRAIN_PARITY_SEQ = 64
# phase 30: "dots" against "full" at phase 14's shape, and the train
# entry point on the data mesh, DOTS_STEPS steps each, losses within
# MESH_LOSS_REL_TOL relative (the same products in another grouping)
DOTS_STEPS, MESH_LOSS_REL_TOL = 3, 1e-3
# phase 30c's decode steps, cut from phase 11's 63 to 16 to pay for
# phase 31 (the cache 2,066 positions: the prompt, 17 tokens and 1 more,
# so that the model axis divides it)
SHARDED_GEN = 17
SHARDED_CACHE = SERVE_PROMPT + SHARDED_GEN + 1
# phase 31: tensor parallelism on the (1, 2) mesh.  a: phase 14's
# command at B 2 (cut from 4: two ranks' peaks share the one card), its
# losses within TP_LOSS_REL_TOL relative of one process's at that shape
# (the row-parallel products' two bf16 partials are rounded before their
# sum); c: one layer of moonshot and of mamba2 on equal inputs, within
# TP_LAYER_REL_TOL relative L2 of one process's (the same rounding)
TP_TRAIN_BATCH, TP_LOSS_REL_TOL = 2, 2e-3
TP_LAYER_REL_TOL = 1e-2
TP_LAYER_ARCHS = (MOE_ARCH, "mamba2-370m")
# 31c's data-parallel case: moonshot's MoE layer on the (2, 1) mesh, 6
# rows of 2048 a rank at 3 dispatch groups (group 1 straddles the ranks),
# held against one process's run of all 12 rows within TP_LAYER_REL_TOL;
# its inputs share an offset of DP_MOE_SKEW standard deviations, so that
# the router crowds some experts past their capacity (a quarter of the
# assignments dropped) and each part's offset decides what is kept
DP_MOE_ROWS, DP_MOE_GROUPS, DP_MOE_SKEW = 6, 3, 0.5
# 31b's decode steps in float32 activations (30c's 8 halved: the phase's
# time)
TP_F32_STEPS = 4
# phase 30c in float32 activations: the sharded decode's logits against
# the unsharded decode's (the same float32 arithmetic summed in another
# order through 24 layers, ~1e-5 relative at logits of magnitude ~5; a
# wrong slice or mask moves them by O(1))
F32_LOGIT_TOL = 1e-3
F32_DECODE_STEPS = 8
# flash forward cases (B, S, Hq, Hkv, D), causal: qwen2-0.5b's prefill at
# the entry point's shape first, then head dims 128 and 256, a ragged S,
# moonshot's prefill at its entry point's shape, qwen2-vl's and
# seamless's (phase 29), and qwen2-0.5b's prefill on one rank of the
# (1, 2) mesh (phase 31b: 7 q heads over 1 kv head)
FLASH_CASES = [(SERVE_BATCH, SERVE_PROMPT, 14, 2, 64), (1, 2048, 32, 8, 128),
               (2, 1024, 4, 1, 256), (SERVE_BATCH, 1000, 14, 2, 64),
               (SERVE_BATCH, SERVE_PROMPT, 16, 16, 128),
               (SERVE_BATCH, SERVE_PROMPT, 28, 4, 128),
               (SERVE_BATCH, SERVE_PROMPT, 16, 16, 64),
               (SERVE_BATCH, SERVE_PROMPT, 7, 1, 64)]
# flash backward cases (B, S, Hq, Hkv, D, causal): qwen2-0.5b's training
# step at the entry point's shape first, then head dims 128 and 256, a
# ragged S, a full (non-causal) case, moonshot's training-parity step
# (group 1), qwen2-vl's training step (phase 29f) and qwen2-0.5b's step on
# one rank of the (1, 2) mesh (phase 31a)
FLASH_BWD_CASES = [(TRAIN_BATCH, TRAIN_SEQ, 14, 2, 64, True),
                   (1, 2048, 32, 8, 128, True), (2, 1024, 4, 1, 256, True),
                   (TRAIN_BATCH, 1000, 14, 2, 64, True),
                   (1, 1000, 14, 2, 64, False),
                   (TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ, 16, 16, 128, True),
                   (VL_TRAIN_BATCH, VL_TRAIN_SEQ, 28, 4, 128, True),
                   (TP_TRAIN_BATCH, TRAIN_SEQ, 7, 1, 64, True)]
# decode cases: qwen2-0.5b's cache at the entry point's shape, (valid_len,
# window); the full cache without a window stands for a decode step; and
# moonshot's 2,064-position cache at its last decode step
DECODE_SHAPE = (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, 14, 2, 64)
DECODE_CASES = [(v, w) for v in (1, 1000, SERVE_PROMPT + SERVE_GEN)
                for w in (0, 512)]
MOE_DECODE_SHAPE = (SERVE_BATCH, SERVE_PROMPT + MOE_GEN, 16, 16, 128)
MOE_DECODE_VALID = SERVE_PROMPT + MOE_GEN - 1
# phase 29's decode caches (shape, valid_len, window): qwen2-vl's
# 2,064-position cache at its last decode step, and seamless's cross K/V
# over its 512 source frames, read whole
MM_DECODE_CASES = [((SERVE_BATCH, SERVE_PROMPT + MM_GEN, 28, 4, 128),
                    SERVE_PROMPT + MM_GEN - 1, 0),
                   ((SERVE_BATCH, SERVE_PROMPT // 4, 16, 16, 64),
                    SERVE_PROMPT // 4, 0)]
# the MoE card-vs-CPU serving runs' prompts; a near-tie of the float32
# router scores: where the card and the CPU route a token to different
# experts on equal inputs, the CPU scores the two within this of each
# other (their float32 sums differ in order only, ~1e-5 at moonshot's
# logits); layer 0's MoE output on equal inputs, on the tokens routed
# alike, within MOE_OUT_ATOL plus one bf16 ulp (2**-7) of the entry; its
# float32 forward and backward on equal inputs within MOE_GRAD_REL_TOL
# (relative L2 of the output and of each gradient)
MOE_PARITY_PROMPTS = (128,)
ROUTER_TIE_TOL = 1e-4
MOE_OUT_ATOL = 2e-2
MOE_GRAD_REL_TOL = 1e-4
# SSM and hybrid serving: the archs and the entry point's generation length
# (batch and prompt as above); the card-vs-CPU parity run's prompts (300
# pads to the chunk of 256); the SSD kernel's y and final state within
# 1e-4 of the plain version's largest entry (both float32, sums in
# another order); its group case (b, s, h, p, g, n, chunk) on seeded
# random inputs
SSM_GEN = {"mamba2-370m": SERVE_GEN, "hymba-1.5b": 16}
SSM_PARITY_PROMPTS = (300,)
SSD_REL_TOL = 1e-4
SSD_GROUP_CASE = (1, 512, 8, 64, 2, 64, 256)
SSD_RAGGED_CASES = ((2, 96, 6, 24, 3, 40, 32), (1, 300, 4, 100, 2, 72, 100))
# mamba2-370m's mixer on one rank of the (1, 2) mesh (phase 31c): 16 of
# its 32 heads at B 8 x 2048, one group
SSD_TP_CASE = (SERVE_BATCH, SERVE_PROMPT, 16, 64, 1, 128, 256)
# phase 32b: the dry-run's peak-memory estimate of phase 14's step within
# this of phase 14's measured peak (the prediction in PERF.md);
# phase 32c's cells (arch, mesh) each end within DRYRUN_CELL_TIMEOUT_S;
# DRYRUN_SIDE_ARCH's 16 microbatches outnumber a rank's rows on 2x16x16
DRYRUN_PEAK_REL_TOL = 0.10
DRYRUN_CELL_TIMEOUT_S = 600
DRYRUN_SIDE_ARCH = "seamless-m4t-large-v2"
DRYRUN_CELLS = ((LM_ARCH, "16x16"), (LM_ARCH, "2x16x16"),
                (DRYRUN_SIDE_ARCH, "2x16x16"))
# H100 SXM data sheet: HBM bandwidth, the float32 rate outside the tensor
# cores (used for the kernels' scalar integer and float work), the dense
# bf16 tensor-core rate (the attention kernels' bf16 inputs) and the dense
# TF32 one (the SSD kernel's 3xTF32 products)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
REPLACES = {
    "neighbor_sample": "src/repro/kernels/neighbor_sample.py:104",
    "feature_gather_rows": "src/repro/kernels/feature_gather.py:106",
    "feature_gather_mean": "src/repro/kernels/feature_gather.py:90",
    "neighbor_sample_cached": "src/repro/kernels/neighbor_sample.py:197",
    "feature_gather_cached": "src/repro/kernels/feature_gather.py:146",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:78",
    "flash_attention_bwd_dq": "src/repro/kernels/flash_attention.py:147",
    "flash_attention_bwd_dkv": "src/repro/kernels/flash_attention.py:116",
    "decode_attention": "src/repro/kernels/decode_attention.py:72",
    "ssd_chunk_scan": "src/repro/kernels/ssd_chunk_scan.py:73",
}
SOURCES = {
    "neighbor_sample": "src/repro_torch/csrc/neighbor_sample.cu",
    "feature_gather_rows": "src/repro_torch/csrc/feature_gather.cu",
    "feature_gather_mean": "src/repro_torch/csrc/feature_gather.cu",
    "neighbor_sample_cached": "src/repro_torch/csrc/neighbor_sample.cu",
    "feature_gather_cached": "src/repro_torch/csrc/feature_gather.cu",
    "flash_attention_fwd": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
    "ssd_chunk_scan": "src/repro_torch/csrc/ssd_chunk_scan.cu",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median time of a call on the card over ``reps`` launches after a
    warm-up, by CUDA events.  A 256 MB buffer is rewritten before each
    launch: no launch finds the previous one's data in L2, and the card
    stays busy (~0.1 ms) while the host enqueues the call, so the events
    time the device's work rather than the host's launch overhead."""

    def __init__(self, reps: int = 10, warmup: int = 3):
        self.reps, self.warmup = reps, warmup
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=DEVICE)

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        pairs = []
        for _ in range(self.reps):
            self.flush_l2()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def flush_l2(self) -> None:
        self.flush.zero_()


def bound_ms(nbytes: float, ops: float, ops_per_s: float = SCALAR_OPS_PER_S
             ) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate for their type, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def flash_fwd_ops(B: int, S: int, Hq: int, D: int) -> int:
    """The causal flash forward's operations: its two products over the
    (S x S) / 2 visible pairs, 2 * B * Hq * S^2 * D."""
    return 2 * B * Hq * S * S * D


def flash_product(B: int, S: int, Hq: int, D: int, causal: bool) -> int:
    """One (B, Hq) x pairs x D product of the flash backward: the dQ
    kernel does 3 of them, the dK/dV kernel 4."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2 * B * Hq * pairs * D


def decode_ops(B: int, Hq: int, D: int, lo: int, hi: int) -> int:
    """decode_attention's operations over the valid keys [lo, hi)."""
    return 4 * B * Hq * (hi - lo) * D


def ssd_products(b: int, s: int, h: int, p: int, g: int, n: int,
                 chunk: int) -> int:
    """The SSD scan's four products (C.B^T once per group, the scored x
    per head on each chunk's i >= j half, the chunk states and the
    inter-chunk term); the kernel does each three times (3xTF32)."""
    nc = s // chunk
    pairs = chunk * (chunk + 1) // 2
    return b * nc * (g * 2 * pairs * n + h * (2 * pairs * p + 4 * chunk * p * n))


def launch_floor_ms(timer) -> float:
    """The card's floor for one launch: ``torch.cuda._sleep(0)``, a one-
    thread kernel that spins for no cycles, under the kernels' timer."""
    return timer(lambda: torch.cuda._sleep(0))


def n_unique(x: torch.Tensor) -> int:
    return int(torch.unique(x).numel())


def sample_bound(ip, targets, rand) -> tuple[float, str]:
    """neighbor_sample's bound at (M, S): what this data needs, each
    distinct offset and sampled entry once, plus targets and rand read and
    the output written."""
    M, S = rand.shape
    t = targets.long()
    deg = ip[t + 1] - ip[t]
    pos = (ip[t].long()[:, None]
           + torch.remainder(rand.long(), deg.clamp_min(1).long()[:, None]))
    nbytes = (4 * n_unique(torch.cat([t, t + 1])) + 4 * M + 8 * M * S
              + 4 * n_unique(pos[deg > 0]))
    return bound_ms(nbytes, 8 * M * S)


def sample_case(loader, timer, targets, rand):
    """neighbor_sample at (M, S): kernel == plain bit for bit, timed."""
    ip, ix = loader.indptr, loader.indices
    got = neighbor_sample(ip, ix, targets, rand)
    want = ref.neighbor_sample(ip, ix, targets, rand)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"neighbor_sample {tuple(rand.shape)} "
          "differs from its plain version")
    b, by = sample_bound(ip, targets, rand)
    return got, {
        "shape": list(rand.shape), "max_abs_err": 0.0,
        "ms": timer(lambda: neighbor_sample(ip, ix, targets, rand)),
        "plain_ms": timer(lambda: ref.neighbor_sample(ip, ix, targets, rand)),
        "library_ms": None, "bound_ms": b, "bound_by": by}


def rows_case(loader, timer, ids):
    """feature_gather_rows at R rows: kernel == plain bit for bit."""
    tab = loader.features
    got = feature_gather_rows(tab, ids)
    want = ref.feature_gather_rows(tab, ids)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"feature_gather_rows R={ids.shape[0]} "
          "differs from its plain version")
    R, F = ids.shape[0], tab.shape[1]
    ids64 = ids.long()
    b, by = bound_ms(4 * R + 4 * F * (n_unique(ids) + R), 0)
    return {"shape": [R, F], "max_abs_err": 0.0,
            "ms": timer(lambda: feature_gather_rows(tab, ids)),
            "plain_ms": timer(lambda: ref.feature_gather_rows(tab, ids)),
            "library_ms": timer(lambda: torch.index_select(tab, 0, ids64)),
            "bound_ms": b, "bound_by": by}


def mean_bound(tab, ids2d) -> tuple[float, str]:
    """feature_gather_mean's bound at (M, K): the ids and each distinct
    row read once, the output written; an add and a divide per element
    read."""
    (M, K), F = ids2d.shape, tab.shape[1]
    return bound_ms(4 * M * K + 4 * F * (n_unique(ids2d) + M), 2 * M * K * F)


def mean_case(loader, timer, ids2d):
    """feature_gather_mean at (M, K): kernel == plain bit for bit (the
    plain version's k-order sum of true divisions by a divisor tensor)."""
    tab = loader.features
    got = feature_gather_mean(tab, ids2d)
    want = ref.feature_gather_mean(tab, ids2d)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bit_equal(got, want),
          f"feature_gather_mean {tuple(ids2d.shape)} differs from its plain "
          f"version (max abs {err:g})")
    (M, K), F = ids2d.shape, tab.shape[1]
    flat = ids2d.reshape(-1).long()
    b, by = mean_bound(tab, ids2d)
    return {"shape": [M, K, F], "max_abs_err": err,
            "ms": timer(lambda: feature_gather_mean(tab, ids2d)),
            "plain_ms": timer(lambda: ref.feature_gather_mean(tab, ids2d)),
            "library_ms": timer(lambda: torch.index_select(tab, 0, flat)
                                .view(M, K, F).mean(1)),
            "bound_ms": b, "bound_by": by}


def block_cache(loader, frontiers):
    """An edge-block cache for ``frontiers``: every block their targets
    reach (and the padding pair 0, 1) resident at a permuted slot, the
    other entries of the slot table at -1."""
    ip, ix = loader.indptr, loader.indices
    block_e = ops.edge_block_size(loader.max_degree)
    nb = edge_block_count(ix.shape[0], block_e)
    max_block = nb - 2
    b0 = torch.clamp(torch.cat([ip[f.long()] for f in frontiers]).long()
                     // block_e, max=max_block)
    reached = torch.unique(torch.cat([b0, b0 + 1, torch.tensor(
        [0, 1], device=ip.device)]))
    padded = torch.zeros(nb * block_e, dtype=torch.int32, device=ip.device)
    padded[:ix.shape[0]] = ix
    gen = torch.Generator(device="cpu").manual_seed(1)
    slots = torch.randperm(reached.numel(), generator=gen).to(ip.device)
    cache = torch.empty((reached.numel(), block_e), dtype=torch.int32,
                        device=ip.device)
    cache[slots] = padded.view(nb, block_e)[reached]
    block_slots = torch.full((nb + 1,), -1, dtype=torch.int32,
                             device=ip.device)
    block_slots[reached] = slots.to(torch.int32)
    return cache, block_slots, block_e, max_block


def cached_sample_case(loader, timer, targets, rand, bc, uncached, count):
    """neighbor_sample_cached at (M, S): kernel == plain == the uncached
    kernel's ids, bit for bit, timed; ``count`` launches of it a step."""
    cache, block_slots, block_e, max_block = bc
    ip = loader.indptr
    kw = dict(block_e=block_e, max_block=max_block)
    got = neighbor_sample_cached(ip, block_slots, targets, rand, cache, **kw)
    want = ref.neighbor_sample_cached(ip, block_slots, targets, rand, cache,
                                      **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and torch.equal(got, uncached),
          f"neighbor_sample_cached {tuple(rand.shape)} differs from its "
          "plain version or from neighbor_sample")
    M, S = rand.shape
    t = targets.long()
    start = ip[t].long()
    deg = ip[t + 1].long() - start
    b = torch.clamp(start // block_e, max=max_block)
    local = (start - b * block_e)[:, None] + torch.remainder(
        rand.long(), deg.clamp_min(1)[:, None])
    blk = (b[:, None] + local // block_e)[deg > 0]
    pos = (block_slots[blk].long() * block_e + (local % block_e)[deg > 0])
    # what this data needs: each distinct offset, slot entry and sampled
    # cache entry once, plus targets and rand read and the output written
    nbytes = (4 * n_unique(torch.cat([t, t + 1])) + 4 * M + 8 * M * S
              + 4 * n_unique(blk) + 4 * n_unique(pos))
    bnd, by = bound_ms(nbytes, 10 * M * S)
    return {"shape": [M, S], "max_abs_err": 0.0, "count": count,
            "ms": timer(lambda: neighbor_sample_cached(
                ip, block_slots, targets, rand, cache, **kw)),
            "plain_ms": timer(lambda: ref.neighbor_sample_cached(
                ip, block_slots, targets, rand, cache, **kw)),
            "library_ms": None, "bound_ms": bnd, "bound_by": by}


def cached_rows_case(timer, cache, slot_of, ids, count):
    """feature_gather_cached at R ids: kernel == plain bit for bit, timed
    beside ``index_select`` of the looked-up slots."""
    got = feature_gather_cached(cache, slot_of, ids)
    want = ref.feature_gather_cached(cache, slot_of, ids)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"feature_gather_cached R={ids.shape[0]} "
          "differs from its plain version")
    R, F = ids.shape[0], cache.shape[1]
    bnd, by = bound_ms(4 * R + 4 * n_unique(ids) + 4 * F * (n_unique(ids) + R),
                       0)
    return {"shape": [R, F], "max_abs_err": 0.0, "count": count,
            "ms": timer(lambda: feature_gather_cached(cache, slot_of, ids)),
            "plain_ms": timer(lambda: ref.feature_gather_cached(
                cache, slot_of, ids)),
            "library_ms": timer(lambda: torch.index_select(
                cache, 0, slot_of[ids].clamp_min(0).long())),
            "bound_ms": bnd, "bound_by": by}


def gather_cache(g, loader, ids_all):
    """A feature cache holding the batch's unique ids at permuted slots:
    (cache, slot_of, the unique ids on the host)."""
    uniq = torch.unique(ids_all)
    U = uniq.numel()
    gen = torch.Generator(device="cpu").manual_seed(2)
    slots = torch.randperm(U, generator=gen).to(uniq.device)
    cache = torch.empty((U, g.feat_dim), dtype=torch.float32,
                        device=uniq.device)
    cache[slots] = loader.features[uniq.long()]
    slot_of = torch.full((g.num_nodes + 1,), -1, dtype=torch.int32,
                         device=uniq.device)
    slot_of[uniq.long()] = slots.to(torch.int32)
    return cache, slot_of, uniq.cpu().numpy()


def ooc_plan(g, t, flat1, uniq):
    """What phase 8's out-of-core step launches for a batch whose hop
    frontiers are ``t`` and ``flat1`` and whose unique ids are ``uniq``:
    the (hop, slice) chunks that a ``OOC_BLOCKS``-block ``OOC_POLICY``
    edge-block cache's plan cuts each frontier into (one
    ``neighbor_sample_cached`` launch each), and the id segments that a
    ``OOC_ROWS``-row feature cache's plan cuts the padded unique ids into
    (one ``feature_gather_cached`` launch each, at its own length)."""
    ec = DeviceEdgeBlockCache(
        g, indptr=np.asarray(g.indptr, np.int64),
        block_e=ops.edge_block_size(int(g.degrees().max())),
        blocks=OOC_BLOCKS, policy=OOC_POLICY,
        pinned_fraction=OOC_TIER.pinned_fraction, device="cpu")
    chunks = [(hop, sl) for hop, f in enumerate((t, flat1))
              for sl, _ in ec.plan(f.cpu().numpy())]
    dc = DeviceFeatureCache(
        g, rows=OOC_ROWS, policy=OOC_POLICY,
        pinned_fraction=OOC_TIER.pinned_fraction, device="cpu")
    plan = dc.plan_rows(pad_pow2(uniq, uniq[-1]), n_valid=uniq.size)
    return chunks, [ps.ids for ps in plan.segments]


def cached_rows_cases(timer, gc, segments) -> list:
    """feature_gather_cached on the batch's unique ids through ``gc``
    (``gather_cache``): once at the padded unique-id length (a count-0
    yardstick, not a launch of the step), then at each distinct length of
    the feature cache's ``segments``, counted as often as the step
    launches it."""
    cache, slot_of, uniq = gc
    by_len: dict[int, list] = {}
    for seg in segments:
        by_len.setdefault(seg.size, [seg, 0])[1] += 1

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=DEVICE)

    cases = [cached_rows_case(timer, cache, slot_of,
                              dev(pad_pow2(uniq, uniq[-1])), 0)]
    for n, (seg, count) in sorted(by_len.items()):
        cases.append(cached_rows_case(timer, cache, slot_of, dev(seg), count))
    return cases


def cached_sample_cases(g, loader, timer, hops, rands, outs, chunks) -> list:
    """neighbor_sample_cached through a cache holding every block the
    batch reaches: at each hop's whole frontier (count-0 yardsticks, the
    widths of the in-memory step) and at each planned chunk (count 1: the
    out-of-core step's launches)."""
    bc = block_cache(loader, hops)
    cases = [cached_sample_case(loader, timer, f, r, bc, o, 0)
             for f, r, o in zip(hops, rands, outs)]
    for hop, sl in chunks:
        cases.append(cached_sample_case(loader, timer, hops[hop][sl],
                                        rands[hop][sl], bc, outs[hop][sl], 1))
    del bc
    return cases


def _degree0_tail_graph():
    """Neighbour lists 100, 128, 28, 0, 0 (256 edges: two 128-wide blocks,
    so the degree-0 tail targets' base block is clamped) on the card."""
    degs = [100, 128, 28, 0, 0]
    indptr = torch.zeros(len(degs) + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(torch.tensor(degs), 0)
    gen = torch.Generator(device="cpu").manual_seed(11)
    indices = torch.randint(0, len(degs), (256,), generator=gen,
                            dtype=torch.int32)
    return indptr.to(DEVICE), indices.to(DEVICE)


def cached_edge_inputs(reddit_loader) -> tuple[list, list]:
    """The cached kernels' edge cases on the card.  The sampler's, as
    (indptr, indices, block_slots, targets, rand, cache, block_e,
    max_block), ``indices`` None where a block is unresolved: widths off
    the block size, M 1, fanout 1, slot tables at and above the
    shared-memory budget (reddit, every block resident), degree-0 tail
    targets and an unresolved slot (``_degree0_tail_graph``).  The
    gather's, as (cache, slot_of, ids): 1, 13 and 1001 rows (rows a block
    does not divide) at permuted (odd and even) slots with an unresolved
    id, at F 602, 100 and 7 (the float2, float4 and scalar instances)."""
    from repro_torch.kernels.neighbor_sample import SLOT_BUDGET
    gen = torch.Generator(device="cpu").manual_seed(5)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(DEVICE)

    samples = []
    ip, ix = reddit_loader.indptr, reddit_loader.indices
    n = reddit_loader.g.num_nodes
    cache, block_slots, block_e, max_block = block_cache(reddit_loader, (
        torch.arange(n, dtype=torch.int32, device=DEVICE),))
    budget = SLOT_BUDGET - block_slots.numel()
    for M, S, extra in ((1, 1, 0), (1, 25, 0), (3, 25, 0), (113, 10, 0),
                        (113, 1, 0), (1000, 7, 0), (113, 10, budget),
                        (113, 10, budget + 1)):
        slots = torch.cat([block_slots, torch.full(
            (extra,), -1, dtype=torch.int32, device=DEVICE)])
        samples.append((ip, ix, slots, randint(0, n, (M,)),
                        randint(-2**31, 2**31 - 1, (M, S)), cache, block_e,
                        max_block))
    ip, ix = _degree0_tail_graph()
    tail = types.SimpleNamespace(indptr=ip, indices=ix, max_degree=128)
    cache, block_slots, block_e, max_block = block_cache(tail, (
        torch.arange(5, dtype=torch.int32, device=DEVICE),))
    targets = torch.tensor([4, 2, 3, 0, 1, 4], dtype=torch.int32,
                           device=DEVICE)
    rand = randint(-2**31, 2**31 - 1, (6, 7))
    dropped = block_slots.clone()
    dropped[1] = -1                  # nodes 1 and 2 reach into block 1
    for slots, indices in ((block_slots, ix), (dropped, None)):
        samples.append((ip, indices, slots, targets, rand, cache, block_e,
                        max_block))

    gathers = []
    for F in (602, 100, 7):
        C = 64
        cache = torch.randn((C, F), generator=gen).to(DEVICE)
        slot_of = torch.full((3 * C + 1,), -1, dtype=torch.int32)
        resident = torch.randperm(3 * C, generator=gen)[:C]
        slot_of[resident] = torch.randperm(C, generator=gen).to(torch.int32)
        slot_of = slot_of.to(DEVICE)
        for R in (1, 13, 1001):
            ids = resident[torch.randint(0, C, (R,), generator=gen)]
            ids[R // 2] = int(torch.nonzero(slot_of[:3 * C] < 0)[0])
            gathers.append((cache, slot_of, ids.to(torch.int32).to(DEVICE)))
    return samples, gathers


def cached_edge_cases(reddit_loader) -> dict:
    """The cached kernels at ``cached_edge_inputs``, bit-equal to their
    plain versions, and the sampler's ids to ``neighbor_sample``'s where
    every block is resident."""
    samples, gathers = cached_edge_inputs(reddit_loader)
    ns, fg = [], []
    for ip, ix, slots, targets, rand, cache, block_e, max_block in samples:
        kw = dict(block_e=block_e, max_block=max_block)
        got = neighbor_sample_cached(ip, slots, targets, rand, cache, **kw)
        want = ref.neighbor_sample_cached(ip, slots, targets, rand, cache,
                                          **kw)
        torch.cuda.synchronize()
        what = (f"neighbor_sample_cached edge case {tuple(rand.shape)}, "
                f"{slots.numel()} slots")
        check(torch.equal(got, want), f"{what} differs from its plain version")
        if ix is not None:
            check(torch.equal(got, neighbor_sample(ip, ix, targets, rand)),
                  f"{what} differs from neighbor_sample")
        ns.append([*rand.shape, slots.numel()])
    for cache, slot_of, ids in gathers:
        got = feature_gather_cached(cache, slot_of, ids)
        want = ref.feature_gather_cached(cache, slot_of, ids)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"feature_gather_cached edge case "
              f"{tuple(want.shape)} differs from its plain version")
        fg.append(list(want.shape))
    print(f"[smoke]   cached kernels' edge cases bit-equal to their plain "
          f"versions: neighbor_sample_cached (M, S, slot-table entries) {ns}; "
          f"feature_gather_cached (R, F) {fg}")
    return {"neighbor_sample_cached": ns, "feature_gather_cached": fg}


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """float32 tensors equal bit for bit (``torch.equal`` takes -0.0 for
    0.0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def inmem_edge_inputs(loader) -> tuple[list, list]:
    """The in-memory kernels' edge cases on the card.  The sampler's, as
    (indptr, indices, targets, rand) with rand over all of int32 (negative
    included): on ``loader``'s graph at M 1, fanout 1 and widths that no
    block size divides; on ``_degree0_tail_graph`` with degree-0 tail
    targets, whole and with its edge array cut to 250 entries, so that
    positions clamp to E - 1.  The mean's, as (table, ids): K 1, 7, 25 and
    33 at F 602, 100 and 7 (the float2, float4 and scalar instances), M 1
    and 1001, with column 0 of the table -0.0 (a mean of -0.0 is +0.0)."""
    gen = torch.Generator(device="cpu").manual_seed(6)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             dtype=torch.int32).to(DEVICE)

    samples = []
    ip, ix = loader.indptr, loader.indices
    n = loader.g.num_nodes
    for M, S in ((1, 1), (1, 25), (3, 25), (113, 10), (113, 1), (1000, 7),
                 (1025, 25)):
        samples.append((ip, ix, randint(0, n, (M,)),
                        randint(-2**31, 2**31 - 1, (M, S))))
    ip, ix = _degree0_tail_graph()
    targets = torch.tensor([4, 2, 3, 0, 1, 4], dtype=torch.int32,
                           device=DEVICE)
    rand = randint(-2**31, 2**31 - 1, (6, 7))
    samples += [(ip, ix, targets, rand),
                (ip, ix[:250].contiguous(), targets, rand)]
    means = []
    for F in (602, 100, 7):
        table = torch.randn((200, F), generator=gen)
        table[:, 0] = -0.0
        table = table.to(DEVICE)
        for K in (1, 7, 25, 33):
            for M in (1, 1001):
                means.append((table, randint(0, 200, (M, K))))
    return samples, means


def inmem_edge_cases(loader) -> dict:
    """``neighbor_sample`` and ``feature_gather_mean`` at
    ``inmem_edge_inputs``, bit-equal to their plain versions."""
    samples, means = inmem_edge_inputs(loader)
    ns, fm = [], []
    for ip, ix, targets, rand in samples:
        got = neighbor_sample(ip, ix, targets, rand)
        want = ref.neighbor_sample(ip, ix, targets, rand)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"neighbor_sample edge case "
              f"{tuple(rand.shape)}, E {ix.numel()} differs from its plain "
              "version")
        ns.append([*rand.shape, ix.numel()])
    for table, ids in means:
        got = feature_gather_mean(table, ids)
        want = ref.feature_gather_mean(table, ids)
        torch.cuda.synchronize()
        check(bit_equal(got, want), f"feature_gather_mean edge case "
              f"{tuple(ids.shape)}, F {table.shape[1]} differs from its "
              "plain version")
        fm.append([*ids.shape, table.shape[1]])
    print(f"[smoke]   in-memory kernels' edge cases bit-equal to their plain "
          f"versions: neighbor_sample (M, S, E) {ns}; feature_gather_mean "
          f"(M, K, F) {fm}")
    return {"neighbor_sample": ns, "feature_gather_mean": fm}


def batch0(loader):
    """Batch 0's targets and its two hops' random draws, (BATCH,) and
    (BATCH, FANOUTS[0]), (BATCH * FANOUTS[0], FANOUTS[1]), as the main path
    draws them."""
    key = rng.fold_in(rng.key(0), 0)
    t = torch.as_tensor(loader.targets(0), device=DEVICE)
    r1 = rng.randint(rng.fold_in(key, 0), (BATCH, FANOUTS[0]), 0, 2**31 - 1,
                     device=DEVICE)
    r2 = rng.randint(rng.fold_in(key, 1), (BATCH, FANOUTS[0], FANOUTS[1]),
                     0, 2**31 - 1, device=DEVICE).reshape(-1, FANOUTS[1])
    return t, r1, r2


def kernel_phase(name: str, g, timer, chunks: bool) -> dict:
    """Phase 3 on one graph: the inputs are batch 0 of the main path; the
    cached kernels' counted cases are what phase 8's out-of-core step
    launches for it (the sampler's planned chunks only if ``chunks``)."""
    loader = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS,
                                  seed=0, device=DEVICE)
    t, r1, r2 = batch0(loader)
    hop1, ns1 = sample_case(loader, timer, t, r1)
    flat1 = hop1.reshape(-1)
    hop2, ns2 = sample_case(loader, timer, flat1, r2)
    gc = gather_cache(g, loader, torch.cat([t, flat1, hop2.reshape(-1)]))
    plan, segments = ooc_plan(g, t, flat1, gc[2])
    cases = {
        "neighbor_sample": [ns1, ns2],
        "feature_gather_rows": [rows_case(loader, timer, ids)
                                for ids in (t, flat1, hop2.reshape(-1))],
        "feature_gather_mean": [mean_case(loader, timer, hop2)],
        "neighbor_sample_cached": cached_sample_cases(
            g, loader, timer, (t, flat1), (r1, r2), (hop1, hop2),
            plan if chunks else []),
        "feature_gather_cached": cached_rows_cases(timer, gc, segments),
    }
    del gc
    for kname, rows in cases.items():
        counted = [c for c in rows if c.get("count", 1)]
        shown = rows if len(rows) <= 8 else [c for c in rows
                                             if not c.get("count", 1)]
        for c in shown:
            lib = ("-" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f}")
            print(f"[smoke]   {name:10s} {kname:22s} {str(c['shape']):18s} "
                  f"kernel {c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  "
                  f"library {lib} ms  bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})  max_abs_err {c['max_abs_err']:g}  "
                  f"x{c.get('count', 1)} per step")
        if len(rows) > 8:
            n = sum(c["count"] for c in counted)
            widths = sorted(c["shape"][0] for c in counted)
            print(f"[smoke]   {name:10s} {kname:22s} {n} launches a step "
                  f"(widths {widths[0]}-{widths[-1]}, median "
                  f"{statistics.median(widths)}): kernel "
                  f"{per_step(counted, 'ms'):.4f} ms a step, "
                  f"{per_step(counted, 'ms') / n:.4f} a launch  plain "
                  f"{per_step(counted, 'plain_ms'):.4f}  bound "
                  f"{per_step(counted, 'bound_ms'):.4f}")
    del loader
    torch.cuda.empty_cache()
    return cases


def per_step(cases, key) -> float:
    """Sum of count x ``key`` over ``cases``: the time a step spends."""
    return sum(c.get("count", 1) * c[key] for c in cases)


def gnn_row(kname: str, cases: list, launches: int) -> dict:
    """The JSON line's row of a GNN kernel: ``ms``, ``plain_ms``,
    ``bound_ms`` and ``library_ms`` per launch (count-weighted over the
    step's cases), the same per step beside them."""
    counted = [c for c in cases if c.get("count", 1)]
    n = sum(c.get("count", 1) for c in counted)
    libs = [c["library_ms"] for c in counted]
    row = {"name": kname, "route": "cuda", "source": SOURCES[kname],
           "replaces": REPLACES[kname], "launches": launches,
           "max_abs_err": max(c["max_abs_err"] for c in cases)}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        tot = None if key == "library_ms" and None in libs else per_step(
            counted, key)
        row[key] = None if tot is None else tot / n
        row[f"{key}_per_step"] = tot
    row["ms_per_launch"] = row["ms"]
    row["bound_by"] = counted[-1]["bound_by"]
    row.update({"per": "launch", "launches_per_step": n,
                "shapes": [c["shape"] for c in counted],
                "per_step": [c.get("count", 1) for c in counted],
                "on_main_path": kname != "feature_gather_mean"})
    return row


def parity_phase(g) -> None:
    """Phase 4: card == CPU plain path for 3 batches; fp32 steps agree."""
    gpu = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS, seed=0,
                               device=DEVICE)
    cpu = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS, seed=0,
                               device="cpu")
    for idx in range(3):
        a, b = gpu.get_batch(idx), cpu.get_batch(idx)
        for x, y in zip(a.hop_ids + a.hop_feats + [a.labels],
                        b.hop_ids + b.hop_feats + [b.labels]):
            check(torch.equal(x.cpu(), y), f"batch {idx}: card and CPU "
                  f"differ in a {tuple(y.shape)} tensor")
    print("[smoke] phase 4: 3 batches bit-equal between card and CPU")

    torch.backends.cuda.matmul.allow_tf32 = False  # full fp32 products
    losses = {}
    for dev in (DEVICE, "cpu"):
        loader = PallasSubgraphLoader(g, batch_size=64, fanouts=(10, 5),
                                      seed=0, device=dev)
        cfg = GNNConfig(feat_dim=g.feat_dim, hidden=64,
                        n_classes=int(g.labels.max()) + 1, fanouts=(10, 5))
        model = GraphSAGE(cfg, device=dev, compute_dtype=torch.float32)
        opt = adamw(1e-3)
        state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
        out = []
        train_loop(loader, build_train_step(loader, model, opt), state,
                   steps=4,
                   on_step=lambda i, s, m: out.append(float(m["loss"])))
        losses[dev] = out
    check(np.allclose(losses[DEVICE], losses["cpu"], rtol=1e-4, atol=1e-4),
          f"fp32 losses on card {losses[DEVICE]} vs CPU {losses['cpu']}")
    print(f"[smoke] phase 4: fp32 losses card {losses[DEVICE]} "
          f"cpu {losses['cpu']}")


def _merged_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_profile(run, steps: int) -> dict:
    """Profile ``run()`` (``steps`` training steps) with ``torch.profiler``:
    device time by kernel name per step, and the device's busy share of
    the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, list] = {}
    for e in dev:
        slot = by_name.setdefault(e.name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3 / steps
        slot[1] += 1
    busy_ms = _merged_us((e.time_range.start, e.time_range.end)
                         for e in dev) / 1e3
    return {"profiled_ms_per_step": 1e3 * wall_s / steps,
            "device_busy_ms_per_step": busy_ms / steps if dev else None,
            "device_busy_share": busy_ms / (1e3 * wall_s) if dev else None,
            "device_ops_per_step": len(dev) / steps,
            "by_kernel_ms_per_step": dict(sorted(
                ((k, v[0]) for k, v in by_name.items()),
                key=lambda kv: -kv[1])),
            "by_kernel_count": {k: v[1] / steps for k, v in by_name.items()}}


def print_profile(out: dict) -> None:
    for name, ms in list(out["by_kernel_ms_per_step"].items())[:12]:
        count = out["by_kernel_count"][name]
        print(f"[smoke]   {ms:9.4f} ms/step  x{count:<7g} {name[:110]}")


def profile_phase(g) -> dict:
    """Phase 6, where the time goes: the main path's step (batch 1024,
    fanouts 25,10, hidden 256) warmed up for 2 steps, timed for 8 steps
    without the profiler, then 4 more steps under ``torch.profiler``:
    device time by kernel name per step, and the device's busy share of
    the profiled loop's wall time."""
    loader = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS,
                                  seed=0, device=DEVICE)
    cfg = GNNConfig(feat_dim=g.feat_dim, hidden=256,
                    n_classes=int(g.labels.max()) + 1, fanouts=FANOUTS)
    model = GraphSAGE(cfg, device=DEVICE)
    opt = adamw(1e-3)
    step = build_train_step(loader, model, opt)
    state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
    state, _ = train_loop(loader, step, state, steps=2)
    state, steady = train_loop(loader, step, state, start=2, steps=10)
    prof_steps = 4
    out = {"steady_steps_per_s": steady.steps_per_s,
           "steady_idle_fraction": steady.idle_fraction,
           "steady_ms_per_step": 1e3 * steady.wall_s / steady.steps,
           **device_profile(lambda: train_loop(loader, step, state, start=10,
                                               steps=10 + prof_steps),
                            prof_steps)}
    print(f"[smoke] phase 6: steady {out['steady_steps_per_s']:.3f} steps/s "
          f"({out['steady_ms_per_step']:.3f} ms/step, consumer idle "
          f"{out['steady_idle_fraction']:.4f}); profiled "
          f"{out['profiled_ms_per_step']:.3f} ms/step, device busy "
          f"{out['device_busy_ms_per_step']} ms/step "
          f"(share {out['device_busy_share']}), "
          f"{out['device_ops_per_step']:.0f} device ops/step")
    print_profile(out)
    return out


def ooc_loader(g, store_dir: str, device):
    """The out-of-core loader of the slice's main path over a fresh
    ``DiskStore`` on ``store_dir``; returns (loader, store)."""
    store = DiskStore(store_dir, cache_mb=OOC_CACHE_MB)
    return PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS, seed=0,
                                device=device, store=store,
                                device_cache=OOC_TIER,
                                edge_cache=OOC_TIER), store


def ooc_parity_phase(g, store_dir: str) -> dict:
    """Phase 7: the out-of-core loader on the card == on the CPU (plain
    path) for 3 batches, bit for bit, counters included; its ids == the
    in-memory loader's on the card."""
    gpu, gpu_store = ooc_loader(g, store_dir, DEVICE)
    cpu, cpu_store = ooc_loader(g, store_dir, "cpu")
    mem = PallasSubgraphLoader(g, batch_size=BATCH, fanouts=FANOUTS, seed=0,
                               device=DEVICE)
    ios = []
    try:
        for idx in range(3):
            a, b = gpu.get_batch(idx), cpu.get_batch(idx)
            m = mem.get_batch(idx)
            for x, y in zip(a.hop_ids + a.hop_feats + [a.labels],
                            b.hop_ids + b.hop_feats + [b.labels]):
                check(torch.equal(x.cpu(), y), f"out-of-core batch {idx}: "
                      f"card and CPU differ in a {tuple(y.shape)} tensor")
            check(a.trace.io == b.trace.io, f"out-of-core batch {idx}: "
                  f"counters {a.trace.io} on the card, {b.trace.io} on CPU")
            for x, y in zip(a.hop_ids, m.hop_ids):
                check(torch.equal(x, y), f"out-of-core batch {idx}: ids "
                      "differ from the in-memory loader's")
            ios.append(a.trace.io)
    finally:
        gpu_store.close()
        cpu_store.close()
    disp = gpu.stats()["dispatches"]
    print(f"[smoke] phase 7: 3 out-of-core batches bit-equal between card "
          f"and CPU, ids equal to the in-memory loader's; {disp}; batch 0 "
          f"io {ios[0]}")
    return {"io": ios, "dispatches": disp}


def ooc_stage_phase(g, store_dir: str) -> dict:
    """Phase 9: the out-of-core step split by stage (sample, resolve,
    admit, train step), each boundary a device synchronize, over 4 steps
    after 2 warm-up steps; then 2 steps profiled."""
    loader, store = ooc_loader(g, store_dir, DEVICE)
    cfg = GNNConfig(feat_dim=g.feat_dim, hidden=256,
                    n_classes=int(g.labels.max()) + 1, fanouts=FANOUTS)
    model = GraphSAGE(cfg, device=DEVICE)
    opt = adamw(1e-3)
    step = build_train_step(loader, model, opt)
    state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
    stages = loader.pipeline_stages()
    split = {name: [] for name, _ in stages}
    split["train_step"] = []
    warm, timed = 2, 4
    try:
        for i in range(warm + timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            payload = i
            for name, fn in stages:
                payload = fn(payload)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if i >= warm:
                    split[name].append(1e3 * (t1 - t0))
                t0 = t1
            state, _ = step(state, payload)
            torch.cuda.synchronize()
            if i >= warm:
                split["train_step"].append(1e3 * (time.perf_counter() - t0))
        ms = {k: statistics.median(v) for k, v in split.items()}
        prof_steps = 2
        prof = device_profile(lambda: train_loop(
            loader, step, state, start=warm + timed,
            steps=warm + timed + prof_steps), prof_steps)
    finally:
        store.close()
    print(f"[smoke] phase 9: out-of-core step, median ms by stage {ms} "
          f"(sum {sum(ms.values()):.3f} ms); profiled "
          f"{prof['profiled_ms_per_step']:.3f} ms/step, device busy "
          f"{prof['device_busy_ms_per_step']} ms/step (share "
          f"{prof['device_busy_share']}), {prof['device_ops_per_step']:.0f} "
          "device ops/step")
    print_profile(prof)
    return {"stage_ms_median": ms, "stage_ms": split, "profile": prof}


def _spec_path(name: str) -> str:
    return os.path.join(HERE, "benchmarks", "specs", f"{name}.json")


def isp_address(store_dir: str) -> str | None:
    """None where the library's default socket, ``<store dir>/.isp.sock``,
    fits AF_UNIX's path limit; else an explicit short path in the working
    directory, said on the output."""
    if len(os.path.join(store_dir, ".isp.sock").encode()) <= UNIX_PATH_MAX:
        return None
    addr = f".isp-smoke-{os.getpid()}.sock"
    print(f"[smoke] the default socket under {store_dir} passes "
          f"{UNIX_PATH_MAX} bytes: --isp-address {addr} in {os.getcwd()}")
    return addr


def _spec_in(spec, name: str, tmp: str):
    """``spec`` with its telemetry files (the spec file names /tmp) and
    its isp store in ``tmp``, and the entry point's flags that say the
    same."""
    d = spec.to_dict()
    flags = []
    if spec.obs.enabled:
        d["obs"].update(trace_path=os.path.join(tmp, f"{name}.json"),
                        metrics_path=os.path.join(tmp, f"{name}.jsonl"))
        flags += ["--trace-out", d["obs"]["trace_path"], "--metrics-out",
                  d["obs"]["metrics_path"]]
    if spec.store.mode == "isp":
        d["store"]["path"] = os.path.join(tmp, f"{name}-store")
        flags += ["--store-dir", d["store"]["path"]]
        addr = isp_address(d["store"]["path"])
        if addr is not None:
            d["store"]["isp"]["address"] = addr
            flags += ["--isp-address", addr]
    return PipelineSpec.from_dict(d), flags


def spec_phase() -> dict:
    """Phase 19: the spec files the port runs, through the entry point on
    the card and on the CPU.  The model computes in float32 on both (in
    bf16 the two devices' sums round apart), with TF32 off."""
    g = load_dataset("reddit")
    out = {}
    real_sage, tf32 = train.GraphSAGE, torch.backends.cuda.matmul.allow_tf32
    train.GraphSAGE = functools.partial(real_sage,
                                        compute_dtype=torch.float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip-smoke-specs-")
    try:
        for name in PORTED_SPECS:
            path = _spec_path(name)
            spec, flags = _spec_in(PipelineSpec.load(path), name,
                                   tmp_dir.name)
            ids = {}
            for dev in (DEVICE, "cpu"):
                with build_pipeline(spec, g, device=dev) as pipe:
                    ids[dev] = [h.cpu() for h in pipe.get_batch(0).hop_ids]
            check(all(torch.equal(a, b)
                      for a, b in zip(ids[DEVICE], ids["cpu"])),
                  f"{name}: batch 0's ids differ between card and CPU")
            runs = {}
            steps = CHAOS_STEPS if name == CHAOS_SPEC else SPEC_STEPS
            for dev in (DEVICE, "cpu"):
                kernels.reset_launches()
                with warnings.catch_warnings():
                    # the chaos spec's watchdog restart warns
                    warnings.simplefilter("ignore")
                    _, losses, lstats = train.main([
                        "--arch", "graphsage", "--spec", path, "--dataset",
                        "reddit", "--steps", str(steps), "--log-every",
                        str(steps), "--device", dev, *flags])
                runs[dev] = {"losses": losses,
                             "launches": dict(kernels.LAUNCHES),
                             "store": lstats.get("store", {}).get("kind"),
                             "restarts": lstats.get("prefetch_restarts"),
                             "degraded": lstats.get("degraded"),
                             "oracle": lstats.get("oracle")}
            card, cpu = runs[DEVICE], runs["cpu"]
            check(len(card["losses"]) == steps
                  and all(math.isfinite(x) for x in card["losses"]),
                  f"{name}: losses {card['losses']}")
            check(np.allclose(card["losses"], cpu["losses"], rtol=1e-5,
                              atol=1e-5), f"{name}: losses card "
                  f"{card['losses']} vs CPU {cpu['losses']}")
            check(not any(cpu["launches"].values()),
                  f"{name}: the CPU run launched {cpu['launches']}")
            n = card["launches"]
            tier = spec.device_cache_tier()
            host = spec.backend.name == "host"
            feats = tier is not None and "features" in tier.arrays
            edges = tier is not None and "topology" in tier.arrays
            if spec.backend.name in ("host", "isp"):
                # the host backend prepares batches in numpy, the isp
                # backend in plain torch ops on its shards
                check(not any(n.values()), f"{name}: launched {n}")
            else:
                check((n["feature_gather_cached"] > 0) == feats
                      and n["feature_gather_rows"] > 0,
                      f"{name}: feature kernels launched {n}")
                check((n["neighbor_sample_cached"] > 0) == edges
                      and (n["neighbor_sample"] > 0) == (not edges),
                      f"{name}: sampling kernels launched {n}")
            if any(t.policy == "optimal" for t in spec.cache_tiers):
                for dev, r in runs.items():
                    _check_replay(r["oracle"], f"{name} on {dev}")
            disk = spec.store.kind == "disk" and (tier is not None or host)
            kind = "isp" if spec.store.mode == "isp" else "disk"
            check((card["store"] == kind) == disk,
                  f"{name}: store {card['store']}, spec {spec.store.kind}")
            if spec.obs.enabled:
                # the CPU's run wrote the files last: a whole trace
                with open(spec.obs.trace_path) as f:
                    events = json.load(f)["traceEvents"]
                check(events and {e["ph"] for e in events} <= {"X", "M"},
                      f"{name}: trace events {events[:3]}")
            if spec.prefetch.overlap:
                # the chaos spec's scheduled stall restarts its lanes
                # (phase 21 checks that); no other spec may restart
                check((card["restarts"] == 0 or name == CHAOS_SPEC)
                      and card["degraded"] is False,
                      f"{name}: {card['restarts']} restarts, degraded "
                      f"{card['degraded']}")
            diff = max(abs(a - b) for a, b in zip(card["losses"],
                                                  cpu["losses"]))
            print(f"[smoke] phase 19: {name}: losses {card['losses']} "
                  f"(max diff to the CPU {diff:g}), launches "
                  f"{ {k: v for k, v in n.items() if v} }, store "
                  f"{card['store']}, batch 0 ids equal")
            out[name] = {"runs": runs, "max_loss_diff": diff}
    finally:
        train.GraphSAGE = real_sage
        torch.backends.cuda.matmul.allow_tf32 = tf32
        tmp_dir.cleanup()
    return out


def _check_replay(oracle: dict | None, what: str) -> None:
    """An optimal run's replay lane ran, and without an error or a
    timeout (its soft failure would pass as a quiet lru run)."""
    check(oracle is not None and oracle["batches_replayed"] > 0
          and oracle["errors"] == 0 and oracle["timeouts"] == 0,
          f"{what}: replay lane {oracle}")


def _recording(build, into: list):
    """``build_pipeline`` whose pipelines record every batch the consumer
    takes: device copies of its hop ids, features and labels, its
    ``trace.io`` and its kernel launches."""
    def built(*a, **kw):
        pipe = build(*a, **kw)
        get = pipe.get_batch

        def get_batch(idx, **kw2):
            mb = get(idx, **kw2)
            into.append({"idx": idx,
                         "tensors": [t.clone() for t in
                                     mb.hop_ids + mb.hop_feats + [mb.labels]],
                         "io": copy.deepcopy(mb.trace.io),
                         "launches": dict(mb.launches)})
            return mb

        pipe.get_batch = get_batch
        return pipe
    return built


def _io_fixed(io_: dict) -> dict:
    """The per-batch counters that the lanes' interleaving cannot move:
    the two device caches' (planned serially in batch order), the fault
    counters, the store's requests and the blocks they touched (a block
    read hits or misses the shared page cache depending on which lane
    reached it first, so only hits + misses is fixed)."""
    return {"devcache": io_.get("devcache"), "edgecache": io_.get("edgecache"),
            "faults": io_.get("faults"), "requests": io_["requests"],
            "blocks_touched": io_["hits"] + io_["misses"]}


def overlap_phase(g, argv_ooc: list) -> dict:
    """Phase 20: the out-of-core entry point at full width, synchronous
    and overlapped; equal batches, counters, launches and losses; then
    both modes timed in turns and profiled."""
    with tempfile.TemporaryDirectory(prefix="chip-smoke-overlap-") as sdir:
        save_graph(g, sdir)
        def with_pool(n: int) -> list:
            return argv_ooc + ["--io-threads", str(n), "--store-dir", sdir]

        argv = with_pool(PREAD_THREADS[0])
        real_build = train.build_pipeline
        runs, batches = {}, {}
        try:
            for mode in ("sync", "overlap"):
                rec = batches[mode] = []
                train.build_pipeline = _recording(real_build, rec)
                kernels.reset_launches()
                mine = kernels.thread_launches()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    stats, losses, lstats = train.main(
                        argv + (OVERLAP_FLAGS if mode == "overlap" else []))
                after = kernels.thread_launches()
                runs[mode] = {
                    "losses": losses, "steps_per_s": stats.steps_per_s,
                    "idle_fraction": stats.idle_fraction,
                    "launches": dict(kernels.LAUNCHES),
                    "consumer_launches": {k: after[k] - mine[k]
                                          for k in after},
                    "loader": lstats,
                    "warnings": [str(w.message) for w in caught]}
        finally:
            train.build_pipeline = real_build
        sync, over = runs["sync"], runs["overlap"]
        for mode, rec in batches.items():
            check([b["idx"] for b in rec] == list(range(8)),
                  f"{mode}: batches {[b['idx'] for b in rec]}")
        per_batch = {}
        for a, b in zip(batches["sync"], batches["overlap"]):
            i = a["idx"]
            check(all(torch.equal(x, y)
                      for x, y in zip(a["tensors"], b["tensors"])),
                  f"batch {i}: a tensor differs between sync and overlap")
            check(_io_fixed(a["io"]) == _io_fixed(b["io"]),
                  f"batch {i}: counters {_io_fixed(a['io'])} sync, "
                  f"{_io_fixed(b['io'])} overlapped")
            check(a["launches"] == b["launches"],
                  f"batch {i}: launches {a['launches']} sync, "
                  f"{b['launches']} overlapped")
            per_batch[i] = {"io_sync": a["io"], "io_overlap": b["io"],
                            "io_equal": a["io"] == b["io"],
                            "launches": a["launches"]}
        summed = {}
        for b in batches["sync"]:
            for k, v in b["launches"].items():
                summed[k] = summed.get(k, 0) + v
        del batches
        torch.cuda.empty_cache()
        check(sync["losses"] == over["losses"],
              f"losses {sync['losses']} sync, {over['losses']} overlapped")
        gnn = GNN_KERNELS
        check({k: sync["launches"][k] for k in gnn}
              == {k: summed.get(k, 0) for k in gnn},
              f"sync launches {sync['launches']} vs per-batch sums {summed}")
        check(summed.get("neighbor_sample_cached", 0) > 0
              and summed.get("feature_gather_cached", 0) > 0
              and summed.get("feature_gather_rows", 0) > 0
              and not summed.get("neighbor_sample"),
              f"launches per batch {summed}")
        check(not any(over["consumer_launches"].values()),
              f"the consumer launched {over['consumer_launches']}")
        check(all(over["launches"][k] >= summed.get(k, 0) for k in gnn),
              f"overlapped launches {over['launches']} below {summed}")
        ls = over["loader"]
        check(ls["prefetch_restarts"] == 0 and ls["lane_stall_restarts"] == 0
              and ls["lane_failures"] == 0 and ls["degraded"] is False,
              f"lanes: {ls['prefetch_restarts']} restarts, "
              f"{ls['lane_stall_restarts']} watchdog restarts, "
              f"{ls['lane_failures']} failures, degraded {ls['degraded']}")
        planner = [w for w in over["warnings"] if "plan_ahead" in w]
        io_equal = sum(v["io_equal"] for v in per_batch.values())
        print(f"[smoke] phase 20: 8 batches equal sync vs overlapped (ids, "
              f"features, labels, launches, fixed counters; whole trace.io "
              f"equal in {io_equal} of 8), losses equal {over['losses']}, "
              f"launches per 8 batches {summed}, overlapped run's total "
              f"{ {k: over['launches'][k] for k in gnn} }, none from the "
              f"consumer; restarts 0, not degraded; planner plan_ahead "
              f"{ls['plan_ahead']} of 2"
              + (f" ({planner[0]})" if planner else ""))

        timed = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for n, mode in ((n, m) for n in PREAD_THREADS
                            for m in OVERLAP_RUNS):
                stats, _, lstats = train.main(with_pool(n) + (
                    OVERLAP_FLAGS if mode == "overlap" else []))
                timed.setdefault(f"{mode}, io_threads {n}", []).append({
                    "steps_per_s": stats.steps_per_s,
                    "idle_fraction": stats.idle_fraction,
                    "stage_mean_s": lstats["stage_mean_s"],
                    "overlap_factor": lstats.get("overlap_factor")})
        medians = {mode: {
            "steps_per_s": statistics.median(r["steps_per_s"] for r in rs),
            "idle_fraction": statistics.median(r["idle_fraction"]
                                               for r in rs),
            "stage_mean_s": {k: statistics.median(r["stage_mean_s"][k]
                                                  for r in rs)
                             for k in rs[0]["stage_mean_s"]}}
            for mode, rs in timed.items()}

        profiles = {}
        for mode in ("sync", "overlap"):
            spec = train.parse_args(argv + (
                OVERLAP_FLAGS if mode == "overlap" else [])).pipeline_spec
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pipe = build_pipeline(spec, g, device=DEVICE)
            try:
                cfg = GNNConfig(feat_dim=g.feat_dim, hidden=256,
                                n_classes=int(g.labels.max()) + 1,
                                fanouts=FANOUTS)
                model = GraphSAGE(cfg, device=DEVICE)
                opt = adamw(1e-3)
                step = build_train_step(pipe, model, opt)
                state = {"opt": opt.init(dict(model.named_parameters())),
                         "step": 0}
                state, _ = train_loop(pipe, step, state, steps=2)
                profiles[mode] = device_profile(lambda: train_loop(
                    pipe, step, state, start=2, steps=3), 1)
            finally:
                pipe.close()
    for key, m in medians.items():
        print(f"[smoke] phase 20: {key}: median of "
              f"{OVERLAP_RUNS.count('sync')} runs "
              f"{m['steps_per_s']:.4f} steps/s, consumer idle "
              f"{m['idle_fraction']:.4f}, host s/batch by stage "
              f"{m['stage_mean_s']}")
    for mode, pr in profiles.items():
        print(f"[smoke] phase 20: {mode}: profiled "
              f"{pr['profiled_ms_per_step']:.3f} ms/step, device busy "
              f"{pr['device_busy_ms_per_step']} ms/step (share "
              f"{pr['device_busy_share']})")
    return {"argv": argv, "overlap_flags": OVERLAP_FLAGS, "runs": runs,
            "per_batch": per_batch, "launches_per_8_batches": summed,
            "planner_warnings": planner, "timed": timed, "medians": medians,
            "profiles": profiles}


def _gnn(launches: dict) -> dict:
    return {k: launches.get(k, 0) for k in GNN_KERNELS}


def _fs_type(path: str) -> str:
    """The filesystem type of the mount holding ``path`` (/proc/mounts)."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    with open("/proc/self/mounts") as f:
        for line in f:
            parts = line.split()
            mnt = parts[1]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return kind


def _train_recorded(argv: list, build, record: list | None = None):
    """``train.main(argv)`` with ``train.build_pipeline`` replaced by
    ``build`` (recording each batch the consumer takes into ``record``),
    the launch counters reset just before; returns the run's stats,
    losses, loader stats, launches and warnings."""
    real = train.build_pipeline
    train.build_pipeline = (_recording(build, record) if record is not None
                            else build)
    kernels.reset_launches()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            stats, losses, lstats = train.main(argv)
    finally:
        train.build_pipeline = real
    return {"stats": stats, "losses": losses, "loader": lstats,
            "launches": dict(kernels.LAUNCHES),
            "warnings": [str(w.message) for w in caught]}


def _spec_argv(name: str, steps: int, *extra) -> list:
    return ["--arch", "graphsage", "--spec", _spec_path(name), "--dataset",
            "reddit", "--steps", str(steps), "--log-every", "1", "--device",
            DEVICE, *extra]


def _failing_build(after: int):
    """``build_pipeline`` whose loader's feature-cache fetch fails past
    the retry policy from its ``after + 1``-th call on."""
    def built(*a, **kw):
        pipe = build_pipeline(*a, **kw)
        dc = pipe.loader.devcache
        fetch, calls = dc.fetch_plan, [0]

        def fetch_plan(plan):
            calls[0] += 1
            if calls[0] > after:
                raise StoreReadError("forced feature-fetch failure "
                                     "(chip_smoke phase 21)")
            return fetch(plan)

        dc.fetch_plan = fetch_plan
        return pipe
    return built


def faults_phase(argv_ooc: list, sdir: str, ooc: dict) -> dict:
    """Phase 21: the chaos spec against its fault-free twin on the card;
    phase 8's command under the fault mix, and with the feature fetch
    forced to fail (the device-cache bypass)."""
    t0 = time.perf_counter()
    batches, runs = {}, {}
    for name in (CHAOS_TWIN, CHAOS_SPEC):
        batches[name] = []
        runs[name] = _train_recorded(_spec_argv(name, CHAOS_STEPS),
                                     build_pipeline, batches[name])
    twin, chaos = runs[CHAOS_TWIN], runs[CHAOS_SPEC]
    for name, rec in batches.items():
        check([b["idx"] for b in rec] == list(range(CHAOS_STEPS)),
              f"{name}: batches {[b['idx'] for b in rec]}")
    for a, b in zip(batches[CHAOS_TWIN], batches[CHAOS_SPEC]):
        check(all(torch.equal(x, y)
                  for x, y in zip(a["tensors"], b["tensors"])),
              f"chaos batch {a['idx']}: a tensor differs from the twin's")
    del batches
    check(chaos["losses"] == twin["losses"],
          f"chaos losses {chaos['losses']} vs twin {twin['losses']}")
    ls = chaos["loader"]
    check(ls["lane_stall_restarts"] >= 1 and ls["degraded"] is False
          and ls["lane_failures"] == 0,
          f"chaos lanes: {ls['lane_stall_restarts']} watchdog restarts, "
          f"{ls['lane_failures']} failures, degraded {ls['degraded']}")
    chaos_faults = {k: ls["store"][k] for k in FAULT_COUNTERS}
    check(all(chaos_faults[k] > 0
              for k in ("io_errors", "short_reads", "corrupt_blocks")),
          f"chaos fault counters {chaos_faults}")
    chaos_s = time.perf_counter() - t0
    print(f"[smoke] phase 21: {CHAOS_SPEC}: 8 batches and losses equal "
          f"{CHAOS_TWIN}'s ({chaos['losses']}), watchdog restarts "
          f"{ls['lane_stall_restarts']}, not degraded, store faults "
          f"{chaos_faults}, launches {_gnn(chaos['launches'])} ({chaos_s:.1f} s)")

    t0 = time.perf_counter()
    argv_f = argv_ooc + ["--store-dir", sdir] + FAULT_FLAGS
    print(f"[smoke] phase 21: train {' '.join(argv_f)}")
    faulty = _train_recorded(argv_f, build_pipeline)
    check(faulty["losses"] == ooc["losses"],
          f"faulty losses {faulty['losses']} vs phase 8's {ooc['losses']}")
    check(_gnn(faulty["launches"]) == _gnn(ooc["launches"]),
          f"faulty launches {faulty['launches']} vs phase 8's "
          f"{ooc['launches']}")
    faults = {k: faulty["loader"]["store"][k] for k in FAULT_COUNTERS}
    check(all(faults[k] > 0 for k in ("io_errors", "short_reads",
                                      "corrupt_blocks", "retries")),
          f"faulty run's fault counters {faults}")
    faulty_s = time.perf_counter() - t0
    sps = faulty["stats"].steps_per_s
    print(f"[smoke] phase 21: under faults {sps:.4f} steps/s (phase 8 "
          f"{ooc['steps_per_s']:.4f}), losses and launches equal phase "
          f"8's, store faults {faults}, blocks fetched "
          f"{faulty['loader']['store']['block_fetches']} ({faulty_s:.1f} s)")

    t0 = time.perf_counter()
    rec = []
    bypass = _train_recorded(argv_ooc + ["--store-dir", sdir],
                             _failing_build(BYPASS_AFTER), rec)
    warned = [w for w in bypass["warnings"] if "bypassing the cache" in w]
    check(len(warned) == 1, f"bypass warnings {bypass['warnings']}")
    check(bypass["losses"] == ooc["losses"],
          f"bypassed losses {bypass['losses']} vs phase 8's "
          f"{ooc['losses']}")
    per_batch = []
    for b in rec:
        n = b["launches"]
        after = b["idx"] >= BYPASS_AFTER
        per_batch.append({"idx": b["idx"], "launches": n,
                          "bypass": bool(b["io"].get("devcache_bypass"))})
        check((n.get("feature_gather_cached", 0) == 0) == after
              and n.get("feature_gather_rows", 0) == 3
              and per_batch[-1]["bypass"] == after,
              f"batch {b['idx']}: launches {n}, io {b['io'].keys()}")
    check(bypass["loader"]["devcache_bypass_events"] == 1,
          f"bypass events {bypass['loader']['devcache_bypass_events']}")
    bypass_s = time.perf_counter() - t0
    print(f"[smoke] phase 21: bypass: {warned[0]!r}; batches "
          f"{BYPASS_AFTER}-7 launched no feature_gather_cached and 3 "
          f"feature_gather_rows each, losses equal phase 8's, "
          f"{bypass['stats'].steps_per_s:.4f} steps/s ({bypass_s:.1f} s)")
    return {"chaos": {k: v for k, v in chaos.items() if k != "stats"},
            "twin_losses": twin["losses"], "chaos_faults": chaos_faults,
            "chaos_s": chaos_s,
            "faulty": {"argv": argv_f, "losses": faulty["losses"],
                       "launches": faulty["launches"], "faults": faults,
                       "steps_per_s": sps,
                       "phase8_steps_per_s": ooc["steps_per_s"],
                       "store": faulty["loader"]["store"],
                       "seconds": faulty_s},
            "bypass": {"warning": warned[0], "per_batch": per_batch,
                       "launches": bypass["launches"],
                       "steps_per_s": bypass["stats"].steps_per_s,
                       "seconds": bypass_s}}


def direct_io_phase(argv_ooc: list, sdir: str, ooc: dict) -> dict:
    """Phase 22: phase 8's command with ``--direct-io 1``."""
    t0 = time.perf_counter()
    argv = argv_ooc + ["--store-dir", sdir, "--direct-io", "1"]
    print(f"[smoke] phase 22: train {' '.join(argv)}")
    run = _train_recorded(argv, build_pipeline)
    mode = run["loader"]["store"]["direct_io"]
    fell_back = [w for w in run["warnings"] if "direct_io" in w]
    check(mode or fell_back, "direct_io off without a warning")
    check(run["losses"] == ooc["losses"],
          f"direct-I/O losses {run['losses']} vs phase 8's {ooc['losses']}")
    check(_gnn(run["launches"]) == _gnn(ooc["launches"]),
          f"direct-I/O launches {run['launches']} vs {ooc['launches']}")
    fs = _fs_type(sdir)
    seconds = time.perf_counter() - t0
    print(f"[smoke] phase 22: the store at {sdir} ({fs}) reads "
          + ("O_DIRECT" if mode else f"buffered: {fell_back[0]}")
          + f"; {run['stats'].steps_per_s:.4f} steps/s (phase 8 "
          f"{ooc['steps_per_s']:.4f}), losses equal phase 8's "
          f"({seconds:.1f} s)")
    return {"argv": argv, "direct_io": mode, "fs": fs,
            "warnings": fell_back, "losses": run["losses"],
            "steps_per_s": run["stats"].steps_per_s, "seconds": seconds}


def _steps(argv: list, n: int) -> list:
    out = list(argv)
    out[out.index("--steps") + 1] = str(n)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().view(torch.int32)


def _same_bits(a, b) -> bool:
    if not isinstance(a, torch.Tensor):
        return b.dim() == 0 and int(b) == a
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().cpu().reshape(-1).view(torch.uint8),
        b.reshape(-1).view(torch.uint8))


def lm_full_ckpt_case(ckpt_dir: str) -> dict:
    """LM_ARCH's full-width training state (float32 parameters and AdamW
    moments after one step on TRAIN_PARITY_BATCH x TRAIN_PARITY_SEQ
    tokens) through the launcher's ``AsyncSaver``, then ``restore`` on
    the CPU: every leaf bit-equal to the card's.  Times the snapshot
    (``save_async``'s device-to-host copy, which the trainer waits for),
    the whole save (to ``wait``'s return) and the restore."""
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    model = LM(cfg, init_params(build_defs(cfg), seed=0, device=DEVICE),
               trainable=True)
    opt = adamw(warmup_cosine(1e-3, 10, 50))
    state = init_train_state(model, opt)
    batch = TokenPipeline(vocab_size=cfg.vocab_size,
                          seq_len=TRAIN_PARITY_SEQ,
                          global_batch=TRAIN_PARITY_BATCH).torch_batch(
                              0, DEVICE)
    state, _ = build_lm_train_step(model, opt)(state, batch)
    torch.cuda.synchronize()
    saver = ckpt.AsyncSaver(ckpt_dir)
    t0 = time.perf_counter()
    saver.save_async(1, state)
    t1 = time.perf_counter()
    saver.wait()
    t2 = time.perf_counter()
    restored, step = ckpt.restore(ckpt_dir, device="cpu")
    t3 = time.perf_counter()
    live, back = flatten_state(state), flatten_state(restored)
    nbytes = sum(v.numel() * v.element_size() for v in live.values()
                 if isinstance(v, torch.Tensor))
    check(step == 1 and sorted(back) == sorted(live)
          and all(_same_bits(v, back[k]) for k, v in live.items())
          and all(t.device.type == "cpu" for t in back.values()),
          f"{LM_ARCH}'s full-width checkpoint restored on the CPU differs "
          "from the card's state")
    out = {"leaves": len(live), "bytes": nbytes,
           "file_bytes": os.path.getsize(saver.last_path),
           "snapshot_s": t1 - t0, "save_s": t2 - t0, "restore_s": t3 - t2}
    del state, restored, live, back, model
    torch.cuda.empty_cache()
    return out


def resume_phase(argv: list, chaos_losses: list) -> dict:
    """Phase 23: 8 steps straight against 4 steps and a resume, for phase
    5's command, the chaos spec overlapped and the reduced LM; a
    checkpoint written on the card restored on the CPU, for the GNN and
    for LM_ARCH's full-width state."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as cdir:
        def d(name):
            return os.path.join(cdir, name)

        models = []
        real_sage = train.GraphSAGE

        def kept(*a, **kw):
            models.append(real_sage(*a, **kw))
            return models[-1]

        train.GraphSAGE = kept
        kernels.reset_launches()
        try:
            _, full, _ = train.main(argv)
            train.main(_steps(argv, RESUME_AT) + ["--ckpt-dir", d("b")])
            _, resumed, _ = train.main(argv + ["--ckpt-dir", d("b"),
                                               "--resume"])
        finally:
            train.GraphSAGE = real_sage
        launches = dict(kernels.LAUNCHES)
        check(resumed == full[RESUME_AT:],
              f"in memory: resumed {resumed} vs {full[RESUME_AT:]}")
        check(ckpt.list_steps(d("b")) == [RESUME_AT, RESUME_STEPS],
              f"checkpoints {ckpt.list_steps(d('b'))}")
        restored, step = ckpt.restore(d("b"), device="cpu")
        live = dict(models[-1].named_parameters())
        check(step == RESUME_STEPS and sorted(restored["params"])
              == sorted(live) and all(
                  torch.equal(_bits(restored["params"][k]), _bits(v))
                  for k, v in live.items())
              and all(t.device.type == "cpu"
                      for t in restored["params"].values()),
              "the card's checkpoint restored on the CPU differs from the "
              "card's parameters")
        out["inmem"] = {"full": full, "resumed": resumed,
                        "launches": launches}
        print(f"[smoke] phase 23: in memory, steps 5-8 resumed {resumed} "
              f"equal the straight run's; step 8's checkpoint restored on "
              f"the CPU bit-equal to the card's {len(live)} parameters; "
              f"launches {_gnn(launches)}")

        kernels.reset_launches()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            train.main(_spec_argv(CHAOS_SPEC, RESUME_AT, "--ckpt-dir",
                                  d("c")))
            # without --spec: the data plane from the manifest
            _, chaos_resumed, lstats = train.main([
                "--arch", "graphsage", "--dataset", "reddit", "--steps",
                str(RESUME_STEPS), "--log-every", "1", "--device", DEVICE,
                "--ckpt-dir", d("c"), "--resume"])
        launches = dict(kernels.LAUNCHES)
        check(lstats.get("stages") == ["sample", "resolve", "admit"]
              and lstats["degraded"] is False,
              f"the resumed chaos run's loader {lstats.get('stages')}, "
              f"degraded {lstats.get('degraded')}")
        check(chaos_resumed == chaos_losses[RESUME_AT:],
              f"chaos: resumed {chaos_resumed} vs "
              f"{chaos_losses[RESUME_AT:]}")
        out["chaos"] = {"resumed": chaos_resumed, "launches": launches,
                        "watchdog_restarts": lstats["lane_stall_restarts"]}
        print(f"[smoke] phase 23: {CHAOS_SPEC}, overlapped, resumed from "
              f"its manifest: steps 5-8 {chaos_resumed} equal phase 21's; "
              f"watchdog restarts {lstats['lane_stall_restarts']}; "
              f"launches {_gnn(launches)}")

        lm = LM_RESUME_ARGV + ["--device", DEVICE]
        kernels.reset_launches()
        full = train.main(lm + ["--steps", str(RESUME_STEPS)])
        train.main(lm + ["--steps", str(RESUME_AT), "--ckpt-dir", d("lm")])
        resumed = train.main(lm + ["--steps", str(RESUME_STEPS),
                                   "--ckpt-dir", d("lm")])
        launches = dict(kernels.LAUNCHES)
        check(resumed["losses"] == full["losses"][RESUME_AT:],
              f"LM: resumed {resumed['losses']} vs "
              f"{full['losses'][RESUME_AT:]}")
        check(launches["flash_attention_fwd"] > 0
              and launches["flash_attention_bwd_dq"] > 0
              and launches["flash_attention_bwd_dkv"] > 0,
              f"LM launches {launches}")
        out["lm"] = {"full": full["losses"], "resumed": resumed["losses"],
                     "launches": launches}
        print(f"[smoke] phase 23: {' '.join(lm)}: steps 5-8 resumed "
              f"{resumed['losses']} repr-equal to the straight run's; "
              f"launches { {k: v for k, v in launches.items() if v} }")

        t1 = time.perf_counter()
        lm_full = lm_full_ckpt_case(d("lm-full"))
        lm_full["seconds"] = time.perf_counter() - t1
        out["lm_full"] = lm_full
        gb = lm_full["bytes"] / 1e9
        print(f"[smoke] phase 23: {LM_ARCH} full width, parameters and "
              f"AdamW moments ({lm_full['leaves']} leaves, {gb:.3f} GB, "
              f"file {lm_full['file_bytes'] / 1e9:.3f} GB) saved through "
              f"AsyncSaver and restored on the CPU bit-equal: snapshot "
              f"{lm_full['snapshot_s']:.3f} s, save "
              f"{lm_full['save_s']:.3f} s "
              f"({gb / lm_full['save_s']:.3f} GB/s), restore "
              f"{lm_full['restore_s']:.3f} s; "
              f"{lm_full['seconds']:.1f} s with its training step")
    out["seconds"] = time.perf_counter() - t0
    print(f"[smoke] phase 23: {out['seconds']:.1f} s")
    return out


def _recording_ids(build, into: list):
    """``build_pipeline`` whose pipelines record each batch's hop ids
    (copies), ``trace.io`` and kernel launches."""
    def built(*a, **kw):
        pipe = build(*a, **kw)
        get = pipe.get_batch

        def get_batch(idx, **kw2):
            mb = get(idx, **kw2)
            into.append({"idx": idx, "ids": [h.clone() for h in mb.hop_ids],
                         "io": copy.deepcopy(mb.trace.io)
                         if mb.trace is not None else None,
                         "launches": dict(mb.launches or {})})
            return mb

        pipe.get_batch = get_batch
        return pipe
    return built


def _tier_sums(lstats: dict) -> dict:
    """hits + misses of each cache tier: the requests, which the policy
    must not change."""
    return {t: lstats[t]["hits"] + lstats[t]["misses"]
            for t in ("store", "devcache", "edgecache") if t in lstats}


def _misses(lstats: dict) -> dict:
    return {t: lstats[t]["misses"]
            for t in ("store", "devcache", "edgecache") if t in lstats}


def _cpu_batches(argv: list, g, n: int) -> list:
    """Batches 0..n-1 of the pipeline ``argv`` describes, built on the
    CPU: hop ids and ``trace.io``."""
    spec = train.parse_args(argv + ["--device", "cpu"]).pipeline_spec
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = build_pipeline(spec, g, device="cpu")
    try:
        out = []
        for i in range(n):
            mb = pipe.get_batch(i)
            out.append({"ids": [h.cpu() for h in mb.hop_ids],
                        "io": mb.trace.io if mb.trace is not None else None})
        return out
    finally:
        pipe.close()


def _same_batches(card: list, cpu: list, what: str) -> None:
    for i, (a, b) in enumerate(zip(card, cpu)):
        check(a["idx"] == i and all(torch.equal(x.cpu(), y)
                                    for x, y in zip(a["ids"], b["ids"])),
              f"{what}: batch {i}'s ids differ between card and CPU")
        check(a["io"] == b["io"], f"{what}: batch {i}'s counters card "
              f"{a['io']} vs CPU {b['io']}")


def _replay_window_s(argv: list, g) -> float:
    """Seconds the replay lane's work takes for one window of phase 8's
    command: the replay of each batch and the next-use times of each
    stream, on this host's CPU (the lane's own code, run here)."""
    from repro_torch.storage.oracle import next_use_times
    spec = train.parse_args(argv + ["--device", "cpu"]).pipeline_spec
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = build_pipeline(spec, g, device="cpu")
    try:
        rep = pipe.loader._oracle
        t0 = time.perf_counter()
        streams = {}
        for i in range(rep.window, 2 * rep.window):
            for k, ids in rep._replay(i).items():
                streams.setdefault(k, []).append((i, ids))
        for pairs in streams.values():
            next_use_times(pairs)
        return time.perf_counter() - t0
    finally:
        pipe.close()


def _train_spec(spec, g, steps: int) -> dict:
    """Train ``steps`` steps through ``build_pipeline(spec, g)`` on the
    card at hidden 256 (the entry point's loop, for a graph it cannot
    name); the launch counters reset just before."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pipe = build_pipeline(spec, g, device=DEVICE)
    try:
        cfg = GNNConfig(feat_dim=g.feat_dim, hidden=256,
                        n_classes=int(g.labels.max()) + 1,
                        fanouts=spec.effective_fanouts)
        torch.manual_seed(0)
        model = GraphSAGE(cfg, device=DEVICE)
        opt = adamw(1e-3)
        step = build_train_step(pipe, model, opt)
        state = {"opt": opt.init(dict(model.named_parameters())), "step": 0}
        losses = []
        kernels.reset_launches()
        _, stats = train_loop(pipe, step, state, steps=steps,
                              on_step=lambda i, s, m: losses.append(
                                  float(m["loss"])))
        return {"losses": losses, "stats": stats, "loader": pipe.stats(),
                "launches": dict(kernels.LAUNCHES)}
    finally:
        pipe.close()


def oracle_phase(reddit, argv_ooc: list, synth) -> dict:
    """Phase 24a-b: the optimal (Belady) policies on the card.  a: phase
    8's command in both tiers against its lru twin; b: R-MAT out of core
    with a feature tier between one batch's unique rows and the window's
    union, where the schedule can matter."""
    from repro_torch.core.loader import batch_targets
    from repro_torch.core.sampler import replay_khop_jax_ids

    out = {}
    t0 = time.perf_counter()
    argvs = {"lru": argv_ooc + ["--device-cache-policy", "lru"],
             "optimal": argv_ooc + ORACLE_FLAGS}
    runs, recs = {}, {}
    for pol, argv in argvs.items():
        print(f"[smoke] phase 24a: train {' '.join(argv)}")
        recs[pol] = []
        runs[pol] = _train_recorded(
            argv, _recording_ids(build_pipeline, recs[pol]))
    lru, opt = runs["lru"], runs["optimal"]
    _check_replay(opt["loader"].get("oracle"), "phase 24a")
    check(opt["losses"] == lru["losses"],
          f"phase 24a: losses optimal {opt['losses']} vs lru {lru['losses']}")
    for a, b in zip(recs["lru"], recs["optimal"]):
        check(all(torch.equal(x, y) for x, y in zip(a["ids"], b["ids"])),
              f"phase 24a: batch {a['idx']}'s ids differ lru vs optimal")
    check(len(recs["optimal"]) == 8, "phase 24a: 8 batches recorded")
    check(_tier_sums(opt["loader"]) == _tier_sums(lru["loader"]),
          f"phase 24a: requests {_tier_sums(opt['loader'])} optimal vs "
          f"{_tier_sums(lru['loader'])} lru")
    cpu = _cpu_batches(argvs["optimal"], reddit, HOST_COMPARED)
    _same_batches(recs["optimal"], cpu, "phase 24a optimal")
    window_s = _replay_window_s(argvs["optimal"], reddit)
    for pol, r in runs.items():
        print(f"[smoke] phase 24a: {pol}: {r['stats'].steps_per_s:.4f} "
              f"steps/s, consumer idle {r['stats'].idle_fraction:.4f}, "
              f"host s a batch by stage {r['loader']['stage_mean_s']}, "
              f"misses {_misses(r['loader'])}, launches "
              f"{ {k: v for k, v in _gnn(r['launches']).items() if v} }")
    print(f"[smoke] phase 24a: losses equal {opt['losses']}, batches 0-7's "
          f"ids equal, requests {_tier_sums(opt['loader'])} equal, batches "
          f"0-{HOST_COMPARED - 1}'s counters equal the CPU's, replay "
          f"{opt['loader']['oracle']}, {window_s:.3f} s a window of 8 "
          f"on this host's CPU")
    out["a"] = {"argv": argvs, "window_s": window_s,
                **{pol: {"losses": r["losses"],
                         "steps_per_s": r["stats"].steps_per_s,
                         "idle_fraction": r["stats"].idle_fraction,
                         "stage_mean_s": r["loader"]["stage_mean_s"],
                         "misses": _misses(r["loader"]),
                         "requests": _tier_sums(r["loader"]),
                         "oracle": r["loader"].get("oracle"),
                         "launches": _gnn(r["launches"])}
                   for pol, r in runs.items()}}

    # b. the R-MAT graph: the first window's per-batch unique rows and
    # their union, by the lane's own replay of the kernel sampler
    t1 = time.perf_counter()
    uniq = []
    for i in range(RMAT_WINDOW):
        hops = replay_khop_jax_ids(
            synth.indptr, synth.indices.__getitem__,
            batch_targets(synth, i, BATCH, 0), FANOUTS,
            key=rng.fold_in(rng.key(0), i))
        uniq.append(np.unique(np.concatenate([h.reshape(-1)
                                              for h in hops])))
    per_batch = max(u.size for u in uniq)
    union = int(np.unique(np.concatenate(uniq)).size)
    rows = (per_batch + union) // 2
    check(per_batch < rows < union,
          f"phase 24b: rows {rows}, batch {per_batch}, union {union}")
    b_runs = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-rmat-") as sdir:
        save_graph(synth, sdir)
        for pol in ("lru", "optimal"):
            window = RMAT_WINDOW if pol == "optimal" else 0
            d = PipelineSpec().to_dict()
            d["backend"]["name"] = "pallas"
            d["sampler"]["fanouts"] = list(FANOUTS)
            d["store"].update(kind="disk", path=sdir)
            spec = PipelineSpec.from_dict(dict(
                d, cache_tiers=[dict(tier="host", policy=pol,
                                  capacity_mb=OOC_CACHE_MB, rows=0,
                                  edge_blocks=0, pinned_fraction=0.5,
                                  arrays=[], oracle_window=window),
                             dict(tier="device", policy=pol,
                                  capacity_mb=None, rows=rows,
                                  edge_blocks=0, pinned_fraction=0.5,
                                  arrays=["features"],
                                  oracle_window=window)],
                batch_size=BATCH, seed=0))
            b_runs[pol] = _train_spec(spec, synth, RMAT_STEPS)
    lru_b, opt_b = b_runs["lru"], b_runs["optimal"]
    _check_replay(opt_b["loader"].get("oracle"), "phase 24b")
    check(opt_b["losses"] == lru_b["losses"],
          f"phase 24b: losses optimal {opt_b['losses']} vs lru "
          f"{lru_b['losses']}")
    # the feature tier sees the same requests; the page cache serves its
    # misses, which the policy changes
    req_o, req_l = _tier_sums(opt_b["loader"]), _tier_sums(lru_b["loader"])
    check(req_o["devcache"] == req_l["devcache"],
          f"phase 24b: feature-tier requests {req_o} vs {req_l}")
    mo, ml = _misses(opt_b["loader"]), _misses(lru_b["loader"])
    for pol, r in b_runs.items():
        print(f"[smoke] phase 24b: {pol}: {r['stats'].steps_per_s:.4f} "
              f"steps/s, consumer idle {r['stats'].idle_fraction:.4f}, "
              f"misses {_misses(r['loader'])}, launches "
              f"{ {k: v for k, v in _gnn(r['launches']).items() if v} }")
    b_s = time.perf_counter() - t1
    print(f"[smoke] phase 24b: {synth.name}, batch {BATCH}, window "
          f"{RMAT_WINDOW}, {RMAT_STEPS} steps: unique rows a batch "
          f"{[int(u.size) for u in uniq]}, window union {union}, feature "
          f"tier {rows} rows; losses equal; misses optimal {mo} vs lru "
          f"{ml}; {b_s:.1f} s")
    check(mo["devcache"] <= ml["devcache"] and mo["store"] <= ml["store"],
          f"phase 24b: misses optimal {mo} above lru {ml}")
    out["b"] = {"rows": rows, "unique_per_batch": [int(u.size)
                                                   for u in uniq],
                "union": union, "seconds": b_s,
                **{pol: {"losses": r["losses"],
                         "steps_per_s": r["stats"].steps_per_s,
                         "idle_fraction": r["stats"].idle_fraction,
                         "misses": _misses(r["loader"]),
                         "requests": _tier_sums(r["loader"]),
                         "oracle": r["loader"].get("oracle"),
                         "launches": _gnn(r["launches"])}
                   for pol, r in b_runs.items()}}
    out["seconds"] = time.perf_counter() - t0
    return out


def host_phase(argv_mem: list, reddit, mem: dict, ooc: dict) -> dict:
    """Phase 24c: the host backend (numpy sampling and gathers in
    producer threads, copies to the card) at phase 5's width: in memory,
    over the disk store with phase 8's page cache, and with that cache
    optimal; one producer where counters are compared.  The model in
    float32 on the card and the CPU, TF32 off, as phase 19."""
    t0 = time.perf_counter()
    base = argv_mem[:argv_mem.index("--device")]
    base[base.index("--backend") + 1] = "host"
    base[base.index("--steps") + 1] = str(HOST_STEPS)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-host-") as tmp:
        one = os.path.join(tmp, "one_producer.json")
        d = PipelineSpec().to_dict()
        d["backend"].update(name="host", n_workers=1, straggler_factor=1e6)
        with open(one, "w") as f:
            f.write(PipelineSpec.from_dict(d).to_json())
        disk = ["--spec", one, *base, "--graph-store", "disk", "--cache-mb",
                str(OOC_CACHE_MB)]
        argvs = {"memory": base,
                 "disk lru": disk,
                 "disk optimal": disk + ["--cache-policy", "optimal",
                                         "--cache-oracle-window", "8"]}
        real_sage = train.GraphSAGE
        tf32 = torch.backends.cuda.matmul.allow_tf32
        train.GraphSAGE = functools.partial(real_sage,
                                            compute_dtype=torch.float32)
        torch.backends.cuda.matmul.allow_tf32 = False
        runs, recs = {}, {}
        try:
            for name, argv in argvs.items():
                print(f"[smoke] phase 24c: train {' '.join(argv)}")
                recs[name] = []
                runs[name] = _train_recorded(
                    argv + ["--device", DEVICE],
                    _recording_ids(build_pipeline, recs[name]))
            cpu_argv = base + ["--steps", str(HOST_CPU_STEPS)]
            _, cpu_losses, _ = train.main(cpu_argv + ["--device", "cpu"])
        finally:
            train.GraphSAGE = real_sage
            torch.backends.cuda.matmul.allow_tf32 = tf32
        for name, r in runs.items():
            check(not any(r["launches"].values()),
                  f"phase 24c {name}: launched {r['launches']}")
            check(len(r["losses"]) == HOST_STEPS
                  and all(math.isfinite(x) for x in r["losses"]),
                  f"phase 24c {name}: losses {r['losses']}")
            check(np.allclose(r["losses"][:HOST_CPU_STEPS], cpu_losses,
                              rtol=1e-4, atol=1e-4),
                  f"phase 24c {name}: losses {r['losses']} vs the CPU's "
                  f"{cpu_losses}")
            cpu = _cpu_batches(argvs[name], reddit, HOST_COMPARED)
            _same_batches(recs[name], cpu, f"phase 24c {name}")
        _check_replay(runs["disk optimal"]["loader"].get("oracle"),
                      "phase 24c")
        check(runs["disk optimal"]["losses"] == runs["disk lru"]["losses"],
              "phase 24c: losses optimal vs lru differ")
        # per consumed batch: the producer runs ahead of the consumer, so
        # the store's totals hold a varying number of later batches
        touched = {name: [(b["io"]["requests"],
                           b["io"]["hits"] + b["io"]["misses"])
                          for b in recs[name]]
                   for name in ("disk lru", "disk optimal")}
        check(touched["disk lru"] == touched["disk optimal"],
              f"phase 24c: page-cache requests a batch {touched}")
    for name, r in runs.items():
        st = r["stats"]
        # the page cache's misses over the consumed batches
        misses = (sum(b["io"]["misses"] for b in recs[name])
                  if recs[name][0]["io"] is not None else None)
        print(f"[smoke] phase 24c: host, {name}: {st.steps_per_s:.4f} "
              f"steps/s, consumer idle {st.idle_fraction:.4f}, mean "
              f"produce {r['loader']['mean_produce_s']:.3f} s, page-cache "
              f"misses {misses}; losses within 1e-4 of the CPU's "
              f"{cpu_losses}, batches 0-{HOST_COMPARED - 1} equal the "
              f"CPU's")
        out[name] = {"argv": argvs[name], "losses": r["losses"],
                     "steps_per_s": st.steps_per_s,
                     "idle_fraction": st.idle_fraction,
                     "mean_produce_s": r["loader"]["mean_produce_s"],
                     "misses_8_batches": misses,
                     "oracle": r["loader"].get("oracle")}
    print(f"[smoke] phase 24c: beside pallas in memory (phase 5) "
          f"{mem['steps_per_s']:.4f} steps/s, idle "
          f"{mem['idle_fraction']:.4f}, and out of core (phase 8) "
          f"{ooc['steps_per_s']:.4f}, idle {ooc['idle_fraction']:.4f}")
    out["cpu_losses"] = cpu_losses
    out["seconds"] = time.perf_counter() - t0
    return out


def _check_trace(trace_path: str, metrics_path: str, what: str) -> dict:
    """A telemetry-on run's files: a trace of complete and metadata events
    only, with the pipeline's spans (disk preads attributed to batches)
    and lane tracks, and a last JSONL snapshot with the store's and the
    device cache's counters.  Returns what the trace and snapshot hold."""
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    check({e["ph"] for e in events} <= {"X", "M"},
          f"{what}: event phases {sorted({e['ph'] for e in events})}")
    spans: dict = {}
    for e in events:
        if e["ph"] == "X":
            spans.setdefault(e["name"], []).append(e)
    missing = [n for n in OBS_SPANS if not spans.get(n)]
    check(not missing, f"{what}: no {missing} spans in {sorted(spans)}")
    check(any(e.get("args", {}).get("batch") is not None
              for e in spans["disk.pread"]),
          f"{what}: no disk.pread span carries its batch")
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    check(set(OBS_LANES) <= lanes, f"{what}: lanes {sorted(lanes)}")
    with open(metrics_path) as f:
        lines = f.read().splitlines()
    snap = json.loads(lines[-1])["metrics"]
    check(all(k in snap for k in OBS_METRICS)
          and snap["store.bytes_fetched"] > 0,
          f"{what}: last snapshot {sorted(snap)}")
    return {"spans": {k: len(v) for k, v in spans.items()},
            "lanes": sorted(lanes), "other": trace["otherData"],
            "trace_mb": os.path.getsize(trace_path) / 1e6,
            "snapshots": len(lines),
            "last_snapshot": {k: snap[k] for k in OBS_METRICS}}


def telemetry_phase(g, argv_ooc: list) -> dict:
    """Phase 25: phase 20's overlapped out-of-core command with telemetry
    on (``--trace-out/--metrics-out/--metrics-interval``) and off, one run
    of each in turns: losses repr-equal, the files whole, steps/s of
    each beside the other."""
    t0 = time.perf_counter()
    runs: dict = {"on": [], "off": []}
    files = []
    with tempfile.TemporaryDirectory(prefix="chip-smoke-obs-") as tmp:
        sdir = os.path.join(tmp, "store")
        save_graph(g, sdir)
        argv = argv_ooc + ["--io-threads", str(PREAD_THREADS[0]),
                           "--store-dir", sdir] + OVERLAP_FLAGS
        print(f"[smoke] phase 25: train {' '.join(argv)}, with and without "
              f"--trace-out/--metrics-out/--metrics-interval {OBS_INTERVAL}")
        for k, mode in enumerate(OBS_RUNS):
            extra = []
            if mode == "on":
                files.append((os.path.join(tmp, f"t{k}.json"),
                              os.path.join(tmp, f"m{k}.jsonl")))
                extra = ["--trace-out", files[-1][0], "--metrics-out",
                         files[-1][1], "--metrics-interval",
                         str(OBS_INTERVAL)]
            r = _train_recorded(argv + extra, build_pipeline)
            ls = r["loader"]
            check(ls["prefetch_restarts"] == 0 and ls["degraded"] is False,
                  f"phase 25 {mode}: {ls['prefetch_restarts']} restarts, "
                  f"degraded {ls['degraded']}")
            runs[mode].append(r)
        losses = runs["off"][0]["losses"]
        check(all(r["losses"] == losses for rs in runs.values() for r in rs),
              "phase 25: losses differ: "
              + str({m: [r["losses"] for r in rs] for m, rs in runs.items()}))
        held = [_check_trace(t, m, f"phase 25 run {k}")
                for k, (t, m) in enumerate(files)]
    launches = _gnn(runs["on"][0]["launches"])
    check(launches["neighbor_sample_cached"] > 0
          and launches["feature_gather_cached"] > 0
          and launches["feature_gather_rows"] > 0,
          f"phase 25: launches {launches}")
    sps = {m: [r["stats"].steps_per_s for r in rs] for m, rs in runs.items()}
    med = {m: statistics.median(v) for m, v in sps.items()}
    ratio = med["on"] / med["off"]
    print(f"[smoke] phase 25: losses repr-equal in all {len(OBS_RUNS)} "
          f"runs {losses}; "
          f"traces {[round(h['trace_mb'], 1) for h in held]} MB, spans "
          f"{[h['other']['spans'] for h in held]} (dropped "
          f"{[h['other']['dropped'] for h in held]}), "
          f"{held[0]['spans'].get('disk.pread')} disk.pread, snapshots "
          f"{[h['snapshots'] for h in held]}; launches with telemetry on "
          f"{launches}")
    print(f"[smoke] phase 25: steps/s telemetry on {sps['on']} (median "
          f"{med['on']:.4f}), off {sps['off']} (median {med['off']:.4f}): "
          f"ratio {ratio:.4f}")
    return {"argv": argv, "runs": OBS_RUNS, "losses": losses,
            "steps_per_s": sps, "median": med, "ratio": ratio,
            "idle_fraction": {m: [r["stats"].idle_fraction for r in rs]
                              for m, rs in runs.items()},
            "files": held, "launches": launches,
            "seconds": time.perf_counter() - t0}


def _keeping_procs(build, procs: list):
    """``build_pipeline`` over an isp store that keeps each pipeline's
    storage process in ``procs`` (its exit code is read after the run)."""
    def built(*a, **kw):
        pipe = build(*a, **kw)
        procs.append(pipe.store.server_proc)
        return pipe
    return built


def _recording_wire(build, into: list, procs: list):
    """``_recording`` over an isp store: each batch's record also keeps
    the client's wire counters just after it, and ``procs`` the storage
    processes."""
    rec = _keeping_procs(_recording(build, into), procs)

    def built(*a, **kw):
        pipe = rec(*a, **kw)
        get = pipe.get_batch

        def get_batch(idx, **kw2):
            mb = get(idx, **kw2)
            into[-1]["wire"] = pipe.store.isp_counters()
            return mb

        pipe.get_batch = get_batch
        return pipe
    return built


def _wire_line(lstats: dict) -> dict:
    """The run's wire totals beside the storage process's flash reads."""
    st = lstats["store"]
    return {"tx": st["isp"]["bytes_tx"], "rx": st["isp"]["bytes_rx"],
            "requests": st["isp"]["requests"],
            "flash": st["server"]["bytes_fetched"],
            "commands": st["server_wire"]["commands"]}


def isp_phase(reddit, argv_mem: list, argv_ooc: list, hosted: dict) -> dict:
    """Phase 26: the ISP service on the card.  a: phase 8's command over
    ``--store-mode isp`` against the local store; b: the host backend
    pushed down at phase 24c's width; c: the shm transport at the spec's
    width."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-isp-") as tmp:
        # a: the device caches fetch their misses over the wire
        sdir = os.path.join(tmp, "a")
        addr = isp_address(sdir)
        local_argv = argv_ooc + ["--store-dir", os.path.join(tmp, "local")]
        isp_argv = argv_ooc + ["--store-dir", sdir, "--store-mode", "isp"] \
            + (["--isp-address", addr] if addr else [])
        print(f"[smoke] phase 26a: train {' '.join(isp_argv)}")
        recs = {"local": [], "isp": []}
        procs: list = []
        loc = _train_recorded(local_argv, build_pipeline, recs["local"])
        isp = _train_recorded(isp_argv,
                              _recording_wire(build_pipeline, recs["isp"],
                                              procs))
        check(len(recs["isp"]) == 8 and len(recs["local"]) == 8,
              "phase 26a: 8 batches each")
        for a, b in zip(recs["local"], recs["isp"]):
            check(all(torch.equal(x, y)
                      for x, y in zip(a["tensors"], b["tensors"])),
                  f"phase 26a: batch {a['idx']} differs local vs isp")
        check(isp["losses"] == loc["losses"],
              f"phase 26a: losses isp {isp['losses']} vs local "
              f"{loc['losses']}")
        n = _gnn(isp["launches"])
        check(n["neighbor_sample_cached"] > 0
              and n["feature_gather_cached"] > 0
              and n == _gnn(loc["launches"]),
              f"phase 26a: launches isp {n} vs local "
              f"{_gnn(loc['launches'])}")
        check(procs and procs[0].returncode == 0,
              f"phase 26a: the storage process exited "
              f"{procs[0].returncode if procs else None}")
        # the CPU's run of the same command: batches 0-2's ids, trace.io
        # and the requests and bytes the client sent after each (the
        # replies' bytes hold the server's uptime in each STATS reply)
        spec = train.parse_args(isp_argv + ["--device", "cpu"]).pipeline_spec
        cpu = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            pipe = build_pipeline(spec, reddit, device="cpu")
        try:
            for i in range(HOST_COMPARED):
                mb = pipe.get_batch(i)
                cpu.append({"ids": [h.cpu() for h in mb.hop_ids],
                            "io": mb.trace.io,
                            "wire": pipe.store.isp_counters()})
        finally:
            pipe.close()
        for i, (c, b) in enumerate(zip(cpu, recs["isp"])):
            nh = len(c["ids"])
            check(all(torch.equal(x.cpu(), y)
                      for x, y in zip(b["tensors"][:nh], c["ids"]))
                  and b["io"] == c["io"],
                  f"phase 26a: batch {i}'s ids or counters card vs CPU")
            want = {k: c["wire"][k] for k in ("requests", "bytes_tx")}
            got = {k: b["wire"][k] for k in ("requests", "bytes_tx")}
            check(got == want, f"phase 26a: batch {i}'s wire card {got} "
                  f"vs CPU {want}")
        wire = _wire_line(isp["loader"])
        out["a"] = {"argv": isp_argv, "losses": isp["losses"],
                    "steps_per_s": isp["stats"].steps_per_s,
                    "idle_fraction": isp["stats"].idle_fraction,
                    "local_steps_per_s": loc["stats"].steps_per_s,
                    "launches": n, "wire": wire,
                    "wire_per_batch": [b["wire"] for b in recs["isp"]],
                    "cpu_wire": [c["wire"] for c in cpu]}
        del recs
        print(f"[smoke] phase 26a: 8 batches and losses equal the local "
              f"store's, batches 0-{HOST_COMPARED - 1}'s ids, counters and "
              f"sent wire equal the CPU's; launches {n}; "
              f"{isp['stats'].steps_per_s:.4f} steps/s (local "
              f"{loc['stats'].steps_per_s:.4f}), idle "
              f"{isp['stats'].idle_fraction:.4f}; wire tx {wire['tx']} B, "
              f"rx {wire['rx']} B against {wire['flash']} B from flash "
              f"(rx/flash {wire['rx'] / max(wire['flash'], 1):.4f}), "
              f"commands {wire['commands']}; server exit 0")

        # b: the host backend's k-hop sample and gather pushed down
        base = argv_mem[:argv_mem.index("--device")]
        base[base.index("--backend") + 1] = "host"
        base[base.index("--steps") + 1] = str(HOST_STEPS)
        one = os.path.join(tmp, "one_producer.json")
        d = PipelineSpec().to_dict()
        d["backend"].update(name="host", n_workers=1, straggler_factor=1e6)
        with open(one, "w") as f:
            f.write(PipelineSpec.from_dict(d).to_json())
        bdir = os.path.join(tmp, "b")
        addr = isp_address(bdir)
        argv_b = ["--spec", one, *base, "--graph-store", "disk",
                  "--cache-mb", str(OOC_CACHE_MB), "--store-dir", bdir,
                  "--store-mode", "isp"] + (["--isp-address", addr]
                                            if addr else [])
        print(f"[smoke] phase 26b: train {' '.join(argv_b)}")
        real_sage = train.GraphSAGE
        tf32 = torch.backends.cuda.matmul.allow_tf32
        train.GraphSAGE = functools.partial(real_sage,
                                            compute_dtype=torch.float32)
        torch.backends.cuda.matmul.allow_tf32 = False
        rec_b, procs_b = [], []
        try:
            r = _train_recorded(argv_b + ["--device", DEVICE],
                                _recording_ids(_keeping_procs(
                                    build_pipeline, procs_b), rec_b))
        finally:
            train.GraphSAGE = real_sage
            torch.backends.cuda.matmul.allow_tf32 = tf32
        check(not any(r["launches"].values()),
              f"phase 26b: launched {r['launches']}")
        check(r["losses"] == hosted["disk lru"]["losses"],
              f"phase 26b: losses {r['losses']} vs phase 24c's local "
              f"store {hosted['disk lru']['losses']}")
        _same_batches(rec_b, _cpu_batches(argv_b, reddit, HOST_COMPARED),
                      "phase 26b")
        check(procs_b and procs_b[0].returncode == 0,
              "phase 26b: the storage process did not exit 0")
        wire_b = _wire_line(r["loader"])
        st = r["stats"]
        out["b"] = {"argv": argv_b, "losses": r["losses"],
                    "steps_per_s": st.steps_per_s,
                    "idle_fraction": st.idle_fraction,
                    "mean_produce_s": r["loader"]["mean_produce_s"],
                    "local_steps_per_s": hosted["disk lru"]["steps_per_s"],
                    "wire": wire_b}
        print(f"[smoke] phase 26b: host backend pushed down: "
              f"{st.steps_per_s:.4f} steps/s, idle {st.idle_fraction:.4f}, "
              f"mean produce {r['loader']['mean_produce_s']:.3f} s, against "
              f"phase 24c's local store {hosted['disk lru']['steps_per_s']:.4f}"
              f"; losses equal 24c's, batches 0-{HOST_COMPARED - 1} equal the "
              f"CPU's; wire tx {wire_b['tx']} B, rx {wire_b['rx']} B against "
              f"{wire_b['flash']} B from flash; server exit 0")

        # c: the shared-memory rings at the spec's width
        _, flags = _spec_in(PipelineSpec.load(_spec_path(ISP_SPEC)),
                            ISP_SPEC, tmp)
        runs_c = {}
        for kind in ("unix", "shm"):
            procs_c: list = []
            extra = ["--isp-transport", "shm"] if kind == "shm" else []
            runs_c[kind] = _train_recorded(
                _spec_argv(ISP_SPEC, SPEC_STEPS, *flags, *extra),
                _keeping_procs(build_pipeline, procs_c))
            check(procs_c and procs_c[0].returncode == 0,
                  f"phase 26c: {kind}: the storage process did not exit 0")
        check(runs_c["shm"]["losses"] == runs_c["unix"]["losses"]
              and runs_c["shm"]["loader"]["store"]["transport"] == "shm",
              f"phase 26c: losses shm {runs_c['shm']['losses']} vs unix "
              f"{runs_c['unix']['losses']}")
        out["c"] = {k: {"losses": v["losses"],
                        "steps_per_s": v["stats"].steps_per_s,
                        "wire": _wire_line(v["loader"])}
                    for k, v in runs_c.items()}
        print(f"[smoke] phase 26c: {ISP_SPEC} over shm: losses equal unix's "
              f"{runs_c['shm']['losses']}, wire "
              f"{out['c']['shm']['wire']}; server exit 0")
    out["seconds"] = time.perf_counter() - t0
    print(f"[smoke] phase 26: {out['seconds']:.1f} s")
    return out


def _first_batch(build, into: dict):
    """``build_pipeline`` whose pipelines keep host copies of batch 0's
    hop ids and features in ``into`` (host copies: the card's peak
    memory stays the run's own)."""
    def built(*a, **kw):
        pipe = build(*a, **kw)
        get = pipe.get_batch

        def get_batch(idx, **kw2):
            mb = get(idx, **kw2)
            if idx == 0:
                into["ids"] = [h.cpu() for h in mb.hop_ids]
                into["feats"] = [f.cpu() for f in mb.hop_feats]
            return mb

        pipe.get_batch = get_batch
        return pipe
    return built


def mesh_phase(argv_mem: list, argv_ooc: list, ooc: dict) -> dict:
    """Phase 27: the mesh ISP backend at phase 5's width, 1 and 4 shards
    on the card, against the pallas backend; then phase 8's command with
    the isp storage engine attached."""
    t_phase = time.perf_counter()
    card = card_line()
    runs, first = {}, {}
    for name, shards in (("pallas", None), ("isp x1", 1), ("isp x4", 4)):
        argv = list(argv_mem)
        if shards is not None:
            argv[argv.index("--backend") + 1] = "isp"
            argv += ["--devices", str(shards)]
        print(f"[smoke] phase 27: train {' '.join(argv)}")
        first[name] = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = _train_recorded(argv, _first_batch(train.build_pipeline,
                                               first[name]))
        r["peak_bytes"] = torch.cuda.max_memory_allocated()
        runs[name] = r
    base = runs["pallas"]
    check(_gnn(base["launches"])["neighbor_sample"] == 2 * 8
          and _gnn(base["launches"])["feature_gather_rows"] == 3 * 8,
          f"phase 27: pallas launched {base['launches']}")
    for name in ("isp x1", "isp x4"):
        r = runs[name]
        check(r["loader"]["backend"] == "isp",
              f"phase 27 {name}: backend {r['loader']['backend']}")
        check(not any(r["launches"].values()),
              f"phase 27 {name}: launched {r['launches']}")
        check(r["losses"] == base["losses"],
              f"phase 27 {name}: losses {r['losses']} vs pallas "
              f"{base['losses']}")
        for kind in ("ids", "feats"):
            check(all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(first[name][kind],
                                      first["pallas"][kind])),
                  f"phase 27 {name}: batch 0's {kind} differ from pallas's")
    sps = {k: r["stats"].steps_per_s for k, r in runs.items()}
    peak = {k: r["peak_bytes"] for k, r in runs.items()}
    print(f"[smoke] phase 27: losses == pallas's at 1 and 4 shards "
          f"{base['losses']}; batch 0's ids and features bit-equal; no "
          f"kernel launched by isp; steps/s "
          + ", ".join(f"{k} {v:.4f}" for k, v in sps.items())
          + "; peak device memory "
          + ", ".join(f"{k} {v / 2**30:.3f} GiB" for k, v in peak.items())
          + f" ({card})")
    del first
    argv_e = argv_ooc + ["--storage-engine", "isp"]
    print(f"[smoke] phase 27: train {' '.join(argv_e)}")
    eng = _train_recorded(argv_e, train.build_pipeline)
    sim = eng["loader"]["simulated_storage_s"]
    check(sim > 0, f"phase 27: simulated_storage_s {sim}")
    check(eng["losses"] == ooc["losses"],
          f"phase 27: engine losses {eng['losses']} vs phase 8's "
          f"{ooc['losses']}")
    check(_gnn(eng["launches"]) == _gnn(ooc["launches"]),
          f"phase 27: engine launches {eng['launches']} vs phase 8's "
          f"{ooc['launches']}")
    out = {"card": card, "losses": base["losses"], "steps_per_s": sps,
           "peak_bytes": peak,
           "idle_fraction": {k: r["stats"].idle_fraction
                             for k, r in runs.items()},
           "engine": {"argv": argv_e, "simulated_storage_s": sim,
                      "steps_per_s": eng["stats"].steps_per_s,
                      "idle_fraction": eng["stats"].idle_fraction},
           "seconds": time.perf_counter() - t_phase}
    print(f"[smoke] phase 27: --storage-engine isp: simulated storage "
          f"{sim:.4f} s over the run, {eng['stats'].steps_per_s:.4f} "
          f"steps/s (phase 8 {ooc['steps_per_s']:.4f}), losses and "
          f"launches equal phase 8's ({card}); phase 27 "
          f"{out['seconds']:.1f} s")
    return out


def _sdpa(q, k, v, **kw):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) views, GQA by
    ``enable_gqa``.  Used on no path of the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw)


def _bf16_randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device=DEVICE).to(torch.bfloat16)


def flash_case(timer, gen, B, S, Hq, Hkv, D, count) -> dict:
    """flash_attention_fwd at (B, S, Hq, Hkv, D), causal: out within
    ATTN_OUT_TOL and lse within LSE_TOL of the plain version, timed beside
    it, ``scaled_dot_product_attention`` and the bound (the causal
    2*B*Hq*S^2*D flops at the bf16 tensor-core rate, or the q/k/v/o and lse
    bytes at HBM rate)."""
    q = _bf16_randn(gen, B, S, Hq, D)
    k, v = _bf16_randn(gen, B, S, Hkv, D), _bf16_randn(gen, B, S, Hkv, D)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    want, want_lse = ref.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    del want, want_lse
    check(err <= ATTN_OUT_TOL and lse_err <= LSE_TOL,
          f"flash_attention_fwd {(B, S, Hq, Hkv, D)}: out off by {err}, "
          f"lse by {lse_err}")
    flops = flash_fwd_ops(B, S, Hq, D)
    b, by = bound_ms(2 * B * S * D * (2 * Hq + 2 * Hkv) + 4 * B * Hq * S,
                     flops, BF16_OPS_PER_S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_err = float((_sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
                     .float() - out.float()).abs().max())
    check(lib_err <= ATTN_OUT_TOL, f"scaled_dot_product_attention "
          f"{(B, S, Hq, Hkv, D)} is off the kernel by {lib_err}")
    row = {"shape": [B, S, Hq, Hkv, D], "max_abs_err": err,
           "lse_err": lse_err, "count": count,
           "ms": timer(lambda: flash_attention_fwd(q, k, v, causal=True)),
           "plain_ms": timer(lambda: ref.flash_attention_fwd(q, k, v)),
           "library_ms": timer(lambda: _sdpa(qt, kt, vt, is_causal=True)),
           "bound_ms": b, "bound_by": by}
    row["tflops"] = flops / row["ms"] * 1e-9
    torch.cuda.empty_cache()
    return row


def enqueue_us(fn, calls: int = 200) -> float:
    """The host's time to enqueue one call, in microseconds: the host clock
    over ``calls`` calls with no synchronize between them, after a
    warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def decode_case(timer, q, k, v, valid_len, window, count) -> dict:
    """decode_attention over the (B, S, Hkv, D) cache: out within
    ATTN_OUT_TOL of the plain version, timed beside it, a masked
    ``scaled_dot_product_attention`` and the bound (the valid keys' K and V
    rows, q and out at HBM rate); the bytes' achieved rate and the host's
    enqueue time per call (``enqueue_us``)."""
    got = decode_attention(q, k, v, valid_len, window)
    want = ref.decode_attention(q, k, v, valid_len, window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(err <= ATTN_OUT_TOL, f"decode_attention valid_len {valid_len} "
          f"window {window}: off by {err}")
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    lo, hi = valid_range(S, valid_len, window)
    nbytes = 4 * B * (hi - lo) * Hkv * D + 4 * B * Hq * D
    b, by = bound_ms(nbytes, decode_ops(B, Hq, D, lo, hi), BF16_OPS_PER_S)
    mask = torch.zeros((1, 1, 1, S), dtype=torch.bool, device=DEVICE)
    mask[..., lo:hi] = True
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    lib_err = float((_sdpa(q4, kt, vt, attn_mask=mask)[:, :, 0].float()
                     - got.float()).abs().max())
    check(lib_err <= ATTN_OUT_TOL, f"scaled_dot_product_attention over the "
          f"cache (valid_len {valid_len}, window {window}) is off the "
          f"kernel by {lib_err}")
    row = {"shape": [B, S, Hq, Hkv, D], "valid_len": valid_len,
           "window": window, "max_abs_err": err, "count": count,
           "ms": timer(lambda: decode_attention(q, k, v, valid_len, window)),
           "plain_ms": timer(lambda: ref.decode_attention(
               q, k, v, valid_len, window)),
           "library_ms": timer(lambda: _sdpa(q4, kt, vt, attn_mask=mask)),
           "bound_ms": b, "bound_by": by,
           "host_us": enqueue_us(
               lambda: decode_attention(q, k, v, valid_len, window))}
    row["gb_per_s"] = nbytes / row["ms"] * 1e-6
    return row


def _rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|), in float32."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def flash_bwd_case(timer, gen, B, S, Hq, Hkv, D, causal, count) -> dict:
    """flash_attention_bwd_dq and flash_attention_bwd_dkv at (B, S, Hq,
    Hkv, D), on the forward kernel's ``out`` and ``lse`` and a random
    incoming gradient: dq, dk and dv within GRAD_REL_TOL and delta within
    DELTA_REL_TOL of the plain version, each kernel timed beside its plain
    half, the backward of ``scaled_dot_product_attention`` for the same
    gradients and its bound.  Bounds count the (query, key) pairs this
    mask keeps: the dQ kernel's function needs 3 products (s, dp, dq) of
    2 * pairs * D flops per query head, the dK/dV kernel's 4 (s, dp, dv,
    dk), a fused backward 5 (``pair_bound_ms``)."""
    q = _bf16_randn(gen, B, S, Hq, D)
    k, v = _bf16_randn(gen, B, S, Hkv, D), _bf16_randn(gen, B, S, Hkv, D)
    do = _bf16_randn(gen, B, S, Hq, D)
    out, lse = flash_attention_fwd(q, k, v, causal=causal)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, causal=causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    want = ref.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    want_delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    torch.cuda.synchronize()
    errs = {n: _rel_err(g, w) for n, g, w in
            zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    errs["delta"] = _rel_err(delta, want_delta)
    del want, want_delta
    check(all(e[1] <= GRAD_REL_TOL for e in errs.values())
          and errs["delta"][1] <= DELTA_REL_TOL,
          f"flash backward {(B, S, Hq, Hkv, D, causal)}: (max abs, "
          f"relative) errors {errs}")
    # the library yardstick: SDPA's backward on (B, H, S, D) views
    leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    lib_out = _sdpa(*leaves, is_causal=causal)
    do_t = do.transpose(1, 2)

    def lib(which):
        return torch.autograd.grad(lib_out, [leaves[i] for i in which], do_t,
                                   retain_graph=True)

    lib_errs = [_rel_err(g.transpose(1, 2), w)[1] for g, w in
                zip(lib((0, 1, 2)), (dq, dk, dv))]
    check(max(lib_errs) <= LIB_GRAD_REL_TOL, f"the backward of "
          f"scaled_dot_product_attention {(B, S, Hq, Hkv, D, causal)} is "
          f"off the kernels by {lib_errs} of their largest entries")
    product = flash_product(B, S, Hq, D, causal)
    rows = 4 * B * Hq * S                      # one float32 per query row
    qo_bytes, kv_bytes = 2 * B * S * Hq * D, 2 * B * S * Hkv * D
    # dQ: reads q, k, v, out, do, lse; writes dq and delta
    b_dq, by_dq = bound_ms(4 * qo_bytes + 2 * kv_bytes + 2 * rows,
                           3 * product, BF16_OPS_PER_S)
    # dK/dV: reads q, k, v, do, lse, delta; writes dk and dv
    b_kv, by_kv = bound_ms(2 * qo_bytes + 4 * kv_bytes + 2 * rows,
                           4 * product, BF16_OPS_PER_S)
    pair, _ = bound_ms(4 * qo_bytes + 4 * kv_bytes + rows, 5 * product,
                       BF16_OPS_PER_S)
    common = {"shape": [B, S, Hq, Hkv, D], "causal": causal, "count": count,
              "errors": errs, "library_rel_errs": lib_errs,
              "pair_bound_ms": pair}
    rows_out = {
        "flash_attention_bwd_dq": dict(
            common, max_abs_err=errs["dq"][0],
            ms=timer(lambda: flash_attention_bwd_dq(
                q, k, v, out, lse, do, causal=causal)),
            plain_ms=timer(lambda: ref.flash_attention_bwd_dq(
                q, k, v, out, lse, do, causal=causal)),
            library_ms=timer(lambda: lib((0,))),
            bound_ms=b_dq, bound_by=by_dq),
        "flash_attention_bwd_dkv": dict(
            common, max_abs_err=max(errs["dk"][0], errs["dv"][0]),
            ms=timer(lambda: flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal=causal)),
            plain_ms=timer(lambda: ref.flash_attention_bwd_dkv(
                q, k, v, out, lse, do, causal=causal)),
            library_ms=timer(lambda: lib((1, 2))),
            bound_ms=b_kv, bound_by=by_kv)}
    for kname, n_products in (("flash_attention_bwd_dq", 3),
                              ("flash_attention_bwd_dkv", 4)):
        row = rows_out[kname]
        row["tflops"] = n_products * product / row["ms"] * 1e-9
    del leaves, lib_out
    torch.cuda.empty_cache()
    return rows_out


def ssd_case(timer, x, dt, A, B, C, chunk, count, what) -> dict:
    """ssd_chunk_scan on (x, dt, A, B, C): y and the final state within
    SSD_REL_TOL of the plain version's largest entries, timed beside it,
    each of its two grids' mean device time over as many calls, and its
    bound: the four products (C.B^T over n, once per group, and the
    scored x over p, per head, on the i >= j half of each chunk; the
    chunk states and the inter-chunk term, each q x p x n per head) three
    times over (3xTF32) at the TF32 tensor-core rate, or the inputs and
    outputs at HBM rate; the products and the state pass at the scalar
    float32 rate are kept beside it as the old bound's kind.  No single
    PyTorch call computes it (library: none)."""
    y, st = ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    want_y, want_st = ref.ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)
    torch.cuda.synchronize()
    errs = {"y": _rel_err(y, want_y), "final_state": _rel_err(st, want_st)}
    del want_y, want_st
    check(all(math.isfinite(e[0]) and e[1] <= SSD_REL_TOL
              for e in errs.values()),
          f"ssd_chunk_scan {what}: (max abs, relative) errors {errs}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // chunk
    products = ssd_products(b, s, h, p, g, n, chunk)
    nbytes = 4 * (2 * x.numel() + dt.numel() + A.numel() + B.numel()
                  + C.numel() + st.numel())
    bnd, by = bound_ms(nbytes, 3 * products, TF32_OPS_PER_S)
    scalar_bnd, _ = bound_ms(nbytes, products + b * h * nc * 3 * p * n)

    def call():
        return ssd_chunk_scan(x, dt, A, B, C, chunk=chunk)

    def calls():
        for _ in range(timer.reps):
            timer.flush.zero_()
            call()

    calls()
    prof = device_profile(calls, timer.reps)
    grid_ms = {}
    for label, name in (("states", "ssd_state_kernel"),
                        ("output", "ssd_output_kernel")):
        hits = [k for k in prof["by_kernel_ms_per_step"] if name in k]
        check(len(hits) == 1 and prof["by_kernel_count"][hits[0]] == 1,
              f"profile of {what}: {name} {hits}")
        grid_ms[label] = prof["by_kernel_ms_per_step"][hits[0]]
    ms = timer(call)
    row = {"shape": [b, s, h, p, g, n, chunk], "inputs": what,
           "max_abs_err": max(e[0] for e in errs.values()), "errors": errs,
           "count": count, "ms": ms, "grid_ms": grid_ms,
           "tflops": products / ms * 1e-9, "gflop": products * 1e-9,
           "plain_ms": timer(lambda: ref.ssd_chunk_scan(x, dt, A, B, C,
                                                        chunk=chunk)),
           "library_ms": None, "bound_ms": bnd, "bound_by": by,
           "scalar_bound_ms": scalar_bnd}
    torch.cuda.empty_cache()
    return row


def ssd_model_inputs(arch: str) -> tuple:
    """The scan's inputs of layer 0's SSM mixer in the serve entry point's
    model (``--full-config``, weights from seed 0 cast to bf16) at its
    prompt (batch SERVE_BATCH, SERVE_PROMPT tokens): (x, dt, A, B, C) as
    ``models.ssm.apply_ssm`` hands them to the kernel, and the chunk."""
    cfg = get_config(arch)
    model = LM(cfg, init_params(build_defs(cfg), seed=0, device=DEVICE,
                                dtype=COMPUTE_DTYPE))
    batch = make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, kind="prefill",
                       device=DEVICE)
    p = model._layer(0)
    with torch.no_grad():
        h = rmsnorm(model._embed(batch["tokens"]),
                    p["ssm_norm" if cfg.family == "ssm" else "attn_norm"],
                    cfg.norm_eps)
        _, _, xs, B, C, dt, A = ssm.ssm_scan_inputs(
            p, h, n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
            d_conv=cfg.d_conv, n_groups=cfg.ssm_groups)
        out = tuple(t.float().contiguous() for t in (xs, dt, A, B, C))
    del model
    torch.cuda.empty_cache()
    return out, cfg.ssm_chunk


def ssd_kernel_cases(timer, gen) -> list:
    """Phase 3, the SSD kernel: at each SSM arch's layer-0 mixer inputs
    (mamba2-370m's, counted once a layer in its prefill; hymba-1.5b's)
    and at SSD_GROUP_CASE, SSD_RAGGED_CASES and SSD_TP_CASE on seeded
    random inputs (dt = |N| * 0.1, A = -|N|, as the reference's sweep
    draws them)."""
    rows = []
    for i, arch in enumerate(SSM_GEN):
        args, chunk = ssd_model_inputs(arch)
        rows.append(ssd_case(timer, *args, chunk,
                             get_config(arch).num_layers if i == 0 else 0,
                             f"{arch} layer 0"))
        del args
    for case, what in ((SSD_GROUP_CASE, "random"),
                       *((c, "ragged") for c in SSD_RAGGED_CASES),
                       (SSD_TP_CASE, "mamba2-370m, 16 heads a rank")):
        b, s, h, p, g, n, chunk = case
        x = torch.randn(b, s, h, p, generator=gen, device=DEVICE)
        dt = torch.randn(b, s, h, generator=gen, device=DEVICE).abs() * 0.1
        A = -torch.randn(h, generator=gen, device=DEVICE).abs()
        B = torch.randn(b, s, g, n, generator=gen, device=DEVICE)
        C = torch.randn(b, s, g, n, generator=gen, device=DEVICE)
        rows.append(ssd_case(timer, x, dt, A, B, C, chunk, 0, what))
    return rows


def lm_kernel_phase(timer) -> dict:
    """Phase 3, the LM's kernels: flash_attention_fwd at FLASH_CASES,
    decode_attention at DECODE_SHAPE x DECODE_CASES and at
    MOE_DECODE_SHAPE, the two flash backward kernels at FLASH_BWD_CASES
    and ssd_chunk_scan (``ssd_kernel_cases``), each against its plain
    version.  ``count`` is the launches per prefill (flash forward, at
    qwen2-0.5b's serve entry point's shape; the SSD kernel, in
    mamba2-370m's), per decode step (decode, qwen2-0.5b's full cache) and
    per training step (the backward kernels, at the train entry point's
    shape); the moonshot, qwen2-vl and seamless cases count 0 in those
    sums (their launches are phases 28's and 29's)."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    layers = get_config(LM_ARCH).num_layers
    flash = [flash_case(timer, gen, *shape, count=layers if i == 0 else 0)
             for i, shape in enumerate(FLASH_CASES)]
    B, S, Hq, Hkv, D = DECODE_SHAPE
    q = _bf16_randn(gen, B, Hq, D)
    k, v = _bf16_randn(gen, B, S, Hkv, D), _bf16_randn(gen, B, S, Hkv, D)
    dec = [decode_case(timer, q, k, v, vl, w,
                       count=layers if (vl, w) == (S, 0) else 0)
           for vl, w in DECODE_CASES]
    for (B, S, Hq, Hkv, D), valid, window in (
            [(MOE_DECODE_SHAPE, MOE_DECODE_VALID, 0)] + MM_DECODE_CASES):
        q = _bf16_randn(gen, B, Hq, D)
        k, v = _bf16_randn(gen, B, S, Hkv, D), _bf16_randn(gen, B, S, Hkv, D)
        dec.append(decode_case(timer, q, k, v, valid, window, count=0))
        del q, k, v
    torch.cuda.empty_cache()
    cases = {"flash_attention_fwd": flash, "decode_attention": dec,
             "flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    for i, shape in enumerate(FLASH_BWD_CASES):
        for kname, row in flash_bwd_case(
                timer, gen, *shape, count=layers if i == 0 else 0).items():
            cases[kname].append(row)
    cases["ssd_chunk_scan"] = ssd_kernel_cases(timer, gen)
    for kname, rows in cases.items():
        for c in rows:
            if "lse_err" in c:
                extra = f"lse_err {c['lse_err']:g}"
            elif "inputs" in c:
                rel = {n: float(f"{e[1]:.3g}") for n, e in c["errors"].items()}
                extra = f"{c['inputs']} relative errors {rel}"
            elif "causal" in c:
                rel = {n: round(e[1], 6) for n, e in c["errors"].items()}
                extra = (f"causal {c['causal']} relative errors {rel} "
                         f"pair bound {c['pair_bound_ms']:.4f} ms")
            else:
                extra = (f"valid_len {c['valid_len']} window {c['window']} "
                         f"{c['gb_per_s']:.0f} GB/s, host enqueue "
                         f"{c['host_us']:.1f} us a call")
            if "tflops" in c:
                extra += f"  {c['tflops']:.1f} TFLOP/s"
            if "grid_ms" in c:
                extra += (f"  grids {c['grid_ms']}  scalar bound "
                          f"{c['scalar_bound_ms']:.4f} ms")
            lib = ("-" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f}")
            print(f"[smoke]   {kname:20s} {str(c['shape']):24s} kernel "
                  f"{c['ms']:.4f} ms  plain {c['plain_ms']:.4f} ms  library "
                  f"{lib} ms  bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})  max_abs_err {c['max_abs_err']:g}  "
                  f"{extra}  x{c['count']}")
    # both backward rows' library time is one whole SDPA backward (dq, dk
    # and dv from one graph): the pair of kernels against it
    for dq, kv in zip(cases["flash_attention_bwd_dq"],
                      cases["flash_attention_bwd_dkv"]):
        print(f"[smoke]   flash backward pair {str(dq['shape']):24s} dq + "
              f"dK/dV {dq['ms'] + kv['ms']:.4f} ms, one SDPA backward "
              f"{dq['library_ms']:.4f} / {kv['library_ms']:.4f} ms, fused "
              f"bound {dq['pair_bound_ms']:.4f} ms")
    return cases


def _greedy(model, batch, prompt: int, gen: int, device, feed=None,
            keep=None, caches=None):
    """Prefill + ``gen - 1`` greedy serve steps; returns the ids (B, gen)
    and each step's logits on the CPU.  With ``feed`` (B, gen) ids, the
    steps take those tokens instead of their own picks.  ``keep`` (a
    dict) receives a CPU copy of the prefill cache's cross K/V, if it
    has them.  ``caches`` (a list) receives a CPU copy of the cache each
    step starts from; given one that holds another run's, each step
    starts from a copy of that run's cache instead of its own."""
    prefill = build_prefill_step(model, prompt + gen)
    step = build_serve_step(model)
    logits, cache = prefill({k: v.to(device) for k, v in batch.items()})
    if keep is not None:
        keep.update({k: cache[k].cpu() for k in ("cross_k", "cross_v")
                     if k in cache})
    given = list(caches) if caches else None
    tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]
    ids, all_logits = [tok], [logits.cpu()]
    for i in range(gen - 1):
        if feed is not None:
            tok = feed[:, i:i + 1].to(device)
        if given is not None:
            cache = {k: v.to(device, copy=True) for k, v in given[i].items()}
        elif caches is not None:
            caches.append({k: v.to("cpu", copy=True)
                           for k, v in cache.items()})
        logits, cache, nxt = step(tok, cache, prompt + i)
        tok = nxt[:, None]
        ids.append(tok)
        all_logits.append(logits.cpu())
    return torch.cat(ids, dim=1).cpu(), all_logits


def _first_layers(arch: str, impl: str, dtype=None,
                  layers: int = PARITY_LAYERS):
    """(cfg, weights): ``arch`` at full width cut to ``layers`` layers
    (and ``layers`` encoder layers, for encdec), ``attn_impl=impl``, and
    its seed-0 weights drawn on the card in ``dtype`` (default float32):
    the full model's first ``layers`` layers of each stack, at its
    depth's scales (the reference scales a stacked leaf over its default
    fan-in axis, the layers, by 1/sqrt(num_layers))."""
    full = get_config(arch)
    enc = layers if full.encoder_layers else 0
    cfg = dataclasses.replace(full, num_layers=layers,
                              encoder_layers=enc, attn_impl=impl)
    return cfg, init_params(build_defs(full), seed=0, device=DEVICE,
                            dtype=dtype, layers=layers,
                            enc_layers=enc or None)


def _moe_kw(cfg) -> dict:
    return dict(top_k=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor, routing=cfg.routing,
                groups=cfg.moe_groups)


def _moe_prefill(cfg, model, tokens, device, twin=None) -> dict:
    """The prefill of ``tokens`` through ``model`` on ``device``, layer by
    layer as ``transformer._apply_block`` runs it: each layer's
    ``moe.route`` of its MoE input (the normalized residual after its
    attention), and the last position's logits.  With ``twin`` (the same
    model on the CPU), each layer's MoE and the logits also run on the
    CPU on this run's inputs: the twin's routes, both MoE outputs, the
    CPU's float32 router scores and the twin's logits."""
    kw, act = _moe_kw(cfg), activation(cfg.act)
    out = {"routes": [], "twin_routes": [], "moe": [], "twin_moe": [],
           "scores": []}
    with torch.no_grad():
        x = model._embed(tokens.to(device))
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=device)
        for i, window in enumerate(model._windows):
            p = model._layer(i)
            x = x + transformer._attn_block(cfg, p, x, pos, window)[0]
            h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
            y = moe.apply_moe(p, h, act=act, **kw)[0]
            out["routes"].append(moe.route(p["router"], h, **kw))
            if twin is not None:
                q, hc = twin._layer(i), h.cpu()
                out["moe"].append(y.cpu())
                out["twin_moe"].append(moe.apply_moe(q, hc, act=act,
                                                     **kw)[0])
                out["twin_routes"].append(moe.route(q["router"], hc, **kw))
                logits = hc.reshape(-1, hc.shape[-1]).float() \
                    @ q["router"].float()
                out["scores"].append(logits if cfg.routing == "softmax"
                                     else torch.sigmoid(logits))
            x = x + y
        out["logits"] = model._logits(x[:, -1:]).cpu()
        if twin is not None:
            out["twin_logits"] = twin._logits(x[:, -1:].cpu())
    return out


def _routed_apart(a, b) -> torch.Tensor:
    """Per token, whether routes ``a`` and ``b`` differ in an expert id or
    a keep flag."""
    ea, eb = a.expert_idx.cpu(), b.expert_idx.cpu()
    return ((ea != eb).any(-1) | (a.keep.cpu() != b.keep.cpu()).view_as(
        ea).any(-1)).reshape(-1)


def _moe_layers_case(cfg, card, cpu, tokens) -> dict:
    """The card's prefill of ``tokens``, each layer's MoE and the logits
    also run on the CPU on the same input (the card's normalized residual
    after that layer's attention; the card's last residual): in every
    layer the expert ids equal but at near-ties of the CPU's float32
    router scores (ROUTER_TIE_TOL; counted); with none, the keep flags and
    the (G, E, C) slot table bit-equal; the output, on the tokens routed
    alike, within MOE_OUT_ATOL plus one bf16 ulp of the entry; the logits
    within LOGIT_TOL.  Then the CPU's own prefill: the tokens each layer
    of the two runs routes apart, counted (a near-tie that the two runs'
    rounding tips, which moves a token by O(1))."""
    run = _moe_prefill(cfg, card, tokens, DEVICE, twin=cpu)
    own = _moe_prefill(cfg, cpu, tokens, "cpu")
    k = cfg.experts_per_token
    res = {"near_ties": [], "max_out_err": [], "slots_equal": [],
           "dropped": []}
    for i, (rc, rp, yc, yp, scores) in enumerate(zip(
            run["routes"], run["twin_routes"], run["moe"], run["twin_moe"],
            run["scores"])):
        ec = rc.expert_idx.cpu().reshape(-1, k)
        ep = rp.expert_idx.reshape(-1, k)
        differ = (ec != ep).any(-1)
        for t in differ.nonzero()[:, 0].tolist():
            j = int((ec[t] != ep[t]).nonzero()[0, 0])
            gap = abs(float(scores[t, ec[t, j]] - scores[t, ep[t, j]]))
            check(gap <= ROUTER_TIE_TOL, f"{cfg.name} layer {i} on equal "
                  f"inputs: token {t} routed to expert {int(ec[t, j])} on "
                  f"the card and {int(ep[t, j])} on the CPU, {gap:g} apart "
                  "in the CPU's scores")
        slots_equal = torch.equal(rc.slot_tok.cpu(), rp.slot_tok)
        if not differ.any():
            check(torch.equal(rc.keep.cpu(), rp.keep) and slots_equal,
                  f"{cfg.name} layer {i} on equal inputs: the same expert "
                  "ids, other keep flags or slot tables")
        alike = ~_routed_apart(rc, rp)
        d = yp.shape[-1]
        oc = yc.float().reshape(-1, d)[alike]
        op = yp.float().reshape(-1, d)[alike]
        err = (oc - op).abs()
        check(bool((err <= MOE_OUT_ATOL + 2**-7 * op.abs()).all()),
              f"{cfg.name} layer {i} on equal inputs: MoE outputs of tokens "
              f"routed alike differ by up to {float(err.max())}")
        res["near_ties"].append(int(differ.sum()))
        res["max_out_err"].append(float(err.max()))
        res["slots_equal"].append(slots_equal)
        res["dropped"].append(int((~rp.keep).sum()))
    logit_err = float((run["logits"] - run["twin_logits"]).abs().max())
    check(logit_err <= LOGIT_TOL, f"{cfg.name} on equal inputs: logits "
          f"differ by {logit_err}")
    return {**res, "tokens": int(tokens.numel()),
            "assignments": int(tokens.numel()) * k,
            "max_logit_diff": logit_err,
            "prefill_routed_apart": [
                int(_routed_apart(a, b).sum())
                for a, b in zip(run["routes"], own["routes"])]}


def _greedy_pair(cfg, card_params, params, prompt: int, keep=None,
                 from_card_cache: bool = False, calls=None):
    """Greedy serving of ``cfg`` on the card (bf16 weights
    ``card_params``) and on the CPU's plain path (their copy ``params``),
    batch PARITY_BATCH, ``prompt`` tokens, PARITY_GEN tokens, the CPU fed
    the card's ids, so every step's logits compare like with like: the
    card's ids, both runs' logits and each step's largest difference.
    ``keep`` (a dict) receives each device's prefill cross K/V under
    "card" and "cpu", and ``calls`` (a dict) each device's decode
    attention calls (``_DecodeCalls``) under the same keys.  With
    ``from_card_cache``, each CPU step starts from a copy of the cache
    the card's step started from and takes the card's attention outputs
    (keeping its own), so each step's logits differ by that step's
    rounding outside attention only."""
    keep = {} if keep is None else keep
    keep.update(card={}, cpu={})
    if calls is not None:
        calls.update(card=[], cpu=[])
    caches = [] if from_card_cache else None
    batch = make_batch(cfg, PARITY_BATCH, prompt, kind="prefill")
    with _DecodeCalls(calls and calls["card"]):
        ids, card_logits = _greedy(LM(cfg, card_params), batch, prompt,
                                   PARITY_GEN, DEVICE, keep=keep["card"],
                                   caches=caches)
    with _DecodeCalls(calls and calls["cpu"], replay=calls and calls[
            "card"] if from_card_cache else None):
        _, cpu_logits = _greedy(LM(cfg, params), batch, prompt, PARITY_GEN,
                                "cpu", feed=ids, keep=keep["cpu"],
                                caches=caches)
    torch.cuda.empty_cache()
    return ids, card_logits, cpu_logits, [
        float((a - b).abs().max()) for a, b in zip(card_logits, cpu_logits)]


def _near_tie_picks(ids, card_logits, cpu_logits, tag: str,
                    first: int = 0) -> int:
    """The card's logits finite, and its greedy ids from step ``first``
    on the CPU's argmax of the same step, except where the CPU's top two
    logits lie within LOGIT_TOL of each other (bf16 logits over a
    vocabulary of tens of thousands of words tie) and the card's pick is
    within LOGIT_TOL of the CPU's maximum: the count of such picks."""
    check(all(torch.isfinite(a).all() for a in card_logits),
          f"serve parity ({tag}): non-finite logits on the card")
    ties = 0
    for t, b in enumerate(cpu_logits):
        if t < first:
            continue
        top = torch.topk(b[:, -1], 2).values
        cpu_ids = torch.argmax(b[:, -1], -1)
        for r in range(PARITY_BATCH):
            if int(ids[r, t]) == int(cpu_ids[r]):
                continue
            ties += 1
            check(float(top[r, 0] - top[r, 1]) <= LOGIT_TOL and
                  float(b[r, -1, int(ids[r, t])]) >= float(top[r, 0])
                  - LOGIT_TOL,
                  f"serve parity ({tag}): step {t} row {r} card picks "
                  f"{int(ids[r, t])}, CPU {int(cpu_ids[r])}")
    return ties


class _DecodeCalls:
    """While installed, each ``decode_attention_local`` call of the LM's
    decode step is appended to ``calls`` (if it is a list): its inputs
    and output, copied to the CPU.  With ``replay`` (such a list from
    another run), call n returns replay's output n in place of its own
    (which it keeps): the attention pinned to that run's."""

    def __init__(self, calls: list | None, replay: list | None = None):
        self.calls, self.replay = calls, replay

    def __enter__(self):
        self._real = transformer.decode_attention_local
        if self.calls is None:
            return self

        def keeping(q, k, v, valid_len, *, window=0):
            out = self._real(q, k, v, valid_len, window=window)
            self.calls.append({"q": q.cpu(), "k": k.cpu(), "v": v.cpu(),
                               "valid_len": int(valid_len),
                               "window": int(window), "out": out.cpu()})
            if self.replay is not None:
                out = self.replay[len(self.calls) - 1]["out"].to(
                    out.device, out.dtype)
            return out
        transformer.decode_attention_local = keeping
        return self

    def __exit__(self, *exc):
        transformer.decode_attention_local = self._real


def _serve_parity(cfg, card_params, params, prompt: int, tag: str,
                  from_card_cache: bool = False) -> dict:
    """``_greedy_pair``: every step's logits within LOGIT_TOL, the greedy
    ids equal up to ``_near_tie_picks``; the encdec family's prefill cross
    K/V within CACHE_REL_TOL of each layer's largest entry.  With
    ``from_card_cache`` (seamless: at seed-0 weights its attention is
    near argmax, so bf16 rounding that differs between the devices tips
    it, in the prefill and in each decode step), each CPU decode step
    starts from the card's cache and takes the card's attention outputs:
    the decode steps' logits and ids are held so, the prefill's logits
    and the CPU's own attention outputs are reported; and each decode
    attention call of the card's steps (self- and cross-attention, the
    cross K/V at the source's length and valid_len, no window) is held
    within DECODE_CALL_REL_TOL of the plain version on its own
    inputs."""
    keep, calls = {}, {} if from_card_cache else None
    ids, card_logits, cpu_logits, diffs = _greedy_pair(
        cfg, card_params, params, prompt, keep=keep,
        from_card_cache=from_card_cache, calls=calls)
    first = 1 if from_card_cache else 0
    held = diffs[first:]
    out = {"max_logit_diff": max(held), "step_logit_diff": diffs,
           "ids": ids.tolist()}
    check(max(held) <= LOGIT_TOL, f"serve parity ({tag}): card and CPU "
          f"logits differ by {held} (tolerance {LOGIT_TOL})")
    out["near_tie_picks"] = _near_tie_picks(ids, card_logits, cpu_logits,
                                            tag, first)
    if from_card_cache:
        out["prefill_logit_diff"] = diffs[0]
        errs, tols = [], []
        for c in calls["card"]:
            want = ref.decode_attention(c["q"], c["k"], c["v"],
                                        c["valid_len"], c["window"])
            errs.append(float((c["out"].float() - want.float()).abs().max()))
            tols.append(DECODE_CALL_REL_TOL
                        * float(c["v"][:, :c["valid_len"]].float().abs()
                                .max()))
        check(all(e <= t for e, t in zip(errs, tols)), f"serve parity "
              f"({tag}): decode attention calls off their plain version "
              f"by {errs} (tolerances {tols})")
        out["decode_call_err"], out["decode_call_tol"] = errs, tols
        out["cpu_own_call_diff"] = [
            float((a["out"].float() - b["out"].float()).abs().max())
            for a, b in zip(calls["card"], calls["cpu"])]
        if cfg.family == "encdec":
            # every layer's second call a step: the cross K/V at the
            # source's length, all of it valid, no window
            src = make_batch(cfg, PARITY_BATCH, prompt,
                             kind="prefill")["src_embeds"].shape[1]
            cross = calls["card"][1::2]
            check(len(calls["card"]) == 2 * cfg.num_layers
                  * (PARITY_GEN - 1)
                  and all((c["k"].shape[1], c["valid_len"], c["window"])
                          == (src, src, 0) for c in cross),
                  f"serve parity ({tag}): cross-attention decode calls "
                  f"over {[tuple(c['k'].shape) for c in cross]} at "
                  f"valid_len {[c['valid_len'] for c in cross]}, source "
                  f"length {src}")
            out["cross_call_err"] = errs[1::2]
    for name, card in keep["card"].items():
        cpu = keep["cpu"][name]
        errs = [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max()) for a, b in zip(card, cpu)]
        check(card.shape == cpu.shape and max(errs) <= CACHE_REL_TOL,
              f"serve parity ({tag}): {name} {tuple(card.shape)} against "
              f"{tuple(cpu.shape)}, per layer {errs} of the largest entry "
              f"(tolerance {CACHE_REL_TOL})")
        out[f"{name}_rel_err"] = errs
    return out


def serve_parity_phase() -> dict:
    """Phase 10: ``_serve_parity`` of LM_ARCH's first PARITY_LAYERS layers
    (``_first_layers``), prompt PARITY_PROMPT, both ``attn_impl``s."""
    out = {}
    for impl in ("flash", "chunked"):
        cfg, card_params = _first_layers(LM_ARCH, impl, COMPUTE_DTYPE)
        res = out[impl] = _serve_parity(
            cfg, card_params, tree_map(lambda t: t.cpu(), card_params),
            PARITY_PROMPT, impl)
        del card_params
        print(f"[smoke] phase 10 ({impl}): {PARITY_GEN} greedy ids x "
              f"{PARITY_BATCH} rows equal to the CPU's "
              f"({res['near_tie_picks']} near-tie picks), logits within "
              f"{res['max_logit_diff']:g} (tolerance {LOGIT_TOL}); card ids "
              f"{res['ids'][0]}")
    return out


def ssm_parity_phase() -> dict:
    """Phase 16: ``_serve_parity`` of each SSM arch's first PARITY_LAYERS
    layers (``_first_layers``; hymba's attention on the flash path), at
    each of SSM_PARITY_PROMPTS."""
    out = {}
    for arch in SSM_GEN:
        cfg, card_params = _first_layers(arch, "flash", COMPUTE_DTYPE)
        params = tree_map(lambda t: t.cpu(), card_params)
        for prompt in SSM_PARITY_PROMPTS:
            tag = f"{arch}, prompt {prompt}"
            res = out[tag] = _serve_parity(cfg, card_params, params, prompt,
                                           tag)
            print(f"[smoke] phase 16 ({tag}): {PARITY_GEN} greedy ids x "
                  f"{PARITY_BATCH} rows equal to the CPU's "
                  f"({res['near_tie_picks']} near-tie picks), logits within "
                  f"{res['max_logit_diff']:g} (tolerance {LOGIT_TOL}); card "
                  f"ids {res['ids'][0]}")
        del card_params, params
    return out


def serve_profile_phase(arch: str = LM_ARCH, gen: int = SERVE_GEN,
                        phase: int = 12) -> dict:
    """Phase 12 (and 18 for mamba2-370m), where serving's time goes: the
    entry point's model and prompt, a warm prefill timed then profiled
    once, and decode steps timed at steady state (16 steps after 2) then
    profiled (4 steps): device time by kernel and the device's busy
    share.  ``gen`` sizes the cache (22 steps fit when it is above 22)."""
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    model = LM(cfg, init_params(build_defs(cfg), seed=0, device=DEVICE,
                                dtype=COMPUTE_DTYPE))
    batch = make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, kind="prefill",
                       device=DEVICE)
    prefill = build_prefill_step(model, SERVE_PROMPT + gen)
    step = build_serve_step(model)
    prefill(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(batch)
    torch.cuda.synchronize()
    warm_prefill_ms = 1e3 * (time.perf_counter() - t0)
    pre = device_profile(lambda: prefill(batch), 1)
    tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]
    state = {"tok": tok, "pos": SERVE_PROMPT}

    def steps(n):
        for _ in range(n):
            _, _, nxt = step(state["tok"], cache, state["pos"])
            state["tok"] = nxt[:, None]
            state["pos"] += 1

    steps(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(16)
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t0) / 16
    dec = device_profile(lambda: steps(4), 4)
    print(f"[smoke] phase {phase}: {arch} warm prefill "
          f"{warm_prefill_ms:.3f} ms "
          f"(profiled {pre['profiled_ms_per_step']:.3f} ms, device busy "
          f"{pre['device_busy_ms_per_step']} ms, share "
          f"{pre['device_busy_share']}, {pre['device_ops_per_step']:.0f} "
          "device ops)")
    print_profile(pre)
    print(f"[smoke] phase {phase}: {arch} decode steady {steady_ms:.3f} "
          "ms/step "
          f"({SERVE_BATCH * 1e3 / steady_ms:.1f} tok/s); profiled "
          f"{dec['profiled_ms_per_step']:.3f} ms/step, device busy "
          f"{dec['device_busy_ms_per_step']} ms/step (share "
          f"{dec['device_busy_share']}), {dec['device_ops_per_step']:.0f} "
          "device ops/step")
    print_profile(dec)
    return {"warm_prefill_ms": warm_prefill_ms, "prefill": pre,
            "decode_steady_ms_per_step": steady_ms, "decode": dec}


def _train_one_step(cfg, params, batch, device, update: bool = True) -> dict:
    """A trainable LM of ``cfg`` on ``device`` from a copy of ``params``,
    one ``build_train_step`` step of AdamW (``warmup_cosine(1e-3, 10,
    50)``) on ``batch``: the step's loss, aux loss, grad norm and lr, the
    gradients it took (of the cross-entropy plus MOE_AUX_WEIGHT times the
    MoE aux loss, 0 outside the moe family; read as the optimizer gets
    them) and the parameters after it, on ``device`` (the leaf-wise
    comparisons run on the card: over a vocabulary table a round trip
    through the host takes seconds).  ``update`` False stops at the
    gradients and their global norm (no AdamW update, no parameters: a
    CPU's update over a vocabulary table takes 10-20 s on the card
    host)."""
    model = LM(cfg, tree_map(lambda t: t.to(device, copy=True), params),
               trainable=True)
    batch = {k: v.to(device) for k, v in batch.items()}
    schedule = warmup_cosine(1e-3, 10, 50)
    opt = adamw(schedule)
    state = init_train_state(model, opt)
    grads = []

    def recording(step_fn):
        def update_and_keep(tree, opt_state, params, step):
            grads.extend(g.detach().clone() for g in tree_leaves(tree))
            if update:
                return step_fn(tree, opt_state, params, step)
            norm = clip_by_global_norm(tree, MAX_GRAD_NORM)[1]
            return {"grad_norm": norm, "lr": torch.tensor(schedule(step))}
        return update_and_keep

    opt = dataclasses.replace(opt, update=recording(opt.update))
    state, m = build_lm_train_step(model, opt)(state, batch)
    return {"loss": float(m["loss"]), "moe_aux": float(m["moe_aux"]),
            "grad_norm": float(m["grad_norm"]),
            "lr": float(m["lr"]), "grads": grads,
            "params": ([p.detach() for p in tree_leaves(state["params"])]
                       if update else None)}


def _token_batch(cfg) -> dict:
    """TRAIN_PARITY_BATCH rows of TRAIN_PARITY_SEQ ``TokenPipeline``
    tokens, on the CPU."""
    return TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_PARITY_SEQ,
                         global_batch=TRAIN_PARITY_BATCH).torch_batch(0)


def _model_batch(cfg) -> dict:
    """``make_batch(kind="train")`` at TRAIN_PARITY_BATCH x
    MM_TRAIN_PARITY_SEQ, on the CPU: qwen2-vl's ``embeds``, seamless's
    tokens and ``src_embeds``."""
    return make_batch(cfg, TRAIN_PARITY_BATCH, MM_TRAIN_PARITY_SEQ,
                      kind="train")


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in the L2 norm."""
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _leaf_names(tree, prefix="") -> list:
    """The dotted names of a tree's leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def _staged_grads(model, batch, feed=None) -> dict:
    """The training loss of ``model`` (its cross-entropy; a family
    without the MoE aux loss) forward and then backward one stage at a
    time, each stage on detached inputs: the encoder's blocks and final
    norm (encdec), the embedding, the decoder's blocks, the head with the
    loss.  Each stage's backward takes its output's cotangent, summed
    over the stages that read it.  Returns, on the CPU, each stage's
    inputs, output cotangent and input gradients, the loss and the
    gradients of ``model.param_tree()``'s leaves.  With ``feed`` (such a return from
    another device), each stage takes feed's inputs and its backward
    feed's cotangent instead of its own: every stage's vector-Jacobian
    product on equal inputs, so rounding cannot build up across stages."""
    cfg, dev = model.cfg, model.embed.device
    stages = []     # (output, input leaves, the stage that made each input)

    def run(fn, *ins):
        k = len(stages)
        vals = [t for t, _ in ins] if feed is None else [
            t.to(dev) for t in feed["inputs"][k]]
        leaves = [t.detach().requires_grad_() for t in vals]
        stages.append((fn(*leaves), leaves, [src for _, src in ins]))
        return stages[-1][0].detach(), k

    enc = None
    if model.enc_cfg is not None:
        x = (batch["src_embeds"].to(dev, transformer.COMPUTE_DTYPE), None)
        src_pos = torch.arange(x[0].shape[1], dtype=torch.int32, device=dev)
        for i in range(cfg.encoder_layers):
            x = run(lambda h, i=i: model._enc_block(h, src_pos, i), x)
        enc = run(lambda h: rmsnorm(h, model.enc_final_norm, cfg.norm_eps),
                  x)
    inputs = batch.get("embeds", batch.get("tokens")).to(dev)
    x = run(lambda: model._embed(inputs))
    pos = torch.arange(x[0].shape[1], dtype=torch.int32, device=dev)
    for i in range(cfg.num_layers):
        x = run(lambda h, *e, i=i: model._train_block(
            h, pos, i, e[0] if e else None)[0], x, *([enc] if enc else []))
    labels = batch["labels"].to(dev)
    run(lambda h: cross_entropy(model._logits(h), labels), x)
    cots = [None] * len(stages)
    cots[-1] = torch.ones((), device=dev)
    record = {"inputs": [[t.detach().cpu() for t in leaves]
                         for _, leaves, _ in stages],
              "cotangents": [None] * len(stages),
              "input_grads": [None] * len(stages),
              "loss": float(stages[-1][0].detach())}
    for k in reversed(range(len(stages))):
        out, leaves, srcs = stages[k]
        cot = cots[k] if feed is None else feed["cotangents"][k].to(dev)
        record["cotangents"][k] = cot.cpu()
        if out.requires_grad:       # (not an ``embeds`` input's stage)
            torch.autograd.backward(out, cot)
        record["input_grads"][k] = [
            torch.zeros(leaf.shape) if leaf.grad is None
            else leaf.grad.cpu() for leaf in leaves]
        for leaf, src in zip(leaves, srcs):
            if src is not None:
                cots[src] = leaf.grad if cots[src] is None \
                    else cots[src] + leaf.grad
        stages[k] = None
    record["grads"] = [torch.zeros(t.shape) if t.grad is None
                       else t.grad.cpu()
                       for t in tree_leaves(model.param_tree())]
    return record


def _staged_parity(cfg, params, batch, tag: str, phase: str) -> dict:
    """``_staged_grads`` of ``cfg`` (weights ``params``) in the compute
    dtype on the card, then on the CPU fed the card's stage inputs and
    cotangents: the loss on equal inputs within TRAIN_LOSS_TOL, the grad
    norm within GRAD_NORM_REL_TOL, each leaf's gradient within
    TRAIN_GRAD_L2_TOL relative L2; the card's launches: with flash, the
    forward and each backward kernel once a decoder layer (the stages
    take no remat), the SSD kernel once a layer where the family has
    one."""
    kernels.reset_launches()
    card = _staged_grads(LM(cfg, tree_map(
        lambda t: t.to(DEVICE, copy=True), params), trainable=True), batch)
    launches = dict(kernels.LAUNCHES)
    torch.cuda.empty_cache()
    cpu = _staged_grads(LM(cfg, tree_map(lambda t: t.to("cpu", copy=True),
                                         params), trainable=True),
                        batch, feed=card)
    L = cfg.num_layers
    want = ({"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
             "flash_attention_bwd_dkv": L}
            if cfg.attn_impl == "flash" and cfg.family != "ssm" else {})
    if cfg.ssm_heads:
        want["ssd_chunk_scan"] = L
    for kname, n in launches.items():
        check(n == want.get(kname, 0), f"{tag}: {kname} launched {n} "
              f"times, not {want.get(kname, 0)}")
    names = _leaf_names(params)
    grad_l2 = [_rel_l2(a.to(DEVICE), b.to(DEVICE))
               for a, b in zip(card["grads"], cpu["grads"])]
    norms = [math.sqrt(sum(float(g.double().square().sum())
                           for g in r["grads"])) for r in (card, cpu)]
    # the gradients each stage's backward passed to its inputs
    passed = [_rel_l2(a.float(), b.float())
              for ga, gb in zip(card["input_grads"], cpu["input_grads"])
              for a, b in zip(ga, gb)]
    res = {"compute_dtype": str(transformer.COMPUTE_DTYPE), "staged": True,
           "stages": len(card["inputs"]), "loss": [card["loss"],
                                                   cpu["loss"]],
           "grad_norm": norms, "grad_rel_l2": grad_l2,
           "input_grad_rel_l2": passed, "launches": launches}
    worst = max(range(len(grad_l2)), key=lambda i: grad_l2[i])
    check(math.isfinite(card["loss"])
          and abs(card["loss"] - cpu["loss"]) <= TRAIN_LOSS_TOL,
          f"{tag}: losses on equal inputs {res['loss']}")
    check(abs(norms[0] - norms[1]) <= GRAD_NORM_REL_TOL * norms[1],
          f"{tag}: grad norms {norms}")
    check(grad_l2[worst] <= TRAIN_GRAD_L2_TOL,
          f"{tag}: the gradient of {names[worst]} differs by "
          f"{grad_l2[worst]} relative L2 (tolerance {TRAIN_GRAD_L2_TOL})")
    print(f"[smoke] phase {phase} ({cfg.name}, {cfg.attn_impl}, "
          f"{transformer.COMPUTE_DTYPE}, {res['stages']} stages each on "
          f"equal inputs): loss card {card['loss']:.6f} cpu "
          f"{cpu['loss']:.6f}, |g| card {norms[0]:.6f} cpu {norms[1]:.6f}; "
          f"gradients' relative L2 per leaf up to {grad_l2[worst]:.4g} "
          f"({names[worst]}); the stages' input gradients up to "
          f"{max(passed):.4g}; card launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    return res


def _train_parity(arch: str, phase: str, batch_fn=_token_batch,
                  staged: bool = False, layers: int = PARITY_LAYERS,
                  update: bool = True) -> dict:
    """One training step of ``arch``'s first ``layers`` layers
    (``_first_layers``) on the card against the CPU's plain path, equal
    float32 weights, on ``batch_fn(cfg)`` (default: TRAIN_PARITY_BATCH
    rows of TRAIN_PARITY_SEQ ``TokenPipeline`` tokens); a leaf the loss
    does not reach (qwen2-vl's ``embed`` under ``embeds``) has a zero
    gradient on both: ``attn_impl="chunked"`` in float32 activations on
    both sides (``transformer.COMPUTE_DTYPE``; TF32 off), and
    ``attn_impl="flash"`` as trained, in bf16 activations (the card's
    flash kernels take bf16).  The loss, the MoE aux loss and the grad
    norm within TRAIN_LOSS_TOL / GRAD_NORM_REL_TOL (bf16) or
    F32_TRAIN_REL_TOL (float32); each leaf's gradient within
    TRAIN_GRAD_L2_TOL or F32_GRAD_L2_TOL relative L2 distance; in
    float32 every parameter after the AdamW step within Adam's bound of
    2 lr (the bf16 step stops at its gradients: the update is the same
    float32 arithmetic on the master weights, and the CPU's over a
    vocabulary table costs 10-20 s on the card host; with ``update``
    False the float32 step stops there too, as phases 28d and 29d take
    it: phase 13 holds the update).  A
    control: the card's float32 step with TF32 products must fail those
    float32 checks, its grad norm or a leaf's gradient beyond its limit,
    or the check could not tell TF32 from float32 arithmetic (the
    router's product stays float32).  The card run's launches: with
    flash, the forward 2 a layer (the forward and its remat recompute)
    and each backward kernel 1; with chunked, none; the SSD kernel 2 a
    layer (forward and recompute) in the ssm and hybrid families on
    either path.  At random weights the query/key path's gradients are
    ill-conditioned (a near-uniform softmax), so rounding moves them
    further than the others and Adam's sign-like first step may take the
    other sign on their entries near 0; the share of such entries and
    the largest entry-wise difference are reported.  With ``staged``, the
    bf16 step is ``_staged_parity`` instead (every stage's backward on
    equal inputs): seamless's attention at seed-0 weights is near
    argmax, so bf16 rounding that tips it in one layer builds up across
    the next ones, on any two devices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for impl, dtype in (("chunked", torch.float32),
                        ("flash", torch.bfloat16)):
        cfg, params = _first_layers(arch, impl, layers=layers)
        batch = batch_fn(cfg)
        f32 = dtype == torch.float32
        tag = f"train parity ({arch}, {impl})"
        transformer.COMPUTE_DTYPE = dtype
        try:
            if staged and not f32:
                out[impl] = _staged_parity(cfg, params, batch, tag, phase)
                continue
            kernels.reset_launches()
            stepped = f32 and update
            card = _train_one_step(cfg, params, batch, DEVICE,
                                   update=stepped)
            launches = dict(kernels.LAUNCHES)
            torch.cuda.empty_cache()
            cpu = _train_one_step(cfg, params, batch, "cpu", update=stepped)
            if f32:     # the control: the card's step with TF32 products
                torch.backends.cuda.matmul.allow_tf32 = True
                tf32 = _train_one_step(cfg, params, batch, DEVICE,
                                       update=False)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            transformer.COMPUTE_DTYPE = COMPUTE_DTYPE
        L = layers
        want = ({"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
                 "flash_attention_bwd_dkv": L}
                if impl == "flash" and cfg.family != "ssm" else {})
        if cfg.ssm_heads:
            want["ssd_chunk_scan"] = 2 * L
        for kname, n in launches.items():
            check(n == want.get(kname, 0), f"{tag}: {kname} launched {n} "
                  f"times, not {want.get(kname, 0)}")
        lr = card["lr"]
        # the leaf-wise comparisons run on the card (copies of both
        # sides' leaves, one leaf at a time): over the vocabulary tables
        # they take tens of seconds on the card host's CPU
        names = _leaf_names(params)
        grad_l2, grad_max, param_err, beyond, unused = [], [], 0.0, 0.0, []
        tf32_l2 = []
        for i, (name, *leaves) in enumerate(zip(
                names, card["grads"], cpu["grads"])):
            ga, gb = (t.to(DEVICE) for t in leaves)
            grad_l2.append(_rel_l2(ga, gb))
            if f32:
                tf32_l2.append(_rel_l2(tf32["grads"][i], gb))
                tf32["grads"][i] = None
            grad_max.append(float((ga - gb).abs().max()
                                  / gb.abs().max().clamp_min(1e-30)))
            if not (ga.any() or gb.any()):
                unused.append(name)
            del ga, gb
            if stepped:
                diff = (card["params"][i].to(DEVICE)
                        - cpu["params"][i].to(DEVICE)).abs()
                param_err = max(param_err, float(diff.max()))
                beyond = max(beyond,
                             float((diff > 0.05 * lr).float().mean()))
                del diff
        check(unused == (["embed"] if "embeds" in batch else []),
              f"{tag}: leaves with a zero gradient {unused}")
        res = {"compute_dtype": str(dtype),
               "loss": [card["loss"], cpu["loss"]],
               "moe_aux": [card["moe_aux"], cpu["moe_aux"]],
               "grad_norm": [card["grad_norm"], cpu["grad_norm"]],
               "lr": lr, "grad_rel_l2": grad_l2, "grad_rel_max": grad_max,
               "max_param_diff": param_err if stepped else None,
               "max_share_beyond_5pct_lr": beyond if stepped else None,
               "launches": launches,
               "zero_grad_leaves": unused}
        out[impl] = res
        loss_tol = F32_TRAIN_REL_TOL * abs(cpu["loss"]) if f32 \
            else TRAIN_LOSS_TOL
        aux_tol = F32_TRAIN_REL_TOL * abs(cpu["moe_aux"]) if f32 \
            else TRAIN_LOSS_TOL
        norm_tol = (F32_TRAIN_REL_TOL if f32 else GRAD_NORM_REL_TOL) \
            * cpu["grad_norm"]
        l2_tol = F32_GRAD_L2_TOL if f32 else TRAIN_GRAD_L2_TOL
        check(math.isfinite(card["loss"])
              and abs(card["loss"] - cpu["loss"]) <= loss_tol,
              f"{tag}: losses {res['loss']}")
        check(abs(card["moe_aux"] - cpu["moe_aux"]) <= aux_tol,
              f"{tag}: aux losses {res['moe_aux']} (tolerance {aux_tol})")
        check(abs(card["grad_norm"] - cpu["grad_norm"]) <= norm_tol,
              f"{tag}: grad norms {res['grad_norm']} (tolerance "
              f"{norm_tol})")
        if f32:
            tf32 = res["tf32"] = {"grad_norm": tf32["grad_norm"],
                                  "grad_rel_l2": tf32_l2}
            tf32_norm_off = abs(tf32["grad_norm"] - cpu["grad_norm"])
            check(tf32_norm_off > norm_tol
                  or max(tf32["grad_rel_l2"]) > l2_tol, f"{tag}: the TF32 "
                  f"control's grad norm {tf32['grad_norm']} lies within "
                  f"{norm_tol} of the CPU's and its gradients within "
                  f"{max(tf32['grad_rel_l2'])} relative L2 (limit "
                  f"{l2_tol}): the check cannot tell float32 from TF32 "
                  "products")
        worst = max(range(len(grad_l2)), key=lambda i: grad_l2[i])
        check(grad_l2[worst] <= l2_tol,
              f"{tag}: the gradient of {names[worst]} differs by "
              f"{grad_l2[worst]} relative L2 (tolerance {l2_tol})")
        check(not stepped or param_err <= 2 * lr * (1 + 1e-3),
              f"{tag}: parameters after a step differ by {param_err} (lr "
              f"{lr})")
        print(f"[smoke] phase {phase} ({arch}, {impl}, {dtype}): loss card "
              f"{card['loss']:.6f} cpu {cpu['loss']:.6f}, aux card "
              f"{card['moe_aux']:.6f} cpu {cpu['moe_aux']:.6f}, |g| card "
              f"{card['grad_norm']:.6f} cpu {cpu['grad_norm']:.6f}; "
              f"gradients' relative L2 per leaf up to {grad_l2[worst]:.4g} "
              f"({names[worst]}; max-entry {max(grad_max):.4g}); "
              + (f"parameters after one step within {param_err:.3g} (lr "
                 f"{lr:.3g}), at most {beyond:.4%} of a leaf beyond 5 % of "
                 "lr; " if stepped else "")
              + f"card launches "
              f"{ {k: n for k, n in launches.items() if n} }"
              + (f"; TF32 control |g| {tf32['grad_norm']:.6f}, gradients "
                 f"up to {max(tf32['grad_rel_l2']):.4g} relative L2"
                 if f32 else ""))
        del card, cpu, params
        torch.cuda.empty_cache()
    return out


def train_parity_phase() -> dict:
    """Phase 13: ``_train_parity`` of LM_ARCH."""
    return _train_parity(LM_ARCH, "13")


def train_profile_phase() -> dict:
    """Phase 15, where a training step's time goes: the entry point's
    model and batch, 1 warm-up step, 2 steps timed, then 1 profiled
    (device time by kernel, device busy share)."""
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    model = LM(cfg, init_params(build_defs(cfg), seed=0, device=DEVICE),
               trainable=True)
    opt = adamw(warmup_cosine(1e-3, 10, 50))
    state = init_train_state(model, opt)
    step = build_lm_train_step(model, opt)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    batch = pipe.torch_batch(0, DEVICE)
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    steady_ms = 1e3 * (time.perf_counter() - t0) / 2
    prof = device_profile(lambda: step(state, batch), 1)
    print(f"[smoke] phase 15: steady {steady_ms:.3f} ms/step "
          f"({TRAIN_BATCH * TRAIN_SEQ * 1e3 / steady_ms:.1f} tok/s); "
          f"profiled {prof['profiled_ms_per_step']:.3f} ms/step, device "
          f"busy {prof['device_busy_ms_per_step']} ms/step (share "
          f"{prof['device_busy_share']}), {prof['device_ops_per_step']:.0f} "
          "device ops/step")
    print_profile(prof)
    return {"steady_ms_per_step": steady_ms, "profile": prof}


def ssm_serve_phase() -> dict:
    """Phase 17: the SSM serving paths through their entry point,
    ``repro_torch.launch.serve.main``, ``--full-config``, batch
    SERVE_BATCH, prompt SERVE_PROMPT, SSM_GEN tokens, the launch counters
    reset just before each run and read just after: ``ssd_chunk_scan``
    once a layer in prefill (the SSM decode step runs no kernel); for
    hymba-1.5b also ``flash_attention_fwd`` once a layer and
    ``decode_attention`` once a layer a decode step; no other kernel."""
    out = {}
    for arch, gen in SSM_GEN.items():
        cfg = get_config(arch)
        layers, hybrid = cfg.num_layers, cfg.family == "hybrid"
        argv = ["--arch", arch, "--full-config", "--batch", str(SERVE_BATCH),
                "--prompt-len", str(SERVE_PROMPT), "--gen", str(gen),
                "--device", DEVICE]
        print(f"[smoke] phase 17: serve {' '.join(argv)}")
        kernels.reset_launches()
        served = serve.main(argv)
        launches = dict(kernels.LAUNCHES)
        want = {"ssd_chunk_scan": layers,
                "flash_attention_fwd": layers if hybrid else 0,
                "decode_attention": layers * (gen - 1) if hybrid else 0}
        for kname, n in launches.items():
            check(n == want.get(kname, 0), f"serve {arch}: {kname} launched "
                  f"{n} times, not {want.get(kname, 0)}")
        check(bool(torch.isfinite(served["prefill_logits"]).all()
                   and torch.isfinite(served["logits"]).all()),
              f"serve {arch}: non-finite logits")
        check(served["tokens"].shape == (SERVE_BATCH, gen),
              f"serve {arch}: ids of shape {served['tokens'].shape}")
        print(f"[smoke] phase 17: {arch} prefill {served['prefill_ms']:.3f} "
              f"ms, decode {served['decode_ms_per_step']:.3f} ms/step, "
              f"{served['tok_per_s']:.1f} tok/s, launches {launches}")
        out[arch] = {"argv": argv, "launches": launches,
                     **{k: served[k] for k in (
                         "prefill_ms", "decode_ms", "decode_ms_per_step",
                         "tok_per_s")},
                     "ids": served["tokens"].tolist()}
        del served
        torch.cuda.empty_cache()
    return out


def moe_parity_phase() -> dict:
    """Phase 28a: the first PARITY_LAYERS layers of MOE_ARCH and MIXTRAL
    (``_first_layers``; moonshot's attention on the flash path; mixtral's
    sliding window takes the chunked path, as in the reference), bf16
    weights drawn once on the card and copied to the CPU, at each of
    MOE_PARITY_PROMPTS: ``_moe_layers_case`` (every layer's MoE and the
    logits on equal inputs, the tokens the two prefills route apart
    counted), then ``_greedy_pair``: the greedy ids equal up to
    ``_near_tie_picks``, and each step's logits reported beside the
    routing flips that move them (a token routed apart in a layer moves
    by O(1), and through attention the later ones)."""
    out = {}
    for arch in (MOE_ARCH, MIXTRAL):
        cfg, card_params = _first_layers(arch, "flash", COMPUTE_DTYPE)
        params = tree_map(lambda t: t.cpu(), card_params)
        for prompt in MOE_PARITY_PROMPTS:
            tag = f"{arch}, prompt {prompt}"
            tokens = make_batch(cfg, PARITY_BATCH, prompt,
                                kind="prefill")["tokens"]
            r = _moe_layers_case(cfg, LM(cfg, card_params), LM(cfg, params),
                                 tokens)
            print(f"[smoke] phase 28a ({tag}): each layer on equal inputs: "
                  f"{r['near_ties']} of {r['tokens']} tokens routed apart "
                  f"at router near-ties, slot tables equal "
                  f"{r['slots_equal']}, {r['dropped']} of "
                  f"{r['assignments']} assignments dropped, MoE outputs "
                  f"within {r['max_out_err']}, logits within "
                  f"{r['max_logit_diff']:g} (tolerance {LOGIT_TOL}); each "
                  f"device's own prefill routes {r['prefill_routed_apart']}"
                  " tokens apart by layer")
            ids, card_logits, cpu_logits, diffs = _greedy_pair(
                cfg, card_params, params, prompt)
            res = out[tag] = {
                "layers": r, "ids": ids.tolist(), "step_logit_diff": diffs,
                "near_tie_picks": _near_tie_picks(ids, card_logits,
                                                  cpu_logits, tag)}
            print(f"[smoke] phase 28a ({tag}): {PARITY_GEN} greedy ids x "
                  f"{PARITY_BATCH} rows equal to the CPU's "
                  f"({res['near_tie_picks']} near-tie picks); end to end "
                  f"each step's logits within "
                  f"{[float(f'{e:.3g}') for e in diffs]}; card ids "
                  f"{res['ids'][0]}")
        del card_params, params
        torch.cuda.empty_cache()
    return out


class _ServedConfig:
    """While installed, the serve entry point's ``get_config`` returns
    ``cfg`` for ``cfg.name`` (a model cut in layers)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def __enter__(self):
        self._real = serve.get_config
        serve.get_config = lambda name: (self.cfg if name == self.cfg.name
                                         else self._real(name))

    def __exit__(self, *exc):
        serve.get_config = self._real


def _serve_entry(phase: str, arch: str, gen: int, want: dict,
                 layers: int | None = None) -> dict:
    """``repro_torch.launch.serve.main --arch arch --full-config --batch
    SERVE_BATCH --prompt-len SERVE_PROMPT --gen gen`` (the model cut to
    ``layers`` layers where given), the launch counters reset just
    before the run and read just after: each kernel launched as often as
    ``want`` says, no other; finite logits.  Returns the run's weights'
    draw on the card (s), prefill ms, decode ms per step, tok/s, peak
    device memory, launches and ids."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    argv = ["--arch", arch, "--full-config", "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--gen", str(gen),
            "--device", DEVICE]
    print(f"[smoke] phase {phase}: serve {' '.join(argv)}"
          + (f" (cut to {layers} layers)" if layers else ""))
    kernels.reset_launches()
    with _ServedConfig(cfg):
        served = serve.main(argv)
    launches = dict(kernels.LAUNCHES)
    for kname, n in launches.items():
        check(n == want.get(kname, 0), f"serve {arch}: {kname} launched "
              f"{n} times, not {want.get(kname, 0)}")
    check(bool(torch.isfinite(served["prefill_logits"]).all()
               and torch.isfinite(served["logits"]).all()),
          f"serve {arch}: non-finite logits")
    check(served["tokens"].shape == (SERVE_BATCH, gen),
          f"serve {arch}: ids of shape {served['tokens'].shape}")
    print(f"[smoke] phase {phase}: {arch} ({cfg.num_layers} layers) weights "
          f"drawn on the card in {served['init_s']:.2f} s, prefill "
          f"{served['prefill_ms']:.3f} ms, decode "
          f"{served['decode_ms_per_step']:.3f} ms/step, "
          f"{served['tok_per_s']:.1f} tok/s, peak device memory "
          f"{served['peak_bytes'] / 2**30:.2f} GiB, launches "
          f"{ {k: n for k, n in launches.items() if n} }")
    out = {"argv": argv, "layers": cfg.num_layers, "launches": launches,
           **{k: served[k] for k in (
               "init_s", "prefill_ms", "decode_ms", "decode_ms_per_step",
               "tok_per_s", "peak_bytes")},
           "ids": served["tokens"].tolist()}
    del served
    torch.cuda.empty_cache()
    return out


def moe_serve_phase() -> dict:
    """Phases 28b and 28c, ``_serve_entry`` with MOE_GEN tokens: MOE_ARCH
    at full width cut to MOE_SERVE_LAYERS layers (b), then MIXTRAL at full
    width cut to MIXTRAL_LAYERS layers (c): moonshot's prefill
    ``flash_attention_fwd``
    once a layer, mixtral's none (its sliding window takes the chunked
    path); ``decode_attention`` once a layer a decode step."""
    out = {}
    for phase, arch, layers in (("28b", MOE_ARCH, MOE_SERVE_LAYERS),
                                ("28c", MIXTRAL, MIXTRAL_LAYERS)):
        cfg = get_config(arch)
        L = layers or cfg.num_layers
        out[arch] = _serve_entry(phase, arch, MOE_GEN, {
            "flash_attention_fwd": 0 if cfg.sliding_window else L,
            "decode_attention": L * (MOE_GEN - 1)}, layers)
    return out


def _moe_grad_case(arch: str) -> dict:
    """Layer 0's MoE forward and backward of ``arch``'s first layers
    (``_first_layers``) on the card and on the CPU, float32 activations and
    weights (drawn on the card), on the same input (the normalized
    residual after layer 0's chunked attention over a TRAIN_PARITY_BATCH x
    TRAIN_PARITY_SEQ ``TokenPipeline`` batch) and the same upstream
    gradient: the routing equal (expert ids and keep flags), then the
    output, the aux loss and the gradients of ``(out * upstream).sum() +
    MOE_AUX_WEIGHT * aux`` with respect to the input, the router and the
    three expert weights, each within MOE_GRAD_REL_TOL relative L2."""
    cfg, params = _first_layers(arch, "chunked")
    p = {k: w[0] for k, w in params["blocks"].items()}
    tokens = TokenPipeline(vocab_size=cfg.vocab_size,
                           seq_len=TRAIN_PARITY_SEQ,
                           global_batch=TRAIN_PARITY_BATCH).torch_batch(
                               0, DEVICE)["tokens"]
    transformer.COMPUTE_DTYPE = torch.float32
    try:
        with torch.no_grad():
            x = torch.nn.functional.embedding(tokens, params["embed"])
            pos = torch.arange(x.shape[1], dtype=torch.int32, device=DEVICE)
            x = x + transformer._attn_block(cfg, p, x, pos, -1)[0]
            h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    finally:
        transformer.COMPUTE_DTYPE = COMPUTE_DTYPE
    upstream = torch.randn(h.shape, generator=torch.Generator(
        device=DEVICE).manual_seed(5), device=DEVICE)
    names = ("router", "w_gate", "w_up", "w_down")
    runs = {}
    for dev in (DEVICE, "cpu"):
        leaves = [t.detach().to(dev).requires_grad_()
                  for t in [h] + [p[n] for n in names]]
        out, aux = moe.apply_moe(dict(zip(names, leaves[1:])), leaves[0],
                                 act=activation(cfg.act), **_moe_kw(cfg))
        grads = torch.autograd.grad(
            (out * upstream.to(dev)).sum()
            + MOE_AUX_WEIGHT * aux["moe_aux_loss"], leaves)
        with torch.no_grad():
            r = moe.route(leaves[1], leaves[0], **_moe_kw(cfg))
        runs[dev] = {"out": out.detach().cpu(),
                     "aux": float(aux["moe_aux_loss"].detach()),
                     "grads": [g.cpu() for g in grads], "route": r}
        del leaves, grads, out
    card, cpu = runs[DEVICE], runs["cpu"]
    apart = int(_routed_apart(card["route"], cpu["route"]).sum())
    check(apart == 0, f"MoE backward ({arch}): {apart} tokens routed apart "
          "on equal float32 inputs")

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    errs = {"out": rel(card["out"], cpu["out"]),
            **{f"d_{n}": rel(a, b) for n, a, b in zip(
                ("input",) + names, card["grads"], cpu["grads"])}}
    aux_err = abs(card["aux"] - cpu["aux"])
    check(max(errs.values()) <= MOE_GRAD_REL_TOL
          and aux_err <= F32_TRAIN_REL_TOL * abs(cpu["aux"]),
          f"MoE backward ({arch}): relative L2 {errs}, aux {card['aux']} "
          f"against {cpu['aux']}")
    keep = cpu["route"].keep
    out = {"rel_l2": errs, "aux": [card["aux"], cpu["aux"]],
           "dropped": int((~keep).sum()), "assignments": keep.numel()}
    print(f"[smoke] phase 28d ({arch}, layer 0's MoE on equal float32 "
          f"inputs): output and gradients within relative L2 "
          f"{ {k: float(f'{e:.3g}') for k, e in errs.items()} } (tolerance "
          f"{MOE_GRAD_REL_TOL}), aux {card['aux']:.6f} against "
          f"{cpu['aux']:.6f}, {out['dropped']} of {out['assignments']} "
          "assignments dropped")
    del params, runs
    torch.cuda.empty_cache()
    return out


def moe_phase(side: HeldProcess) -> dict:
    """Phase 28, the MoE family: card-vs-CPU serving (28a), the serve
    entry point for moonshot (28b) and mixtral cut in layers (28c), and
    moonshot's first MOE_TRAIN_LAYERS layers in training, card against CPU
    (28d): its MoE layer's backward on equal inputs
    (``_moe_grad_case``), then one step (``_train_parity``).  ``side``
    runs during 28a and 28d, which time nothing."""
    t0 = time.perf_counter()
    split = {}

    def part(name, fn):
        t = time.perf_counter()
        out[name] = fn()
        split[name] = round(time.perf_counter() - t, 1)

    out = {}
    with side.running():
        part("parity", moe_parity_phase)
    part("serve", moe_serve_phase)
    with side.running():
        part("grad", lambda: _moe_grad_case(MOE_ARCH))
        part("train_parity", lambda: _train_parity(MOE_ARCH, "28d",
                                                   layers=MOE_TRAIN_LAYERS,
                                                   update=False))
    out["seconds"], out["seconds_by_part"] = time.perf_counter() - t0, split
    print(f"[smoke] phase 28: {out['seconds']:.1f} s {split}")
    return out


def mm_parity_phase() -> dict:
    """Phase 29a: ``_serve_parity`` of VL_ARCH's and ENCDEC_ARCH's first
    PARITY_LAYERS layers (of both of seamless's stacks; ``_first_layers``;
    the decoders' attention on the flash path, seamless's encoder and
    cross-attention on the chunked one, as in the reference), bf16
    weights drawn once on the card and copied to the CPU, at each of
    MM_PARITY_PROMPTS: qwen2-vl's prompt ``embeds`` and decode on its
    greedy ids, end to end; seamless's cross K/V, its decode steps each
    from the card's cache and attention outputs (``from_card_cache``),
    and its decode attention calls against the plain version on their
    inputs."""
    out = {}
    for arch in (VL_ARCH, ENCDEC_ARCH):
        cfg, card_params = _first_layers(arch, "flash", COMPUTE_DTYPE)
        params = tree_map(lambda t: t.cpu(), card_params)
        encdec = cfg.family == "encdec"
        for prompt in MM_PARITY_PROMPTS:
            tag = f"{arch}, prompt {prompt}"
            res = out[tag] = _serve_parity(cfg, card_params, params, prompt,
                                           tag, from_card_cache=encdec)
            print(f"[smoke] phase 29a ({tag}): {PARITY_GEN} greedy ids x "
                  f"{PARITY_BATCH} rows equal to the CPU's "
                  f"({res['near_tie_picks']} near-tie picks), logits within "
                  f"{res['max_logit_diff']:g} (tolerance {LOGIT_TOL})"
                  + (f" in the decode steps, each from the card's cache "
                     f"and attention outputs (the prefills' own logits "
                     f"{res['prefill_logit_diff']:g} apart, the CPU's own "
                     f"attention outputs up to "
                     f"{max(res['cpu_own_call_diff']):g} from the card's);"
                     f" the card's decode attention calls within "
                     f"{max(res['decode_call_err']):g} of the plain "
                     f"version on their inputs (cross-attention "
                     f"{max(res['cross_call_err']):g}; tolerances "
                     f"{DECODE_CALL_REL_TOL:g} of the largest value, "
                     f"{min(res['decode_call_tol']):g} to "
                     f"{max(res['decode_call_tol']):g}); prefill cross K/V "
                     f"per layer within "
                     f"{[float(f'{e:.3g}') for e in res['cross_k_rel_err']]}"
                     f" and "
                     f"{[float(f'{e:.3g}') for e in res['cross_v_rel_err']]}"
                     f" of the largest entry (tolerance {CACHE_REL_TOL})"
                     if encdec else "")
                  + f"; card ids {res['ids'][0]}")
        del card_params, params
        torch.cuda.empty_cache()
    return out


def ssd_grad_case(arch: str) -> dict:
    """``ops.SSDChunkScan`` on the card (the kernel's forward, the plain
    scan's vector-Jacobian product) against ``torch.autograd.grad``
    through ``ref.ssd_chunk_scan`` on the card, on seeded float32 random
    inputs at ``arch``'s layer-0 scan shape cut to B 1, S SSD_GRAD_SEQ
    and seeded incoming gradients of y and the final state: y, the state
    and the five gradients within SSD_GRAD_REL_TOL relative L2."""
    cfg = get_config(arch)
    h, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    p, chunk, b, s = cfg.d_inner // h, cfg.ssm_chunk, 1, SSD_GRAD_SEQ
    gen = torch.Generator(device=DEVICE).manual_seed(11)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    args = (randn(b, s, h, p), randn(b, s, h).abs() * 0.1, -randn(h).abs(),
            randn(b, s, g, n), randn(b, s, g, n))
    upstream = (randn(b, s, h, p), randn(b, h, p, n))
    runs = []
    for fn in (lambda *a: ops.SSDChunkScan.apply(*a, chunk),
               lambda *a: ref.ssd_chunk_scan(*a, chunk=chunk)):
        leaves = [t.clone().requires_grad_() for t in args]
        outs = fn(*leaves)
        runs.append([t.detach() for t in outs] + list(
            torch.autograd.grad(outs, leaves, upstream)))
    errs = {name: float((a - w).norm() / w.norm().clamp_min(1e-30))
            for name, a, w in zip(("y", "state", "dx", "ddt", "dA", "dB",
                                   "dC"), *runs)}
    check(all(math.isfinite(e) and e <= SSD_GRAD_REL_TOL
              for e in errs.values()),
          f"SSDChunkScan ({arch}, {(b, s, h, p, g, n, chunk)}): relative "
          f"L2 {errs}")
    print(f"[smoke] phase 29d: SSDChunkScan at {arch}'s layer-0 shape "
          f"{(b, s, h, p, g, n, chunk)}: y, state and gradients within "
          f"relative L2 { {k: float(f'{e:.3g}') for k, e in errs.items()} } "
          f"(tolerance {SSD_GRAD_REL_TOL})")
    del runs, args, upstream
    torch.cuda.empty_cache()
    return {"shape": [b, s, h, p, g, n, chunk], "rel_l2": errs}


def ssm_train_phase() -> dict:
    """Phase 29e: the train entry point, ``repro_torch.launch.train.main
    --arch ARCH --batch SSM_TRAIN_BATCH --seq-len SSM_TRAIN_SEQ --steps
    SSM_TRAIN_STEPS`` for mamba2-370m and hymba-1.5b at full width and
    depth, the launch counters reset just before each run and read just
    after: ``ssd_chunk_scan`` 2 a layer a step (the forward and its remat
    recompute; its backward is the plain scan's), for hymba also
    ``flash_attention_fwd`` 2 and each backward kernel 1 a layer a step,
    no other kernel; finite losses; step ms (the median after the
    first), tok/s and peak device memory."""
    out = {}
    for arch in SSM_GEN:
        cfg = get_config(arch)
        L, steps = cfg.num_layers, SSM_TRAIN_STEPS
        argv = ["--arch", arch, "--batch", str(SSM_TRAIN_BATCH), "--seq-len",
                str(SSM_TRAIN_SEQ), "--steps", str(steps), "--log-every",
                "1", "--attn-impl", "flash", "--device", DEVICE]
        print(f"[smoke] phase 29e: train {' '.join(argv)}")
        kernels.reset_launches()
        trained = train.main(argv)
        launches = dict(kernels.LAUNCHES)
        want = {"ssd_chunk_scan": 2 * L * steps}
        if cfg.family == "hybrid":
            want.update(flash_attention_fwd=2 * L * steps,
                        flash_attention_bwd_dq=L * steps,
                        flash_attention_bwd_dkv=L * steps)
        for kname, n in launches.items():
            check(n == want.get(kname, 0), f"train {arch}: {kname} "
                  f"launched {n} times, not {want.get(kname, 0)}")
        check(len(trained["losses"]) == steps
              and all(math.isfinite(x) for x in trained["losses"]),
              f"train {arch}: losses {trained['losses']}")
        steady = statistics.median(trained["step_ms"][1:])
        out[arch] = {"argv": argv, "launches": launches,
                     "steady_ms": steady,
                     "tok_per_s": SSM_TRAIN_BATCH * SSM_TRAIN_SEQ * 1e3
                     / steady,
                     **{k: trained[k] for k in (
                         "losses", "grad_norms", "step_ms", "peak_bytes")}}
        print(f"[smoke] phase 29e: {arch} step ms {trained['step_ms']} "
              f"(median after the first {steady:.3f}, "
              f"{out[arch]['tok_per_s']:.1f} tok/s), peak device memory "
              f"{trained['peak_bytes'] / 2**30:.2f} GiB, losses "
              f"{trained['losses']}, launches "
              f"{ {k: n for k, n in launches.items() if n} }")
        del trained
        torch.cuda.empty_cache()
    return out


def mm_train_phase() -> dict:
    """Phase 29f: ``build_train_step`` at full width, MM_TRAIN_STEPS
    steps of AdamW (``warmup_cosine(1e-3, 10, 50)``), the launch counters
    reset just before: ENCDEC_ARCH whole on ``make_batch(kind="train")``
    (ENCDEC_TRAIN_BATCH x ENCDEC_TRAIN_SEQ, a quarter as many source
    frames), and VL_ARCH's first VL_TRAIN_LAYERS layers on
    ``TokenPipeline`` tokens (VL_TRAIN_BATCH x VL_TRAIN_SEQ), as the
    launcher feeds it; ``flash_attention_fwd`` 2 and each backward kernel
    1 a decoder layer a step (seamless's encoder and cross-attention take
    the chunked path), no other kernel; finite losses; step ms, tok/s
    and peak device memory."""
    out = {}
    for arch, layers in ((ENCDEC_ARCH, None), (VL_ARCH, VL_TRAIN_LAYERS)):
        full = get_config(arch)
        cfg = dataclasses.replace(full, attn_impl="flash",
                                  num_layers=layers or full.num_layers)
        model = LM(cfg, init_params(build_defs(full), seed=0, device=DEVICE,
                                    layers=layers), trainable=True)
        if full.family == "encdec":
            B, S = ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ
            batch = make_batch(cfg, B, S, kind="train", device=DEVICE)
        else:
            B, S = VL_TRAIN_BATCH, VL_TRAIN_SEQ
            batch = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B).torch_batch(0, DEVICE)
        opt = adamw(warmup_cosine(1e-3, 10, 50))
        state = init_train_state(model, opt)
        step = build_lm_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        losses, step_ms = [], []
        for _ in range(MM_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        launches = dict(kernels.LAUNCHES)
        L, n = cfg.num_layers, MM_TRAIN_STEPS
        want = {"flash_attention_fwd": 2 * L * n,
                "flash_attention_bwd_dq": L * n,
                "flash_attention_bwd_dkv": L * n}
        for kname, k in launches.items():
            check(k == want.get(kname, 0), f"train step {arch}: {kname} "
                  f"launched {k} times, not {want.get(kname, 0)}")
        check(all(math.isfinite(x) for x in losses),
              f"train step {arch}: losses {losses}")
        steady = statistics.median(step_ms[1:])
        peak = torch.cuda.max_memory_allocated()
        out[arch] = {"layers": L, "batch": [B, S], "launches": launches,
                     "losses": losses, "step_ms": step_ms,
                     "steady_ms": steady, "tok_per_s": B * S * 1e3 / steady,
                     "peak_bytes": peak}
        print(f"[smoke] phase 29f: {arch} ({L} layers) B {B} S {S}: step "
              f"ms {[round(t, 3) for t in step_ms]} (median after the "
              f"first {steady:.3f}, {out[arch]['tok_per_s']:.1f} tok/s), "
              f"peak device memory {peak / 2**30:.2f} GiB, losses {losses},"
              f" launches { {k: n for k, n in launches.items() if n} }")
        del model, state, step, batch, opt
        torch.cuda.empty_cache()
    return out


def mm_phase(side: HeldProcess) -> dict:
    """Phase 29: qwen2-vl-7b and seamless-m4t-large-v2 served card
    against CPU (29a) and through the serve entry point (29b, 29c); the
    training step card against CPU (29d) of qwen2-vl on ``embeds``,
    seamless, mamba2-370m and hymba-1.5b, beside SSDChunkScan's
    gradients; the SSM training entry points (29e); and full-width
    training steps of seamless and of qwen2-vl cut in layers (29f).
    ``side`` runs during 29a and 29d, which time nothing."""
    t0 = time.perf_counter()
    with side.running():
        out = {"parity": mm_parity_phase()}
    split = {"a": time.perf_counter() - t0}
    out["serve"] = {
        VL_ARCH: _serve_entry("29b", VL_ARCH, MM_GEN, {
            "flash_attention_fwd": get_config(VL_ARCH).num_layers,
            "decode_attention": get_config(VL_ARCH).num_layers
            * (MM_GEN - 1)}),
        ENCDEC_ARCH: _serve_entry("29c", ENCDEC_ARCH, MM_GEN, {
            "flash_attention_fwd": get_config(ENCDEC_ARCH).num_layers,
            "decode_attention": 2 * get_config(ENCDEC_ARCH).num_layers
            * (MM_GEN - 1)})}
    split["b-c"] = time.perf_counter() - t0 - sum(split.values())
    with side.running():
        out["ssd_grad"] = {arch: ssd_grad_case(arch) for arch in SSM_GEN}
        out["train_parity"] = {
            VL_ARCH: _train_parity(VL_ARCH, "29d", _model_batch,
                                   update=False),
            ENCDEC_ARCH: _train_parity(ENCDEC_ARCH, "29d", _model_batch,
                                       staged=True, update=False),
            **{arch: _train_parity(arch, "29d", update=False)
               for arch in SSM_GEN}}
    split["d"] = time.perf_counter() - t0 - sum(split.values())
    out["ssm_train"] = ssm_train_phase()
    split["e"] = time.perf_counter() - t0 - sum(split.values())
    out["train_step"] = mm_train_phase()
    split["f"] = time.perf_counter() - t0 - sum(split.values())
    out["seconds"], out["seconds_by_part"] = time.perf_counter() - t0, split
    print(f"[smoke] phase 29: {out['seconds']:.1f} s "
          f"{ {k: round(v, 1) for k, v in split.items()} }")
    return out


def dots_phase() -> dict:
    """Phase 30a: LM_ARCH at full width through ``build_train_step`` at
    phase 14's B x S, DOTS_STEPS steps under ``remat="full"`` and
    ``"dots"``, each from the seed-0 weights: losses within
    MESH_LOSS_REL_TOL relative, the flash kernels' launches (2 forward a
    layer a step: the forward is recomputed under both policies), step ms
    and peak memory."""
    out = {}
    full = get_config(LM_ARCH)
    pipe = TokenPipeline(vocab_size=full.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    for remat in ("full", "dots"):
        cfg = dataclasses.replace(full, attn_impl="flash", remat=remat)
        model = LM(cfg, init_params(build_defs(cfg), seed=0, device=DEVICE),
                   trainable=True)
        opt = adamw(warmup_cosine(1e-3, 10, TRAIN_STEPS))
        state = init_train_state(model, opt)
        step = build_lm_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        losses, step_ms = [], []
        for i in range(DOTS_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, pipe.torch_batch(i, DEVICE))
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        launches = dict(kernels.LAUNCHES)
        L = cfg.num_layers
        want = {"flash_attention_fwd": 2 * L * DOTS_STEPS,
                "flash_attention_bwd_dq": L * DOTS_STEPS,
                "flash_attention_bwd_dkv": L * DOTS_STEPS}
        for kname, k in launches.items():
            check(k == want.get(kname, 0), f"phase 30a ({remat}): {kname} "
                  f"launched {k} times, not {want.get(kname, 0)}")
        check(all(math.isfinite(x) for x in losses),
              f"phase 30a ({remat}): losses {losses}")
        out[remat] = {"losses": losses, "step_ms": step_ms,
                      "steady_ms": statistics.median(step_ms[1:]),
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "launches": launches}
        print(f"[smoke] phase 30a: remat={remat}: step ms "
              f"{[round(t, 3) for t in step_ms]}, peak device memory "
              f"{out[remat]['peak_bytes'] / 2**30:.2f} GiB, losses {losses}")
        del model, state, step, opt
        torch.cuda.empty_cache()
    for a, b in zip(out["full"]["losses"], out["dots"]["losses"]):
        check(abs(a - b) <= MESH_LOSS_REL_TOL * abs(a),
              f"phase 30a: dots losses {out['dots']['losses']} vs full "
              f"{out['full']['losses']}")
    out["none"] = ("not run: remat='none' keeps every activation of 24 "
                   "layers beside phase 14's ~53 GiB")
    return out


def data_mesh_phase(argv_lm: list, phase14: dict) -> dict:
    """Phase 30b: the train entry point on the data mesh, phase 14's
    command with ``--mesh Nx1`` and DOTS_STEPS steps at N = the card
    count (NCCL), and at 2 and 4 where there are as many cards: losses
    within MESH_LOSS_REL_TOL relative of phase 14's first steps, each
    rank's flash launches, its peak memory, step ms."""
    out = {}
    count = torch.cuda.device_count()
    layers = get_config(LM_ARCH).num_layers
    want = {"flash_attention_fwd": 2 * layers * DOTS_STEPS,
            "flash_attention_bwd_dq": layers * DOTS_STEPS,
            "flash_attention_bwd_dkv": layers * DOTS_STEPS}
    for world in sorted({count} | {n for n in (2, 4) if n <= count}):
        argv = [a for a in argv_lm] + ["--mesh", f"{world}x1"]
        argv[argv.index("--steps") + 1] = str(DOTS_STEPS)
        print(f"[smoke] phase 30b: train {' '.join(argv)}")
        kernels.reset_launches()
        got = train.main(argv)
        check(got["world"] == world, f"phase 30b: world {got['world']}")
        for a, b in zip(got["losses"], phase14["losses"]):
            check(abs(a - b) <= MESH_LOSS_REL_TOL * abs(b),
                  f"phase 30b ({world} ranks): losses {got['losses']} vs "
                  f"phase 14's {phase14['losses'][:DOTS_STEPS]}")
        for r, launches in enumerate(got["launches_per_rank"]):
            for kname, n in want.items():
                check(launches[kname] == n, f"phase 30b: rank {r} launched "
                      f"{kname} {launches[kname]} times, not {n}")
        steady = statistics.median(got["step_ms"][1:])
        out[world] = {k: got[k] for k in (
            "losses", "grad_norms", "step_ms", "peak_bytes_per_rank",
            "launches_per_rank", "world")} | {"steady_ms": steady}
        print(f"[smoke] phase 30b: {world} rank(s): step ms "
              f"{[round(t, 3) for t in got['step_ms']]} (median after the "
              f"first {steady:.3f}), peak device memory per rank "
              f"{[p and round(p / 2**30, 2) for p in got['peak_bytes_per_rank']]}"
              f" GiB, losses {got['losses']} (phase 14: "
              f"{phase14['losses'][:DOTS_STEPS]})")
        torch.cuda.empty_cache()
    return out


def _decode_runs(model, batch, prompt: int, gen: int, mesh, dev):
    """The decode runs of phases 30c and 31b on one model: returns
    ``run(prefill, step, feed=None, steps=gen - 1) -> (ids, logits on the
    CPU, cache, ms/step)``, ``logits[t]`` the ones that pick ``ids[:,
    t]`` (the prefill's first).  ``feed`` (B, gen) ids replace the run's
    own picks."""
    import torch.distributed as dist

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(prefill, step, feed=None, steps=gen - 1):
        sync()
        logits, cache = prefill(batch)
        if feed is None:   # the model group's first collective, untimed
            dist.all_reduce(torch.zeros(1, device=dev),
                            group=mesh.get_group("model"))
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        ids, all_logits = [tok], [logits[:, -1].float().cpu()]
        sync()
        t0 = time.perf_counter()
        for i in range(steps):
            if feed is not None:
                tok = feed[:, i:i + 1].to(dev)
            logits, cache, nxt = step(tok, cache, prompt + i)
            tok = nxt[:, None]
            ids.append(tok)
            all_logits.append(logits[:, -1].float().cpu())
        sync()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        return torch.cat(ids, 1).cpu(), all_logits, cache, ms

    return run


class _Plain:
    """While installed, the LM's decode attention is the decode kernel's
    plain version (float32 scores, softmax and PV products: the
    partials' arithmetic; the kernel rounds its probabilities to bf16)."""

    def __enter__(self):
        self._real = transformer.decode_attention_local
        transformer.decode_attention_local = (
            lambda q, k, v, valid_len, *, window=0:
            ref.decode_attention(q, k, v, int(valid_len), int(window)))

    def __exit__(self, *exc):
        transformer.decode_attention_local = self._real


def _equal_input_calls(mesh, dev, B: int, S: int, Hq: int, Hkv: int,
                       D: int) -> list:
    """``sharded_decode_attention`` against the plain decode attention
    over the whole cache on equal random bf16 inputs: a position in rank
    0's slice (rank 1 adds nothing), two in rank 1's, the last, and a
    window that leaves rank 0's slice out.  -> (position, window, largest
    |difference|, largest |value|) a call."""
    from repro_torch.models.attention import sharded_decode_attention

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=g)
                ).to(COMPUTE_DTYPE)

    ck, cv = randn(B, S, Hkv, D), randn(B, S, Hkv, D)
    fn = sharded_decode_attention(mesh)
    r, half = mesh.get_local_rank("model"), S // 2
    out = []
    for pos, window in ((5, 0), (half + half // 2, 0), (S - 1, 0),
                        (S - 3, half // 2)):
        q, nk, nv = (randn(B, Hq, D, scale=3.0), randn(B, 1, Hkv, D),
                     randn(B, 1, Hkv, D))
        got = fn(q, nk, nv, ck[:, r * half:(r + 1) * half].clone(),
                 cv[:, r * half:(r + 1) * half].clone(), pos, window)
        fk, fv = ck.clone(), cv.clone()
        fk[:, pos], fv[:, pos] = nk[:, 0], nv[:, 0]
        want = ref.decode_attention(q, fk, fv, pos + 1, window).float()
        out.append((pos, window, float((got.float() - want).abs().max()),
                    float(want.abs().max())))
    return out


def _sharded_decode_rank(mesh, cfg, device: str, B: int, prompt: int,
                         gen: int) -> dict | None:
    """One rank of phase 30c (a spawned rank imports this script afresh,
    so everything it reads is an argument).  ``cfg`` served at batch
    ``B``, ``prompt`` and ``gen`` tokens on the (1, 2) mesh, the cache
    split on S: in bf16 (the served model) and in float32 activations
    (``attn_impl`` chunked: the flash kernel is bf16 only).  Rank 0 then
    decodes unsharded, fed the sharded runs' ids: in bf16 through the
    decode kernel, in float32 (F32_DECODE_STEPS steps) through its plain
    version (float32 scores, softmax and PV products: the partials'
    arithmetic).  Both ranks run the equal-input attention calls.  Rank 0
    returns every run's numbers."""
    import torch.distributed as dist

    dev = rank_device(device)
    S_total = SHARDED_CACHE
    model = LM(cfg, init_params(build_defs(cfg), seed=0, device=dev,
                                dtype=COMPUTE_DTYPE))
    batch = make_batch(cfg, B, prompt, kind="prefill", device=dev)
    run = _decode_runs(model, batch, prompt, gen, mesh, dev)
    kernels.reset_launches()
    ids, logits, cache, ms = run(build_prefill_step(model, S_total, mesh),
                                 build_serve_step(model, mesh))
    out = {"ids": ids, "logits": logits, "ms_per_step": ms,
           "launches": dict(kernels.LAUNCHES),
           "local_s": cache["k"].to_local().shape[2],
           "backend": dist.get_backend(),
           "calls": _equal_input_calls(mesh, dev, B, S_total, cfg.num_heads,
                                       cfg.num_kv_heads, cfg.head_dim)}
    del cache
    if dist.get_rank() == 0:
        kernels.reset_launches()
        u_ids, u_logits, _, u_ms = run(build_prefill_step(model, S_total),
                                       build_serve_step(model), feed=ids)
        out["unsharded"] = {"argmax": u_ids, "logits": u_logits,
                            "ms_per_step": u_ms,
                            "launches": dict(kernels.LAUNCHES)}
    del model
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    # float32 activations: no bf16 rounding to flip, the sums' order only
    saved = transformer.COMPUTE_DTYPE
    transformer.COMPUTE_DTYPE = torch.float32
    try:
        cfg32 = dataclasses.replace(cfg, attn_impl="chunked")
        model = LM(cfg32, init_params(build_defs(cfg32), seed=0, device=dev))
        batch32 = make_batch(cfg32, B, prompt, kind="prefill", device=dev)
        run = _decode_runs(model, batch32, prompt, gen, mesh, dev)
        ids32, logits32, _, _ = run(build_prefill_step(model, S_total, mesh),
                                    build_serve_step(model, mesh),
                                    steps=min(F32_DECODE_STEPS, gen - 1))
        if dist.get_rank() == 0:
            with _Plain():
                out["float32"] = {"logits": logits32, "plain": run(
                    build_prefill_step(model, S_total),
                    build_serve_step(model), feed=ids32,
                    steps=min(F32_DECODE_STEPS, gen - 1))[1]}
    finally:
        transformer.COMPUTE_DTYPE = saved
    return out if dist.get_rank() == 0 else None


def _near_tie_rows(ids, served: dict, logits: list, phase: str) -> int:
    """The rows of ``ids`` apart from phase 11's (``served``) first ids:
    equal until a row's first difference, which must be a near-tie of
    one process's ``logits`` (fed ``ids``; ``_decode_runs``' order) at
    that step."""
    want = torch.from_numpy(np.asarray(served["tokens"]))[:, :ids.shape[1]]
    ties = 0
    for r in range(ids.shape[0]):
        apart = (ids[r] != want[r]).nonzero()
        if len(apart) == 0:
            continue
        t = int(apart[0])
        b = logits[t][r]
        top = torch.topk(b, 2).values
        check(float(top[0] - top[1]) <= LOGIT_TOL
              and float(b[int(ids[r, t])]) >= float(top[0]) - LOGIT_TOL,
              f"{phase}: row {r} step {t} picks {int(ids[r, t])}, "
              f"phase 11 {int(want[r, t])}")
        ties += 1
    return ties


def sharded_decode_phase(served: dict, got: dict, seconds: float) -> dict:
    """Phase 30c's checks: the sequence-sharded decode on a (1, 2) mesh
    (rank 0's ``_sharded_decode_rank`` numbers, ``got``) against phase
    11's run (``served``) and the unsharded decodes fed its ids."""
    cfg = get_config(LM_ARCH)
    S_total = SHARDED_CACHE
    check(got["local_s"] == S_total // 2,
          f"phase 30c: each rank holds {got['local_s']} of {S_total} "
          "positions")
    check(got["launches"]["decode_attention"] == 0
          and got["launches"]["flash_attention_fwd"] == cfg.num_layers,
          f"phase 30c: launches {got['launches']}")
    # each attention call on equal inputs: within DECODE_CALL_REL_TOL of
    # the largest value, as phase 29a holds a decode attention call
    for pos, window, diff, top in got["calls"]:
        check(diff <= DECODE_CALL_REL_TOL * top, f"phase 30c: the sharded "
              f"attention at position {pos} window {window} is {diff} from "
              f"the plain version's on equal inputs (largest value {top})")
    # float32 activations: the sharded decode's logits within
    # F32_LOGIT_TOL of the unsharded plain decode's, every step
    f32 = max(float((a - b).abs().max()) for a, b in zip(
        got["float32"]["logits"], got["float32"]["plain"]))
    check(f32 <= F32_LOGIT_TOL, f"phase 30c: float32 logits {f32} from the "
          f"unsharded decode's (limit {F32_LOGIT_TOL})")
    # bf16, as served: finite logits; their gap to the unsharded decode
    # through the kernel reported: a 1-ulp flip of a bf16 attention output
    # (the partials' float32 arithmetic against the kernel's bf16
    # probabilities) moves the logits downstream
    gaps = []
    for t, a in enumerate(got["logits"]):
        check(bool(torch.isfinite(a).all()), f"phase 30c: step {t} logits")
        gaps.append(float((a - got["unsharded"]["logits"][t]).abs().max()))
    ties = _near_tie_rows(got["ids"], served, got["unsharded"]["logits"],
                          "phase 30c")
    partial_bytes = (SERVE_BATCH * cfg.num_heads * (cfg.head_dim + 2) * 4
                     * cfg.num_layers)
    out = {"ms_per_step": got["ms_per_step"],
           "unsharded_ms_per_step": got["unsharded"]["ms_per_step"],
           "phase11_ms_per_step": served["decode_ms_per_step"],
           "calls": got["calls"], "float32_max_logit_diff": f32,
           "bf16_logit_diff_by_step": gaps,
           "bf16_steps_past_logit_tol": sum(g > LOGIT_TOL for g in gaps),
           "near_tie_rows": ties, "partial_bytes_per_step": partial_bytes,
           "backend": got["backend"], "launches": got["launches"],
           "seconds": seconds}
    print(f"[smoke] phase 30c: (1, 2) mesh ({got['backend']}): decode "
          f"{got['ms_per_step']:.3f} ms/step (unsharded in the same run "
          f"{got['unsharded']['ms_per_step']:.3f}, phase 11 "
          f"{served['decode_ms_per_step']:.3f}); equal-input calls "
          f"{[(p, w, round(d, 6)) for p, w, d, _ in got['calls']]}; "
          f"float32 logits within {f32:.3g}; bf16 logits from the "
          f"decode kernel's run up to {max(gaps):.4g} "
          f"({out['bf16_steps_past_logit_tol']} of {len(gaps)} steps past "
          f"{LOGIT_TOL}); "
          f"{ties} row(s) apart from phase 11 at a near-tie; "
          f"{partial_bytes} partial bytes cross a step "
          f"({partial_bytes // cfg.num_layers} a layer); {seconds:.1f} s")
    return out


def _mesh_lm_rank(mesh, cfg, device: str, argv_tp: list) -> dict | None:
    """One rank of the (1, 2) mesh's spawn, which phases 30c and 31 share
    (one process start instead of two): ``_sharded_decode_rank``, then
    ``_tp_rank``.  Rank 0 returns both parts' numbers."""
    t0 = time.perf_counter()
    sharded = _sharded_decode_rank(mesh, cfg, device, SERVE_BATCH,
                                   SERVE_PROMPT, SHARDED_GEN)
    sharded_s = time.perf_counter() - t0
    tp = _tp_rank(mesh, argv_tp, device)
    if sharded is None:
        return None
    return {"30c": sharded, "30c_s": sharded_s, "31": tp}


def mesh_lm_phase(argv_lm: list, phase14: dict, served: dict) -> tuple:
    """Phase 30: the "dots" policy (a), the train entry point on the data
    mesh (b) and the sequence-sharded decode (c); the (1, 2) mesh's
    spawn also runs phase 31's ranks, after 31a's one-process run.
    Returns (phase 30's numbers, phase 31's parts for ``tp_phase``)."""
    t0 = time.perf_counter()
    out = {"dots": dots_phase(), "data_mesh": data_mesh_phase(argv_lm,
                                                              phase14)}
    one = _tp_one_process(argv_lm)
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    t1 = time.perf_counter()
    got = run_on_mesh((1, 2), ("data", "model"), DEVICE, _mesh_lm_rank,
                      cfg, DEVICE, one["argv"])
    tp = got["31"]
    tp_s = tp["a_s"] + tp["b_s"] + tp["c_s"]
    # the spawn's start and end count to phase 30c
    out["sharded_decode"] = sharded_decode_phase(
        served, got["30c"], time.perf_counter() - t1 - tp_s)
    out["seconds"] = time.perf_counter() - t0 - tp_s - one["seconds"]
    print(f"[smoke] phase 30: {out['seconds']:.1f} s (phase 31's "
          f"{tp_s + one['seconds']:.1f} s in its spawn apart)")
    return out, (one, tp)


# ---------------------------------------------------------------------------
# Phase 31: tensor parallelism over the (1, 2) mesh's 'model' axis
# ---------------------------------------------------------------------------

def _per_rank(value):
    """``value`` of every rank of the default group, in rank order."""
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, value)
    return every


def _tp_decode(mesh, dev) -> dict:
    """31b on one rank: qwen2-0.5b served with tensor-parallel weights
    and the sequence-sharded cache, in bf16 and in float32 activations;
    rank 0 also decodes with whole weights, fed the same ids (bf16 through
    the kernel, float32 through its plain version)."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import TensorParallel

    rank0 = dist.get_rank() == 0
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    defs = build_defs(cfg)
    tp = TensorParallel.of(defs, mesh)
    model = LM(cfg, init_params(defs, seed=0, device=dev, dtype=COMPUTE_DTYPE,
                                tp=tp), mesh=mesh)
    batch = make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, kind="prefill",
                       device=dev)
    run = _decode_runs(model, batch, SERVE_PROMPT, SHARDED_GEN, mesh, dev)
    kernels.reset_launches()
    col.reset_traffic()
    ids, logits, cache, ms = run(build_prefill_step(model, SHARDED_CACHE),
                                 build_serve_step(model))
    out = {"ids": ids, "logits": logits, "ms_per_step": ms,
           "traffic": _per_rank(dict(col.TRAFFIC)),
           "launches": _per_rank(dict(kernels.LAUNCHES)),
           "local_s": cache["k"].to_local().shape[2],
           "local_heads": (model.blocks["wq"].shape[2],
                           model.blocks["wk"].shape[2])}
    del cache, model
    if rank0:
        whole = LM(cfg, init_params(defs, seed=0, device=dev,
                                    dtype=COMPUTE_DTYPE))
        _, u_logits, _, u_ms = run(build_prefill_step(whole, SHARDED_CACHE),
                                   build_serve_step(whole), feed=ids)
        out["unsharded"] = {"logits": u_logits, "ms_per_step": u_ms}
        del whole
    torch.cuda.empty_cache()
    steps = TP_F32_STEPS
    saved = transformer.COMPUTE_DTYPE
    transformer.COMPUTE_DTYPE = torch.float32
    try:
        cfg32 = dataclasses.replace(cfg, attn_impl="chunked")
        model = LM(cfg32, init_params(defs, seed=0, device=dev, tp=tp),
                   mesh=mesh)
        ids32, logits32, _, _ = run(build_prefill_step(model, SHARDED_CACHE),
                                    build_serve_step(model), steps=steps)
        del model
        if rank0:
            whole = LM(cfg32, init_params(defs, seed=0, device=dev))
            with _Plain():
                plain = run(build_prefill_step(whole, SHARDED_CACHE),
                            build_serve_step(whole), feed=ids32,
                            steps=steps)[1]
            out["float32"] = {"logits": logits32, "plain": plain}
            del whole
    finally:
        transformer.COMPUTE_DTYPE = saved
    torch.cuda.empty_cache()
    return out


def _first_layer(arch: str, dev, tp=None) -> tuple:
    """(cfg, layer 0 of the full model's blocks in bf16): the rank's
    shards with ``tp``, whole without."""
    cfg = get_config(arch)
    local = init_params(build_defs(cfg), seed=0, device=dev,
                        dtype=COMPUTE_DTYPE, layers=1, tp=tp)
    return cfg, {k: w[0] for k, w in local["blocks"].items()}


def _tp_layers(mesh, dev) -> dict:
    """31c on one rank: one layer of moonshot's MoE block and of mamba2's
    mixer at full width, split over the ranks, on equal bf16 inputs at B
    8 x 2048; rank 0 also runs each layer whole."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import TensorParallel

    rank0 = dist.get_rank() == 0
    out = {}

    def rel(a, b):
        return float((a.float() - b.float()).norm()
                     / b.float().norm().clamp_min(1e-30))

    for arch in TP_LAYER_ARCHS:
        cfg = get_config(arch)
        tp = TensorParallel.of(build_defs(cfg), mesh)
        _, p = _first_layer(arch, dev, tp)
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(SERVE_BATCH, SERVE_PROMPT, cfg.d_model, generator=g,
                        device=dev).to(COMPUTE_DTYPE)
        kernels.reset_launches()
        with torch.no_grad():
            if cfg.family == "moe":
                got = transformer._moe_block(cfg, p, x, cfg.capacity_factor,
                                             tp)[0]
                h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
                r = moe.route(p["router"], h, top_k=cfg.experts_per_token,
                              capacity_factor=cfg.capacity_factor,
                              routing=cfg.routing, groups=cfg.moe_groups)
                routes = _per_rank((r.keep.cpu(), r.expert_idx.cpu()))
            else:
                got, (state, _) = ssm.apply_ssm(p, x, chunk=cfg.ssm_chunk,
                                                tp=tp,
                                                **transformer._ssm_kw(cfg))
                state = _per_rank(state.cpu())
        row = {"launches": _per_rank(dict(kernels.LAUNCHES)),
               "local": {k: tuple(v.shape) for k, v in p.items()
                         if tp.sharded(k)}}
        torch.cuda.synchronize(dev)
        if rank0:
            _, pw = _first_layer(arch, dev)
            with torch.no_grad():
                if cfg.family == "moe":
                    want = transformer._moe_block(cfg, pw, x,
                                                  cfg.capacity_factor)[0]
                    rw = moe.route(pw["router"], h,
                                   top_k=cfg.experts_per_token,
                                   capacity_factor=cfg.capacity_factor,
                                   routing=cfg.routing,
                                   groups=cfg.moe_groups)
                    row["routes_equal"] = all(
                        torch.equal(k, rw.keep.cpu())
                        and torch.equal(e, rw.expert_idx.cpu())
                        for k, e in routes)
                    row["kept"] = int(rw.keep.sum())
                else:
                    want, (sw, _) = ssm.apply_ssm(pw, x, chunk=cfg.ssm_chunk,
                                                  **transformer._ssm_kw(cfg))
                    H = sw.shape[1] // len(state)
                    row["state_rel_l2"] = max(
                        rel(s, sw[:, i * H:(i + 1) * H].cpu())
                        for i, s in enumerate(state))
            row["out_rel_l2"] = rel(got, want)
            del pw, want
        out[arch] = row
        del p, x, got
        torch.cuda.empty_cache()
    return out


def _dp_moe_layer(dev) -> dict:
    """31c's data-parallel case on one rank: one layer of moonshot's MoE
    block at full width and ``moe_groups`` DP_MOE_GROUPS on the (2, 1)
    mesh, this rank's DP_MOE_ROWS rows of 2048 under ``global_dispatch``
    over the ``data`` ranks; every rank also runs all the rows as one
    process and holds its own rows' routing and outputs against that
    run's.  Where an expert id differs (the router product's float32
    sums in another order at another row count), its two scores must lie
    within ROUTER_TIE_TOL of each other, and the outputs are compared on
    the tokens routed alike."""
    from repro_torch.launch.mesh import make_device_mesh

    mesh = make_device_mesh((2, 1), device=dev.type)
    rank, R = mesh.get_local_rank("data"), DP_MOE_ROWS
    cfg = dataclasses.replace(get_config(MOE_ARCH), moe_groups=DP_MOE_GROUPS)
    _, p = _first_layer(MOE_ARCH, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn(2 * R, SERVE_PROMPT, cfg.d_model, generator=g,
                     device=dev)
         + DP_MOE_SKEW * torch.randn(cfg.d_model, generator=g, device=dev)
         ).to(COMPUTE_DTYPE)
    kw, k = _moe_kw(cfg), cfg.experts_per_token
    mine = x[rank * R:(rank + 1) * R]
    with torch.no_grad():
        with moe.global_dispatch(mesh.get_group("data")):
            got = transformer._moe_block(cfg, p, mine, cfg.capacity_factor)[0]
            r = moe.route(p["router"], rmsnorm(mine, p["mlp_norm"],
                                               cfg.norm_eps), **kw)
        want = transformer._moe_block(cfg, p, x, cfg.capacity_factor)[0]
        h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        w = moe.route(p["router"], h, **kw)
        Tl = R * SERVE_PROMPT
        ew = w.expert_idx.reshape(-1, k)[rank * Tl:(rank + 1) * Tl].cpu()
        er = r.expert_idx.reshape(-1, k).cpu()
        keep_w = w.keep.reshape(-1, k)[rank * Tl:(rank + 1) * Tl].cpu()
        keep_r = r.keep.reshape(-1, k).cpu()
        differ = (ew != er).any(-1).nonzero()[:, 0].tolist()
        gaps = []
        if differ:
            hc = h.reshape(-1, cfg.d_model)[rank * Tl:(rank + 1) * Tl].cpu()
            scores = hc[differ].float() @ p["router"].float().cpu()
            if cfg.routing != "softmax":
                scores = torch.sigmoid(scores)
            for i, t in enumerate(differ):
                j = int((er[t] != ew[t]).nonzero()[0, 0])
                gaps.append(abs(float(scores[i, er[t, j]]
                                      - scores[i, ew[t, j]])))
        # keep flags apart on tokens whose expert ids agree: a near-tie
        # moves one of k ids, so two experts' counts by one each, and so
        # at most two keep flags after it in its group, on either rank
        same_ids = (ew == er).all(-1, keepdim=True)
        keep_apart = int(((keep_w != keep_r) & same_ids).sum())
        # the outputs of the tokens routed alike (all of them without a
        # near-tie)
        alike = ((ew == er) & (keep_w == keep_r)).all(-1).to(dev)
        a = got.reshape(-1, cfg.d_model)[alike].float()
        b = want[rank * R:(rank + 1) * R].reshape(-1, cfg.d_model)[alike]
        row = {"rank": rank, "parts": int(r.slot_tok.shape[0]),
               "kept": int(keep_r.sum()), "kept_one": int(keep_w.sum()),
               "keep_equal": torch.equal(keep_r, keep_w),
               "keep_apart": keep_apart, "ids_apart": len(differ), "max_gap": max(gaps, default=0.0),
               "routed_alike": int(alike.sum()), "tokens": Tl, "k": k,
               "aux": float(r.aux), "aux_one": float(w.aux),
               "out_rel_l2": float((a - b.float()).norm()
                                   / b.float().norm())}
    del p, x, got, want, h, r, w
    torch.cuda.empty_cache()
    return _per_rank(row)


def _tp_rank(mesh, argv_tp: list, device: str) -> dict | None:
    """One rank of phase 31 (a spawned rank imports this script afresh,
    so everything it reads is an argument or a constant): 31a through
    the launcher on this process group, then 31b and 31c.  Rank 0
    returns every part's numbers."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as col

    dev = rank_device(device)
    out, t0 = {}, time.perf_counter()
    kernels.reset_launches()
    col.reset_traffic()
    out["a"] = train.main(argv_tp + ["--mesh", "1x2"])
    out["a_traffic"] = _per_rank(dict(col.TRAFFIC))
    torch.cuda.empty_cache()
    out["a_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["b"] = _tp_decode(mesh, dev)
    out["b_s"], t0 = time.perf_counter() - t0, time.perf_counter()
    out["c"] = _tp_layers(mesh, dev)
    out["c_dp"] = _dp_moe_layer(dev)
    out["c_s"] = time.perf_counter() - t0
    out["backend"] = dist.get_backend()
    return out if dist.get_rank() == 0 else None


def _tp_one_process(argv_lm: list) -> dict:
    """Phase 31a's twin on one process: phase 14's command at B
    TP_TRAIN_BATCH, DOTS_STEPS steps, just before the mesh's run."""
    t0 = time.perf_counter()
    argv = list(argv_lm)
    argv[argv.index("--batch") + 1] = str(TP_TRAIN_BATCH)
    argv[argv.index("--steps") + 1] = str(DOTS_STEPS)
    print(f"[smoke] phase 31a: train {' '.join(argv)} (one process)")
    torch.cuda.empty_cache()
    kernels.reset_launches()
    run = train.main(argv)
    torch.cuda.empty_cache()
    return {"argv": argv, "run": run, "base": torch.cuda.memory_allocated(),
            "seconds": time.perf_counter() - t0}


def tp_phase(served: dict, one_run: dict, got: dict) -> dict:
    """Phase 31 (the module docstring): tensor parallelism on the (1, 2)
    mesh, rank 0's numbers (``got``, ``_tp_rank``) against one process
    (``one_run``, ``_tp_one_process``) and phase 11 (``served``)."""
    t0 = time.perf_counter()
    one, one_s, base = one_run["run"], one_run["seconds"], one_run["base"]
    layers = get_config(LM_ARCH).num_layers
    out = {"backend": got["backend"], "rank0_base_bytes": base,
           "seconds": {"one_process": one_s, "a": got["a_s"],
                       "b": got["b_s"], "c": got["c_s"]}}
    # 31a
    a = got["a"]
    check(a["world"] == 2 and tuple(a["mesh"]) == (1, 2),
          f"phase 31a: world {a['world']} mesh {a['mesh']}")
    for x, y in zip(a["losses"], one["losses"]):
        check(abs(x - y) <= TP_LOSS_REL_TOL * abs(y),
              f"phase 31a: losses {a['losses']} vs one process's "
              f"{one['losses']}")
    want = {"flash_attention_fwd": 2 * layers * DOTS_STEPS,
            "flash_attention_bwd_dq": layers * DOTS_STEPS,
            "flash_attention_bwd_dkv": layers * DOTS_STEPS}
    for r, launches in enumerate(a["launches_per_rank"]):
        for kname, n in want.items():
            check(launches[kname] == n, f"phase 31a: rank {r} launched "
                  f"{kname} {launches[kname]} times, not {n}")
    out["a"] = {k: a[k] for k in ("losses", "grad_norms", "step_ms",
                                  "peak_bytes_per_rank",
                                  "launches_per_rank")}
    # the tensor-parallel all_reduces a step on each rank, and their bytes
    out["a"]["traffic_per_step"] = [
        {k: v / DOTS_STEPS for k, v in t.items()} for t in got["a_traffic"]]
    out["a"]["one_process"] = {k: one[k] for k in (
        "losses", "grad_norms", "step_ms", "peak_bytes")}
    print(f"[smoke] phase 31a: (1, 2) mesh ({got['backend']}): step ms "
          f"{[round(t, 3) for t in a['step_ms']]} (one process "
          f"{[round(t, 3) for t in one['step_ms']]}), peak device memory per "
          f"rank {[p and round(p / 2**30, 2) for p in a['peak_bytes_per_rank']]}"
          f" GiB (one process {(one['peak_bytes'] or 0) / 2**30:.2f}; rank 0 "
          f"holds {base / 2**30:.2f} GiB of earlier phases), losses "
          f"{a['losses']} "
          f"(one process {one['losses']}), launches per rank "
          f"{[{k: n[k] for k in want} for n in a['launches_per_rank']]}, "
          f"tensor-parallel all_reduces a step per rank "
          f"{out['a']['traffic_per_step']}; {got['a_s']:.1f} s")
    # 31b
    b = got["b"]
    check(b["local_s"] == SHARDED_CACHE // 2,
          f"phase 31b: each rank holds {b['local_s']} of {SHARDED_CACHE} "
          "positions")
    check(tuple(b["local_heads"]) == (7, 1),
          f"phase 31b: each rank's q and kv heads {b['local_heads']}")
    for r, launches in enumerate(b["launches"]):
        check(launches["flash_attention_fwd"] == layers
              and launches["decode_attention"] == 0,
              f"phase 31b: rank {r} launches {launches}")
    for t, lg in enumerate(b["logits"]):
        check(bool(torch.isfinite(lg).all()), f"phase 31b: step {t} logits")
    gaps = [float((x - y).abs().max())
            for x, y in zip(b["logits"], b["unsharded"]["logits"])]
    ties = _near_tie_rows(b["ids"], served, b["unsharded"]["logits"],
                          "phase 31b")
    f32 = max(float((x - y).abs().max()) for x, y in zip(
        b["float32"]["logits"], b["float32"]["plain"]))
    check(f32 <= F32_LOGIT_TOL, f"phase 31b: float32 logits {f32} from one "
          f"process's (limit {F32_LOGIT_TOL})")
    out["b"] = {"ms_per_step": b["ms_per_step"],
                "one_process_ms_per_step": b["unsharded"]["ms_per_step"],
                "phase11_ms_per_step": served["decode_ms_per_step"],
                "launches": b["launches"], "near_tie_rows": ties,
                "traffic": b["traffic"],
                "float32_max_logit_diff": f32,
                "bf16_logit_diff_by_step": gaps}
    print(f"[smoke] phase 31b: tensor-parallel weights (q/kv heads a rank "
          f"{b['local_heads']}), cache {SHARDED_CACHE} split on S: decode "
          f"{b['ms_per_step']:.3f} ms/step (one process in the same run "
          f"{b['unsharded']['ms_per_step']:.3f}, phase 11 "
          f"{served['decode_ms_per_step']:.3f}); {ties} row(s) apart from "
          f"phase 11 at a near-tie; float32 logits within {f32:.3g}; bf16 "
          f"logits from one process's up to {max(gaps):.4g}; launches per "
          f"rank {[{k: n for k, n in l.items() if n} for l in b['launches']]}"
          f"; tensor-parallel all_reduces (prefill and {SHARDED_GEN - 1} "
          f"steps) per rank {b['traffic']}; {got['b_s']:.1f} s")
    # 31c
    c = got["c"]
    for arch, row in c.items():
        check(row["out_rel_l2"] <= TP_LAYER_REL_TOL,
              f"phase 31c ({arch}): outputs {row['out_rel_l2']:.3g} relative "
              f"L2 from one process's (limit {TP_LAYER_REL_TOL})")
        if "routes_equal" in row:
            check(row["routes_equal"], f"phase 31c ({arch}): a rank routes "
                  "apart from one process")
        else:
            check(row["state_rel_l2"] <= TP_LAYER_REL_TOL,
                  f"phase 31c ({arch}): final state {row['state_rel_l2']:.3g}"
                  f" relative L2 (limit {TP_LAYER_REL_TOL})")
            for r, launches in enumerate(row["launches"]):
                check(launches["ssd_chunk_scan"] == 1,
                      f"phase 31c ({arch}): rank {r} launches {launches}")
        print(f"[smoke] phase 31c ({arch}, one layer, B {SERVE_BATCH} x "
              f"{SERVE_PROMPT}): shards {row['local']}, outputs within "
              f"{row['out_rel_l2']:.3g} relative L2 of one process's"
              + (f", kept assignments equal on both ranks and one process "
                 f"({row['kept']} kept)" if "kept" in row else
                 f", final state within {row['state_rel_l2']:.3g}")
              + f"; launches per rank "
              f"{[{k: n for k, n in l.items() if n} for l in row['launches']]}")
    out["c"] = c
    # 31c's data-parallel case
    ids_apart = sum(row["ids_apart"] for row in got["c_dp"])
    for row in got["c_dp"]:
        tag = f"phase 31c ({MOE_ARCH}, (2, 1) mesh, rank {row['rank']})"
        check(row["max_gap"] <= ROUTER_TIE_TOL, f"{tag}: an expert id apart "
              f"from one process's, {row['max_gap']:g} apart in the scores")
        # every keep flag is the one process's but for what the near-ties
        # of either rank move (none without one): a part's offset wrong
        # by any count moves more
        check(row["keep_apart"] <= 2 * row["k"] * ids_apart,
              f"{tag}: {row['keep_apart']} keep flags apart from one "
              f"process's on tokens with its expert ids ({ids_apart} "
              "tokens' ids apart on the ranks)")
        check(row["kept"] < row["tokens"] * row["k"],
              f"{tag}: no assignment dropped")
        check(abs(row["aux"] - row["aux_one"]) <= 1e-5 * abs(row["aux_one"]),
              f"{tag}: aux {row['aux']} vs one process's {row['aux_one']}")
        check(row["out_rel_l2"] <= TP_LAYER_REL_TOL,
              f"{tag}: outputs {row['out_rel_l2']:.3g} relative L2 from one "
              f"process's (limit {TP_LAYER_REL_TOL})")
    out["c_dp"] = got["c_dp"]
    print(f"[smoke] phase 31c ({MOE_ARCH}, one layer, (2, 1) mesh, "
          f"{DP_MOE_ROWS} rows of {SERVE_PROMPT} a rank, moe_groups "
          f"{DP_MOE_GROUPS}: group 1 straddles the ranks): per rank "
          + "; ".join(
              f"rank {r['rank']}: {r['parts']} parts, {r['kept']} of "
              f"{r['tokens'] * r['k']} assignments kept (one process "
              f"{r['kept_one']}, keep flags "
              f"{'equal' if r['keep_equal'] else 'apart'}, "
              f"{r['keep_apart']} apart on tokens of equal ids, "
              f"{r['ids_apart']} tokens' expert ids apart at near-ties), aux "
              f"{r['aux']:.6g} (one process {r['aux_one']:.6g}), outputs of "
              f"the {r['routed_alike']} of {r['tokens']} tokens routed alike "
              f"within {r['out_rel_l2']:.3g} relative L2"
              for r in got["c_dp"]))
    out["seconds"]["total"] = (time.perf_counter() - t0 + one_s
                               + got["a_s"] + got["b_s"] + got["c_s"])
    print(f"[smoke] phase 31: {out['seconds']['total']:.1f} s (one process "
          f"{one_s:.1f}, a {got['a_s']:.1f}, b {got['b_s']:.1f}, c "
          f"{got['c_s']:.1f}; its ranks ran in phase 30c's spawn)")
    return out


def _same_layout(real, fake, what: str) -> None:
    """Each fake output has its real twin's shape, dtype and strides."""
    for i, (r, f) in enumerate(zip(real, fake)):
        check(tuple(r.shape) == tuple(f.shape) and r.dtype == f.dtype
              and r.stride() == f.stride() and f.is_cuda,
              f"phase 32a {what} output {i}: real {tuple(r.shape)} "
              f"{r.dtype} {r.stride()}, fake {tuple(f.shape)} {f.dtype} "
              f"{f.stride()} on {f.device}")


def _traced(fn, *real_inputs):
    """``fn`` on fake copies of ``real_inputs`` under FlopCounterMode:
    (its fake outputs as a tuple, the FLOPs counted by op)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    mode = FakeTensorMode()
    fakes = [mode.from_tensor(x) for x in real_inputs]
    with mode, FlopCounterMode(display=False) as flops:
        out = fn(*fakes)
    out = out if isinstance(out, tuple) else (out,)
    by_op = {str(k): v for k, v in flops.get_flop_counts()["Global"].items()}
    return out, by_op


def fake_kernel_phase() -> dict:
    """Phase 32a: the LM kernel entries of ``kernels.ops`` on fake copies
    of phase 3's inputs (its main case of each kernel, the non-causal
    backward, a windowed decode and two SSD cases): every output's shape,
    dtype and strides equal the real launch's on the same inputs, and the
    FLOPs that ``FlopCounterMode`` counts (the ops' formulas) equal the
    operations behind phase 3's bounds, op by op.  The real launches here
    are outside every counted window."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(32)
    rows = []
    B, S, Hq, Hkv, D = FLASH_CASES[0]
    q = _bf16_randn(gen, B, S, Hq, D)
    k, v = _bf16_randn(gen, B, S, Hkv, D), _bf16_randn(gen, B, S, Hkv, D)
    real = ops.flash_attention_fwd(q, k, v, causal=True)
    fake, flops = _traced(lambda *a: ops.flash_attention_fwd(*a), q, k, v)
    _same_layout(real, fake, f"flash forward {FLASH_CASES[0]}")
    want = {"repro_torch.flash_attention_fwd": flash_fwd_ops(B, S, Hq, D)}
    check(flops == want, f"phase 32a flash forward FLOPs {flops} vs {want}")
    rows.append({"kernel": "flash_attention_fwd", "shape": FLASH_CASES[0],
                 "flops": flops})
    del q, k, v, real
    for case in (FLASH_BWD_CASES[0], FLASH_BWD_CASES[4]):
        B, S, Hq, Hkv, D, causal = case
        q = _bf16_randn(gen, B, S, Hq, D)
        k, v = _bf16_randn(gen, B, S, Hkv, D), _bf16_randn(gen, B, S, Hkv, D)
        out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
        do = _bf16_randn(gen, B, S, Hq, D)
        real = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        fake, flops = _traced(
            lambda *a: ops.flash_attention_bwd(*a, causal=causal),
            q, k, v, out, lse, do)
        _same_layout(real, fake, f"flash backward {case}")
        product = flash_product(B, S, Hq, D, causal)
        want = {"repro_torch.flash_attention_bwd_dq": 3 * product,
                "repro_torch.flash_attention_bwd_dkv": 4 * product}
        check(flops == want, f"phase 32a flash backward {case} FLOPs "
              f"{flops} vs {want}")
        rows.append({"kernel": "flash_attention_bwd", "shape": case,
                     "flops": flops})
        del q, k, v, out, lse, do, real
    B, S, Hq, Hkv, D = DECODE_SHAPE
    kc, vc = _bf16_randn(gen, B, S, Hkv, D), _bf16_randn(gen, B, S, Hkv, D)
    q = _bf16_randn(gen, B, Hq, D)
    for valid, window in ((S, 0), (1000, 512)):
        real = ops.decode_attention(q, kc, vc, valid, window)
        fake, flops = _traced(
            lambda *a: ops.decode_attention(*a, valid, window), q, kc, vc)
        _same_layout((real,), fake, f"decode {DECODE_SHAPE} {valid, window}")
        want = {"repro_torch.decode_attention":
                decode_ops(B, Hq, D, *valid_range(S, valid, window))}
        check(flops == want, f"phase 32a decode FLOPs {flops} vs {want}")
        rows.append({"kernel": "decode_attention",
                     "shape": [*DECODE_SHAPE, valid, window], "flops": flops})
    del kc, vc, q
    for case in (SSD_GROUP_CASE, SSD_TP_CASE):
        b, s, h, p, g, n, chunk = case
        x = torch.randn(b, s, h, p, generator=gen, device=DEVICE)
        dt = torch.randn(b, s, h, generator=gen, device=DEVICE).abs() * 0.1
        A = -torch.randn(h, generator=gen, device=DEVICE).abs()
        Bm = torch.randn(b, s, g, n, generator=gen, device=DEVICE)
        Cm = torch.randn(b, s, g, n, generator=gen, device=DEVICE)
        real = ops.ssd_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)
        fake, flops = _traced(
            lambda *a: ops.ssd_chunk_scan(*a, chunk=chunk), x, dt, A, Bm, Cm)
        _same_layout(real, fake, f"ssd_chunk_scan {case}")
        want = {"repro_torch.ssd_chunk_scan":
                3 * ssd_products(b, s, h, p, g, n, chunk)}
        check(flops == want, f"phase 32a SSD FLOPs {flops} vs {want}")
        rows.append({"kernel": "ssd_chunk_scan", "shape": case,
                     "flops": flops})
        del x, dt, A, Bm, Cm, real
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"[smoke] phase 32a: {len(rows)} kernel calls on fake tensors: "
          f"outputs' shapes, dtypes and strides equal the launches', FLOPs "
          f"equal the bounds' operations ({seconds:.1f} s)")
    return {"cases": rows, "seconds": seconds}


def dryrun_cells_start(out_dir: str) -> list:
    """Phase 32c's dry-run cells (``DRYRUN_CELLS``), each ``python -m
    repro_torch.launch.dryrun --arch ARCH --shape train_4k`` (with
    ``--multi-pod`` on (2, 16, 16)) in a process of its own (one torch
    thread), started together before the kernels' build: they trace on
    the host's CPU beside the build and phase 3's graph builds (numpy),
    and phase 3 waits for the first ones before it times a kernel (the
    smallest kernels' times take the host's enqueue in, which the cells'
    CPU load would move); the last, the longest, goes on only where the
    checks time nothing (``HeldProcess``) and is waited for in phase 32.
    Killed at exit if still running."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for arch, mesh_name in DRYRUN_CELLS:
        extra = ["--multi-pod"] if mesh_name == "2x16x16" else []
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", "train_4k", "--device", "cuda", "--out",
               out_dir, *extra]
        # each cell's output to a file: a pipe read only in phase 32
        # could fill and stop it
        with open(os.path.join(out_dir, f"cell{len(procs)}.log"), "w") as f:
            # a session of its own: a stopped process (``HeldProcess``)
            # in this script's process group would bring the kernel's
            # SIGHUP onto the whole group once the group is orphaned
            procs.append((cmd, subprocess.Popen(
                cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)))

    def stop():
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    atexit.register(stop)
    return procs


def dryrun_cells_wait(procs: list) -> float:
    """Wait for the cells of ``dryrun_cells_start``; the seconds waited."""
    t0 = time.perf_counter()
    for _, proc in procs:
        proc.wait(timeout=DRYRUN_CELL_TIMEOUT_S)
    return time.perf_counter() - t0


class HeldProcess:
    """A background process (phase 32c's longest dry-run cell) that runs
    only inside ``running()``, around checks that time nothing (card
    against CPU), and is stopped (SIGSTOP) outside, so that its CPU load
    moves no timed phase; ``held_s`` counts the seconds it was stopped.
    A no-op once the process has ended."""

    def __init__(self, proc):
        self.proc, self.held_s, self._since = proc, 0.0, None

    def hold(self) -> None:
        if self._since is None and self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGSTOP)
            self._since = time.perf_counter()

    def release(self) -> None:
        if self._since is not None:
            os.kill(self.proc.pid, signal.SIGCONT)
            self.held_s += time.perf_counter() - self._since
            self._since = None

    @contextlib.contextmanager
    def running(self):
        self.release()
        try:
            yield
        finally:
            self.hold()


def dryrun_phase(trained: dict, procs: list, out_dir: str) -> dict:
    """Phase 32b and c (the module docstring).  b: the dry-run of phase
    14's own configuration (qwen2-0.5b, flash, B 4 x S 4096, one process)
    traced on fake tensors on the card's device type: its peak estimate
    within DRYRUN_PEAK_REL_TOL of phase 14's measured peak, and its bound
    step time (the largest roofline term) beside phase 14's step ms.  c:
    the production-mesh cells of ``dryrun_cells_start`` (ended in phase
    3, ``dryrun_cells_wait``): each exited 0 with ``ok`` and its per-card
    bytes and bound term; seamless-m4t-large-v2's on (2, 16, 16), whose
    16 microbatches of 16 rows outnumber a rank's 8 rows, runs 8 passes
    of 1 row a rank (its verbose line)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.roofline import analysis as roofline

    out = {}
    try:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
        shape = ShapeCell("phase14", TRAIN_SEQ, TRAIN_BATCH, "train")
        costs = dryrun.trace_step(cfg, shape, None, microbatches=1,
                                  device=DEVICE)
        active = transformer.abstract_lm(cfg, device="cpu") \
            .active_param_count()
        terms = roofline.compute_terms_from_costs(
            costs, 1, roofline.model_flops(cfg, shape, active))
        measured_ms = statistics.median(trained["step_ms"][1:])
        rel = costs.peak_bytes / trained["peak_bytes"] - 1
        frac = terms.step_time_s * 1e3 / measured_ms
        out["b"] = {"peak_bytes": costs.peak_bytes,
                    "state_bytes": costs.state_bytes,
                    "measured_peak_bytes": trained["peak_bytes"],
                    "peak_rel_err": rel, "flops": costs.flops,
                    "hbm_bytes": costs.hbm_bytes,
                    "roofline": terms.to_json(),
                    "measured_step_ms": measured_ms,
                    "bound_over_measured": frac,
                    "trace_s": time.perf_counter() - t0}
        print(f"[smoke] phase 32b: dry-run of phase 14 ({LM_ARCH}, flash, "
              f"B {TRAIN_BATCH} x S {TRAIN_SEQ}, one process): peak "
              f"{costs.peak_bytes / 2**30:.2f} GiB against phase 14's "
              f"measured {trained['peak_bytes'] / 2**30:.2f} GiB "
              f"({rel:+.4f}); terms compute {terms.compute_s * 1e3:.3f} ms, "
              f"memory {terms.memory_s * 1e3:.3f} ms, collective "
              f"{terms.collective_s * 1e3:.3f} ms, bound {terms.bound} "
              f"{terms.step_time_s * 1e3:.3f} ms against the measured "
              f"{measured_ms:.3f} ms a step: roofline fraction {frac:.4f}; "
              f"traced in {out['b']['trace_s']:.1f} s")
        check(abs(rel) <= DRYRUN_PEAK_REL_TOL,
              f"phase 32b: the dry-run's peak {costs.peak_bytes} bytes is "
              f"{rel:+.4f} off phase 14's {trained['peak_bytes']}")
        out["c"] = {}
        for i, ((cmd, proc), (arch, mesh_name)) in enumerate(
                zip(procs, DRYRUN_CELLS)):
            with open(os.path.join(out_dir, f"cell{i}.log")) as f:
                log = f.read()
            path = os.path.join(out_dir, f"{arch}__train_4k__"
                                f"{mesh_name}__baseline.json")
            rec = json.load(open(path)) if os.path.exists(path) else {}
            check(proc.returncode == 0 and rec.get("ok"),
                  f"phase 32c: {' '.join(cmd[2:])} exited "
                  f"{proc.returncode}: {log[-2000:]}")
            # "16; a rank: passes=8 rows_per_pass=1 (...)"
            layout = log.split("microbatches:")[-1].splitlines()[0].strip() \
                if "microbatches:" in log else ""
            if arch == DRYRUN_SIDE_ARCH:
                check(rec["microbatches"] == 16
                      and "passes=8 rows_per_pass=1 " in layout,
                      f"phase 32c: {arch} on {mesh_name}: "
                      f"{rec['microbatches']} microbatches, a rank's "
                      f"layout {layout!r} (8 passes of 1 row expected)")
            mem = rec["memory"]
            out["c"][f"{arch} {mesh_name}"] = dict(rec, layout=layout)
            r = rec["roofline"]
            print(f"[smoke] phase 32c: {arch} train_4k on {mesh_name}: "
                  f"ok, {mem['per_chip_live_bytes'] / 2**30:.2f} GiB a card "
                  f"(fits_hbm {mem['fits_hbm']}), terms compute "
                  f"{r['compute_s']:.4e} s, memory {r['memory_s']:.4e} s, "
                  f"collective {r['collective_s']:.4e} s, bound "
                  f"{r['bound']} {r['step_time_s'] * 1e3:.1f} ms, "
                  f"microbatches: {layout}, traced in "
                  f"{rec['trace_s']} s")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    stamps = {}

    def stamp(phase: str) -> None:
        """The script's seconds at the start of ``phase``, printed and
        kept for the details file."""
        stamps[phase] = time.perf_counter() - t_all
        print(f"[smoke] t+{stamps[phase]:.1f} s: phase {phase}")
        # kept as the run goes, so that a run cut short shows its phases
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out",
                               "chip_smoke_progress.json"), "w") as f:
            json.dump(stamps, f)

    card = card_line()
    print(f"[smoke] phase 1: {card}; {torch.cuda.get_device_name(0)}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # phase 32c's cells trace on the host's CPU while the kernels and
    # phase 3's graphs are built, and end before any kernel is timed
    dry_dir = os.path.join(HERE, "chiprun_out", "dryrun")
    dry_procs = dryrun_cells_start(dry_dir)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[smoke] phase 2: built {sorted(logs) or 'nothing (cached)'} in "
          f"{build_s:.1f} s")
    ptxas = _build.ptxas_report(logs)
    for r in ptxas:
        print(f"[smoke]   {r['source']}: {r['kernel']} {r['registers']} "
              f"registers, {r['spill_stores']} bytes spill stores, "
              f"{r['spill_loads']} bytes spill loads")

    stamp("3")
    print("[smoke] phase 3: kernels against their plain versions")
    timer = Timer()
    floor_ms = launch_floor_ms(timer)
    print(f"[smoke]   launch floor (an empty kernel) {floor_ms:.4f} ms")
    reddit = load_dataset("reddit", large_scale=True)
    t0 = time.perf_counter()
    synth = attach_features(rmat_graph(RMAT_NODES, RMAT_EDGES, seed=0,
                                       name="rmat-2^18"), 602, seed=2)
    print(f"[smoke]   {synth.name}: {synth.num_nodes} nodes "
          f"{synth.num_edges} edges, features "
          f"{synth.features.nbytes / 1e6:.0f} MB, built in "
          f"{time.perf_counter() - t0:.1f} s")
    dry_wait_s = dryrun_cells_wait(dry_procs[:-1])
    print(f"[smoke]   phase 32c's first {len(dry_procs) - 1} dry-run cells "
          f"ended {dry_wait_s:.1f} s after the graphs")
    # the last cell goes on only inside ``side.running()``
    side = HeldProcess(dry_procs[-1][1])
    side.hold()
    # the cached kernels' rows are reddit's (phase 8's graph); R-MAT keeps
    # the whole-hop sampler cases as count-0 yardsticks
    per_graph = {"reddit-large": kernel_phase("reddit-lg", reddit, timer,
                                              chunks=True),
                 "rmat-2^18": kernel_phase("rmat-2^18", synth, timer,
                                           chunks=False)}
    edge_loader = PallasSubgraphLoader(reddit, batch_size=BATCH,
                                       fanouts=FANOUTS, seed=0, device=DEVICE)
    edge_cases = {**cached_edge_cases(edge_loader),
                  **inmem_edge_cases(edge_loader)}
    del edge_loader
    torch.cuda.empty_cache()
    lm_cases = lm_kernel_phase(timer)

    stamp("4")
    with side.running():
        parity_phase(reddit)

    stamp("5")
    argv = ["--arch", "graphsage", "--backend", "pallas", "--dataset",
            "reddit", "--large-scale", "--batch", str(BATCH), "--fanouts",
            ",".join(map(str, FANOUTS)), "--hidden", "256", "--steps", "8",
            "--log-every", "1", "--device", DEVICE]
    print(f"[smoke] phase 5: train {' '.join(argv)}")
    kernels.reset_launches()
    stats, losses, _ = train.main(argv)
    launches = dict(kernels.LAUNCHES)
    check(len(losses) == 8 and all(math.isfinite(x) for x in losses),
          f"losses {losses}")
    check(launches["neighbor_sample"] == 2 * 8,
          f"neighbor_sample launched {launches['neighbor_sample']} times")
    check(launches["feature_gather_rows"] == 3 * 8,
          f"feature_gather_rows launched {launches['feature_gather_rows']}")
    print(f"[smoke] phase 5: {stats.steps_per_s:.3f} steps/s, consumer idle "
          f"{stats.idle_fraction:.4f}, launches {launches}")

    stamp("6")
    profile = profile_phase(reddit)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-store-") as store_dir:
        save_graph(reddit, store_dir)
        ooc_parity = ooc_parity_phase(reddit, store_dir)

        argv_ooc = argv + ["--graph-store", "disk", "--cache-mb",
                           str(OOC_CACHE_MB), "--device-cache-rows",
                           str(OOC_ROWS), "--edge-cache-blocks",
                           str(OOC_BLOCKS), "--device-cache-policy",
                           OOC_POLICY]
        print(f"[smoke] phase 8: train {' '.join(argv_ooc)}")
        kernels.reset_launches()
        ooc_stats, ooc_losses, ooc_loader_stats = train.main(argv_ooc)
        ooc_launches = dict(kernels.LAUNCHES)
        disp = ooc_loader_stats["dispatches"]
        check(len(ooc_losses) == 8
              and all(math.isfinite(x) for x in ooc_losses),
              f"out-of-core losses {ooc_losses}")
        check(np.allclose(ooc_losses, losses, rtol=1e-5, atol=1e-5),
              f"out-of-core losses {ooc_losses} vs in-memory {losses}")
        check(ooc_launches["neighbor_sample_cached"]
              == disp["edge_chunks"] > 0,
              f"neighbor_sample_cached launched "
              f"{ooc_launches['neighbor_sample_cached']} times for "
              f"{disp['edge_chunks']} chunks")
        check(ooc_launches["feature_gather_cached"]
              == disp["feature_segments"] > 0,
              f"feature_gather_cached launched "
              f"{ooc_launches['feature_gather_cached']} times for "
              f"{disp['feature_segments']} segments")
        check(ooc_launches["neighbor_sample"] == 0,
              f"neighbor_sample launched {ooc_launches['neighbor_sample']} "
              "times out of core")
        check(ooc_launches["feature_gather_rows"] == 3 * 8,
              f"feature_gather_rows launched "
              f"{ooc_launches['feature_gather_rows']} times out of core")
        diff = max(abs(a - b) for a, b in zip(ooc_losses, losses))
        print(f"[smoke] phase 8: {ooc_stats.steps_per_s:.3f} steps/s, "
              f"consumer idle {ooc_stats.idle_fraction:.4f}, launches "
              f"{ooc_launches}, losses equal to phase 5's within 1e-5 "
              f"(max diff {diff:g})")

        ooc_split = ooc_stage_phase(reddit, store_dir)

    torch.cuda.empty_cache()
    stamp("10")
    with side.running():
        serve_parity = serve_parity_phase()

    layers = get_config(LM_ARCH).num_layers
    argv_serve = ["--arch", LM_ARCH, "--full-config", "--batch",
                  str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT),
                  "--gen", str(SERVE_GEN), "--device", DEVICE]
    print(f"[smoke] phase 11: serve {' '.join(argv_serve)}")
    kernels.reset_launches()
    served = serve.main(argv_serve)
    lm_launches = dict(kernels.LAUNCHES)
    check(lm_launches["flash_attention_fwd"] == layers,
          f"flash_attention_fwd launched "
          f"{lm_launches['flash_attention_fwd']} times, not {layers}")
    check(lm_launches["decode_attention"] == layers * (SERVE_GEN - 1),
          f"decode_attention launched {lm_launches['decode_attention']} "
          f"times, not {layers} x {SERVE_GEN - 1}")
    check(bool(torch.isfinite(served["prefill_logits"]).all()
               and torch.isfinite(served["logits"]).all()),
          "serve: non-finite logits")
    check(served["tokens"].shape == (SERVE_BATCH, SERVE_GEN),
          f"serve: ids of shape {served['tokens'].shape}")
    print(f"[smoke] phase 11: prefill {served['prefill_ms']:.3f} ms, decode "
          f"{served['decode_ms_per_step']:.3f} ms/step, "
          f"{served['tok_per_s']:.1f} tok/s, launches {lm_launches}")

    stamp("12")
    serve_prof = serve_profile_phase()
    torch.cuda.empty_cache()

    stamp("13")
    with side.running():
        train_parity = train_parity_phase()

    stamp("14")
    argv_lm = ["--arch", LM_ARCH, "--batch", str(TRAIN_BATCH), "--seq-len",
               str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--log-every",
               "1", "--attn-impl", "flash", "--device", DEVICE]
    print(f"[smoke] phase 14: train {' '.join(argv_lm)}")
    kernels.reset_launches()
    trained = train.main(argv_lm)
    train_launches = dict(kernels.LAUNCHES)
    want = {"flash_attention_fwd": 2 * layers * TRAIN_STEPS,
            "flash_attention_bwd_dq": layers * TRAIN_STEPS,
            "flash_attention_bwd_dkv": layers * TRAIN_STEPS}
    for kname, n in want.items():
        check(train_launches[kname] == n, f"{kname} launched "
              f"{train_launches[kname]} times in training, not {n}")
    check(len(trained["losses"]) == TRAIN_STEPS
          and all(math.isfinite(x) for x in trained["losses"]),
          f"training losses {trained['losses']}")
    steady = statistics.median(trained["step_ms"][1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ * 1e3 / steady
    print(f"[smoke] phase 14: step ms {trained['step_ms']} (median after "
          f"the first {steady:.3f}, {tok_s:.1f} tok/s), "
          f"{trained['tok_per_s']:.1f} tok/s over the run, peak "
          f"device memory {trained['peak_bytes'] / 2**30:.2f} GiB, losses "
          f"{trained['losses']}, launches {train_launches}")
    torch.cuda.empty_cache()

    train_prof = train_profile_phase()
    torch.cuda.empty_cache()

    stamp("16")
    with side.running():
        ssm_parity = ssm_parity_phase()
    stamp("17")
    ssm_served = ssm_serve_phase()
    ssm_prof = serve_profile_phase("mamba2-370m", SSM_GEN["mamba2-370m"], 18)
    torch.cuda.empty_cache()

    stamp("19")
    specs = spec_phase()
    stamp("20")
    overlap = overlap_phase(reddit, argv_ooc)

    ooc = {"losses": ooc_losses, "launches": ooc_launches,
           "steps_per_s": ooc_stats.steps_per_s}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-faults-") as sdir:
        save_graph(reddit, sdir)
        stamp("21")
        fault_run = faults_phase(argv_ooc, sdir, ooc)
        dio = direct_io_phase(argv_ooc, sdir, ooc)
    stamp("23")
    resumed = resume_phase(argv, fault_run["chaos"]["losses"])
    stamp("24")
    oracle = oracle_phase(reddit, argv_ooc, synth)
    del synth
    torch.cuda.empty_cache()
    hosted = host_phase(argv, reddit, {"steps_per_s": stats.steps_per_s,
                                       "idle_fraction": stats.idle_fraction},
                        ooc | {"idle_fraction": ooc_stats.idle_fraction})
    stamp("25")
    telemetry = telemetry_phase(reddit, argv_ooc)
    stamp("26")
    isp = isp_phase(reddit, argv, argv_ooc, hosted)
    stamp("27")
    mesh = mesh_phase(argv, argv_ooc, ooc)
    torch.cuda.empty_cache()
    stamp("28")
    moe_run = moe_phase(side)
    torch.cuda.empty_cache()
    stamp("29")
    mm_run = mm_phase(side)
    torch.cuda.empty_cache()
    stamp("30")
    mesh_lm, tp_parts = mesh_lm_phase(argv_lm, trained, served)
    torch.cuda.empty_cache()
    stamp("31")
    tp_run = tp_phase(served, *tp_parts)
    stamp("32")
    fake_kernels = fake_kernel_phase()
    side.release()
    side_wait_s = dryrun_cells_wait(dry_procs[-1:])
    print(f"[smoke] phase 32: the last dry-run cell ended {side_wait_s:.1f} "
          f"s into phase 32, held {side.held_s:.1f} s in all")
    dry = dryrun_phase(trained, dry_procs, dry_dir)
    dry.update(a=fake_kernels, c_wait_s=dry_wait_s,
               c_side_wait_s=side_wait_s, c_side_held_s=side.held_s)
    stamp("33")

    # the JSON line: the GNN kernels per launch and per step; the in-memory
    # kernels at the reddit-sized graph's shapes (its 631 MB table does not
    # fit in L2; the widths are the graph's batch and fanouts either way),
    # their launches from phase 5's run; the cached kernels at the widths
    # phase 8's out-of-core step launches on reddit --large-scale, their
    # launches from phase 8's run
    table = []
    for kname in per_graph["rmat-2^18"]:
        cached = kname.endswith("_cached")
        cases = per_graph["reddit-large" if cached else "rmat-2^18"][kname]
        table.append(gnn_row(kname, cases,
                             (ooc_launches if cached else launches)[kname]))
    # the LM's kernels: per prefill (flash forward, 24 launches at the
    # serve entry point's shape; the SSD kernel, 48 launches at
    # mamba2-370m's), per decode step (decode, 24 launches over the full
    # cache) and per training step (the backward kernels, 24 launches each
    # at the train entry point's shape); launch counts from the serve entry
    # point's run of qwen2-0.5b, the train entry point's for the backward
    # kernels and mamba2-370m's serve run for the SSD kernel (hymba-1.5b's
    # run beside it)
    per = {"flash_attention_fwd": "prefill", "decode_attention":
           "decode step", "flash_attention_bwd_dq": "training step",
           "flash_attention_bwd_dkv": "training step",
           "ssd_chunk_scan": "prefill"}
    launch_runs = {"flash_attention_fwd": lm_launches,
                   "decode_attention": lm_launches,
                   "flash_attention_bwd_dq": train_launches,
                   "flash_attention_bwd_dkv": train_launches,
                   "ssd_chunk_scan": ssm_served["mamba2-370m"]["launches"]}
    for kname, cases in lm_cases.items():
        counts = [c["count"] for c in cases]

        def per_call(key):
            return sum(n * c[key] for n, c in zip(counts, cases))

        main_case = cases[counts.index(max(counts))]
        libs = [c["library_ms"] for c in cases]
        table.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": launch_runs[kname][kname],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": per_call("ms"), "plain_ms": per_call("plain_ms"),
            "bound_ms": per_call("bound_ms"),
            "bound_by": main_case["bound_by"],
            "library_ms": None if None in libs else per_call("library_ms"),
            "shapes": [c["shape"] for c in cases], "per_step": counts,
            "per": per[kname], "on_main_path": True})
        if kname == "ssd_chunk_scan":
            table[-1]["launches_by_run"] = {
                arch: r["launches"][kname] for arch, r in ssm_served.items()}
        else:
            # the MoE family's runs (phase 28): its two serve entry points
            # and moonshot's training-parity step
            table[-1]["launches_by_run"] = {
                **{f"serve {arch} ({r['layers']} layers)":
                   r["launches"][kname]
                   for arch, r in moe_run["serve"].items()},
                f"train parity {MOE_ARCH} (flash)":
                    moe_run["train_parity"]["flash"]["launches"][kname]}
        # phase 29's runs: qwen2-vl's and seamless's serve entry points,
        # the SSM training entry points and the full-width training steps
        table[-1]["launches_by_run"].update({
            **{f"serve {arch} ({r['layers']} layers)": r["launches"][kname]
               for arch, r in mm_run["serve"].items()},
            **{f"train {arch} ({SSM_TRAIN_STEPS} steps)":
               r["launches"][kname]
               for arch, r in mm_run["ssm_train"].items()},
            **{f"train step {arch} ({r['layers']} layers, "
               f"{MM_TRAIN_STEPS} steps)": r["launches"][kname]
               for arch, r in mm_run["train_step"].items()}})
        # phase 31's ranks on the (1, 2) mesh: the train entry point, the
        # tensor-parallel serve and mamba2's split mixer
        tp_runs = {"train --mesh 1x2": tp_run["a"]["launches_per_rank"],
                   "serve (tensor-parallel)": tp_run["b"]["launches"],
                   "mamba2-370m layer (16 of 32 heads)":
                       tp_run["c"]["mamba2-370m"]["launches"]}
        table[-1]["launches_by_run"].update({
            f"phase 31 {what} rank {r}": n[kname]
            for what, ranks_ in tp_runs.items()
            for r, n in enumerate(ranks_)})
    details = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda,
               "build_s": build_s, "ptxas": ptxas, "kernels": table,
               "launch_floor_ms": floor_ms, "per_graph": per_graph,
               "edge_cases": edge_cases,
               "train": {"argv": argv, "losses": losses,
                         "steps_per_s": stats.steps_per_s,
                         "idle_fraction": stats.idle_fraction,
                         "idle_s": stats.idle_s, "busy_s": stats.busy_s,
                         "wall_s": stats.wall_s, "launches": launches},
               "profile": profile,
               "ooc_parity": ooc_parity,
               "ooc_train": {"argv": argv_ooc, "losses": ooc_losses,
                             "steps_per_s": ooc_stats.steps_per_s,
                             "idle_fraction": ooc_stats.idle_fraction,
                             "idle_s": ooc_stats.idle_s,
                             "busy_s": ooc_stats.busy_s,
                             "wall_s": ooc_stats.wall_s,
                             "launches": ooc_launches,
                             "loader": ooc_loader_stats},
               "ooc_stages": ooc_split,
               "lm_kernels": lm_cases, "serve_parity": serve_parity,
               "serve": {"argv": argv_serve, "launches": lm_launches,
                         **{k: served[k] for k in (
                             "prefill_ms", "decode_ms", "decode_ms_per_step",
                             "tok_per_s")},
                         "ids": served["tokens"].tolist()},
               "serve_profile": serve_prof,
               "train_parity": train_parity,
               "lm_train": {"argv": argv_lm, "launches": train_launches,
                            **{k: trained[k] for k in (
                                "losses", "grad_norms", "step_ms", "wall_s",
                                "tok_per_s", "peak_bytes")}},
               "train_profile": train_prof,
               "ssm_parity": ssm_parity, "ssm_serve": ssm_served,
               "ssm_serve_profile": ssm_prof,
               "specs": specs, "overlap": overlap, "faults": fault_run,
               "direct_io": dio, "resume": resumed, "oracle": oracle,
               "host": hosted, "telemetry": telemetry, "isp": isp,
               "mesh": mesh, "moe": moe_run, "multimodal": mm_run,
               "mesh_lm": mesh_lm, "tensor_parallel": tp_run,
               "dryrun": dry,
               "phase_start_s": stamps,
               "seconds": time.perf_counter() - t_all}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(f"[smoke] done in {details['seconds']:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
