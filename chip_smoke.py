#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``distributeddeeplearning_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --quick    # device, build, kernels vs plain only
                                     # (phases 1-3, 6 and 9; no result line)
    python3 chip_smoke.py --fleets   # device, build, phase 4's references
                                     # and phase 43's fleets alone on the
                                     # card (no result line)
    python3 chip_smoke.py --chaos    # device, build, phases 44-45 alone
                                     # on the card (no result line)

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
  2. build: the CUDA sources of the port, compiled from this checkout;
     ptxas's registers and spills, and the tensor-core (HMMA) instruction
     count of each flash and ring kernel's machine code; the bf16 flash
     fwd/dq/dkv and ring_step/ring_dq/ring_dkv kernels must spill nothing
     and hold HMMA, the fp32 kernels of the two libraries must hold none;
     every paged decode instantiation (split and merge kernels, each q
     type, pool type and head dim) must spill nothing;
  3. kernels vs plain: each paged kernel's wrapper against its plain torch
     version at GPT-2 124M decode shapes (five cases), then their times,
     the bound of the same work on the card, and a library yardstick; then
     wide cases per kernel (64 rows, every cursor at 1023, every split
     live; bf16 q, which shows whether the kernel streams at HBM rate, and
     an fp32-q twin held to 2e-5), timed the same way;
  4. serve through the entry point: ``cli serve`` in-process on
     ``configs/gpt2_owt.py`` at 124M width (byte tokenizer), with the fp and
     the int8 KV pool, then with the prefix cache, a host spill tier, int8
     weights and the telemetry bundle (its trace, spans and stats files and
     the record's ``telemetry``), then at fp32 with the prefix cache and
     the int8 pool on a shared 64-byte system prompt (phase 43's
     role-split reference); the launch counts must equal decode calls x
     layers;
  5. serve at full width: the engine on GPT-2 124M (vocab 50257, bf16),
     decode tokens/s and p50 decode-step time with each pool, then an fp32
     pair, kernel against gather, that must agree token for token; then
     the serving features (``serving_features``): 8 requests on one
     256-token prompt with distinct suffixes, one admission a step, with
     the cache on and off and each pool (hit rate, prefill tokens saved,
     decode tokens/s and p50 step); the fp32 pair with the cache on,
     kernel and gather each equal to the cache-off run; the host spill
     tier on a pool cut to 40 blocks, two prefixes alternating, 'fp' and
     'int8' codecs, tokens equal to spill off (spill and promote bytes
     and transfers); ``ngram:4`` on the gather path, tokens equal to
     speculation off (acceptance, tokens a verify step); a prefill-role
     engine handing off to a decode-role engine, tokens equal to the
     unified run; int8 weights, resident bytes against fp32's and tokens
     equal to an fp engine on the dequantized weights; then
     ``serving.replicas=2`` behind the router on the fp32 weights:
     ``least_loaded`` over the shared-prefix trace, and ``prefix_affinity``
     with the cache on over two prompt families (each family kept on its
     replica), tokens equal to one engine's, each replica's launches equal
     to its decode calls x layers; every run's paged kernel launches equal
     its decode calls x layers;
  6. training kernels vs plain: flash fwd / dq / dkv and fused AdamW against
     their plain torch versions at GPT-2 124M training shapes (bf16 causal
     [384, 1024, 64]), the bf16 kernels' other mask paths (per-row limits,
     a pad limit at D = 128, causal L = 1000) and fp32 cases, then their
     times, bounds and library yardsticks;
  7. train through the entry point: ``cli train`` in-process on
     ``configs/gpt2_owt.py`` at full width (batch 32 x 1024, bf16, flash,
     adamw_fused) for 6 steps; launches must be 12 x steps per flash kernel
     and 2 x steps for fused_adamw, every loss finite;
  8. fp32 parity pair at 124M width: (flash, adamw_fused) through the
     kernels against (xla, adamw) through none, 4 steps on the same weights
     and batches; the losses must agree within 1e-4 relative and fall;
  9. ring kernels vs plain: ring_step / ring_dq / ring_dkv against their
     plain torch versions at the cp=2 training shapes ([384, 512, 64], bf16
     k/v, fp32 carries), mode 0 and 1, plus D=128 and L=200 cases in bf16
     and fp32, and four virtual cp ranks driven in lockstep against full
     causal attention, in fp32 and in bf16; every output's max abs error
     and share of its tolerance (bf16: ring_step and ring_dq 2e-3, which
     their two-term bf16 products hold, ring_dkv 2e-2); then the times,
     bounds and library yardsticks;
  10. context-parallel training through the entry point: ``cli train``
     on 2 spawned ranks (``spawn_ranks``, run as ``torchrun`` would run
     it, in a process group of its own; the same pair then runs the jobs
     of phases 11-13), ``mesh.cp=2``, ``ring_pallas``, at full width (the
     batch cut for time to 4 x 1024) for 2 steps. Both ranks share the one
     card over gloo, so
     the step times are no context-parallel speed. Launches must be 12 x
     steps per ring kernel on rank 0 and 24 x steps on rank 1, none of the
     flash kernels, 2 x steps of fused_adamw on each;
  11. fp32 parity at 124M width: 2 ranks at cp=2 (ring_pallas,
     adamw_fused) against phase 8's single-process flash route, 2 steps
     (phase 8's first two); the losses must agree within 1e-4 relative and
     fall; the same two processes then run phase 13's straight run;
  12. ZeRO-1 training through the entry point: ``cli train`` on phase
     10's 2 ranks on ``configs/gpt2_owt.py`` as shipped
     (``zero1=True``, ``dp=-1`` -> 2, flash, adamw_fused, bf16, batch 32 x
     1024) with ``grad_accum=2``, evaluation and checkpoints every 2 steps
     and the metrics writer, 2 steps: per rank, flash_dq and flash_dkv
     launch 12 x steps x grad_accum times, flash_fwd that many plus 12 x
     evaluations x eval_batches, fused_adamw 2 x steps; each rank's moments
     are half the unsharded bytes (plus padding); metrics.jsonl holds the
     train and eval lines; a checkpoint exists at step 2, from which
     phase 13's fresh pair resumes to step 4 (exact launches). Both ranks
     share the one card over gloo, so the step times are no data-parallel
     speed;
  13. fp32 parity at 124M width: 2 ranks at dp=2 with ZeRO-1 and
     grad_accum=2 (flash, adamw_fused) against phase 8's single-process
     flash route, 4 steps: losses within 1e-4 relative and falling, params
     within ZERO_PARAM_LIMIT (clip and weight decay on); that run (in phase
     11's processes) saves at step 2, and fresh processes (phase 16's
     pair, whose last jobs they are; phase 13's checks follow phase
     16's) resume from the save for steps 3 and 4, equal to the
     straight run bit for bit; the same fresh pair then runs gpt2_owt as
     shipped with ZeRO-1 off for 2 steps (its moments the whole 8 bytes a
     parameter a rank), for its memory beside phase 12's, and resumes
     phase 12's run from its step-2 save to step 4.
  14. ResNet-50 training through the entry point: ``cli train`` in-process
     on ``configs/resnet50_imagenet.py`` as shipped (batch 256 x 224², bf16
     convs, SGD, label smoothing) for 4 steps, then 4 with the C++ loader
     (``data.kind=native_image``): images/s over steps 2..N, p50 step,
     peak memory, every loss finite; the path launches none of the nine
     hand kernels (its convs are cuDNN's, as the JAX package's are XLA's);
  15. ``cli benchmark`` on that config at 4 timed and 4 synced steps
     with the multi-step probe at K = 2 (``--steps 4 --latency-steps 4
     --probe 2``, as in phases 18, 22 and 26): the images/sec/chip record
     (p50, p90, MFU against the card's bf16 peak, peak memory, dispatch
     overhead a step), printed again on a line before the last;
  16. ResNet-50 at dp=2, ``cli train`` on 2 spawned ranks sharing the one
     card over gloo: the shipped config with eval and checkpoints every 2
     steps for 4 steps; then the same pair runs fp32 (TF32 off) at a
     global batch of 16, grad_accum 1 and 2, 4 steps against one process on
     the same batches (losses within 1e-4 relative and falling, BatchNorm
     running statistics within ``BN_STATS_TOL``), and a resume from the
     step-2 save that repeats steps 3 and 4 bit for bit; then phase 13's
     jobs. The step times are no data-parallel speed.
  17. ViT-L/16 training through the entry point: ``cli train`` on
     ``configs/vit_imagenet21k.py`` as shipped (batch 64 x 224², 21843
     classes, bf16, flash over 197 tokens padded to 256, adamw_fused,
     every block checkpointed) for 4 steps: per step flash_fwd launches 2
     x 24 times (the forward and the recompute), flash_dq and flash_dkv 24,
     fused_adamw once per group; every loss finite; images/s over steps
     2..N, p50 step, peak memory; then 2 steps with ``train.remat=none``;
  18. ``cli benchmark`` on the ViT-L/16 and BERT-base configs as shipped
     (the depth of phase 15), each record printed, with the flash kernels'
     FLOPs a step from the shapes (``FlopCounterMode`` counts the
     recompute's products but not the kernels' launches) and their share;
  19. BERT-base MLM training through the entry point: ``cli train`` on
     ``configs/bert_mlm.py`` as shipped (64 x 128, 4 microbatches, bf16,
     flash, chunked head, adamw_fused) for 4 steps: per step each flash
     kernel launches 12 x 4 times, fused_adamw once per group; every loss
     finite, masked_fraction 0.15 within 0.01; then 2 steps with
     ``data.pad_min_len=32`` (the attention mask as per-row key limits);
  20. fp32 parity at full width, batch 4, 2 steps on one batch: ViT-L/16
     (flash, adamw_fused, remat full) against (xla, adamw, remat none)
     within 1e-4 relative and against the flash route without remat
     within 1e-6 (bit-equality printed); BERT-base with padded rows and
     grad_accum 2, flash against xla within 1e-4; every loss falls.
  21. Llama-300M training through the entry point: ``cli train`` on
     ``configs/llama_lm.py`` as shipped (16 x 2048, bf16, flash over K and
     V repeated from 8 to 16 heads, chunked head over the untied 32000-word
     ``lm_head``, adamw_fused, zero1 at dp = 1) for 4 steps: each flash
     kernel launches 12 times a step, fused_adamw once a group; every loss
     finite; tokens/s over steps 2..N, p50 step, peak memory;
  22. ``cli benchmark`` (as in phase 18) on that config, its record
     printed before the last line with the flash kernels' FLOPs a step
     (causal pairs);
  23. fp32 parity at full width, batch 2 x 2048, 3 steps on one batch:
     Llama-300M (flash, adamw_fused) against (xla, adamw) within 1e-4
     relative, every loss falling;
  24. Llama-300M serving at full width (vocab 32000, bf16, 8 slots, the
     paged kernels at num_rep = 2) with the fp and the int8 pool, the fp32
     pair kernel against gather token for token, the fp32 pair with the
     prefix cache on over the 8 KV-head pools (phase 5's shared-prefix
     trace), then ``cli serve`` on the config with the byte tokenizer
     (launches = decode calls x 12).
  25. llama_moe 8x300m training through the entry point: ``cli train`` on
     ``configs/llama_moe.py`` as shipped (16 x 2048, bf16, every MLP top-2
     of 8 SwiGLU experts at capacity 640, flash as Llama-300M's, the plain
     AdamW as the reference ships it) for 4 steps: each flash kernel
     launches 12 times a step, fused_adamw never; every loss, aux_loss and
     moe_dropped_frac finite; tokens/s over steps 2..N, p50, peak memory;
  26. ``cli benchmark`` (as in phase 18) on that config: the record
     printed before the last line, with the flash kernels' FLOPs a step
     and the dense one-hot dispatch and combine einsums' FLOPs, which the
     MFU counts;
  27. gpt2_moe training through the entry point: ``configs/gpt2_moe.py``
     as shipped (32 x 1024, 6 routed blocks of 12) for 4 steps, the same
     checks (each flash kernel 12 a step: every block has attention);
  28. fp32 parity at full width: llama_moe, batch 2 x 2048, 2 steps on one
     batch at the shipped capacity factor, (flash, adamw) against (xla,
     adamw) in lockstep (each step from the flash route's state, since one
     routing flip parts the trajectories): per step the losses and
     aux_loss within 1e-4 relative, moe_dropped_frac within one assignment
     a layer, drops present, the loss falling;
  29. token files: a byte corpus of the repository's own text written by
     the port's ``prepare_data``, then ``cli train`` on
     ``configs/gpt2_owt_file.py`` at full width for 4 steps straight, and
     2 steps with a checkpoint and a resume to 4 whose losses equal the
     straight run's bit for bit; launch counts exact (flash 12 a step,
     fused_adamw 2).
  30. bf16_full: ``cli train`` on ``configs/gpt2_owt.py`` with
     ``train.precision.policy=bf16_full`` and ``optim.name=adamw`` (bf16
     moments with stochastic rounding, ``train.LowPrecisionAdamW``) for 4
     steps: flash 12 a step each, fused_adamw none; the optimizer state
     exactly 2 x 2 bytes a parameter, half fp32 AdamW's; p50, peak memory;
  31. health guard: ``cli train`` on gpt2_owt as shipped for 6 steps with
     the guard off, then on with ``train.fault_injection=nan:3``: the step
     of pre-step counter 3 (logged as step 4) reports skipped 1 and
     anomalies 1 and launches no fused_adamw (the guard decides on the
     host before the update); p50 on and off; on the Trainer, the state
     after that step equals the state before it bit for bit (fp32
     params, moments, the optimizer's count); then ``cli train`` with
     ``max_consecutive_anomalies=1``, a checkpoint every 2 steps and
     ``nan:2``: one ``rollback_restart`` from step 2, the run ending at
     step 4, launches exact;
  32. generation: ``cli train`` on ``configs/gpt2_owt_file.py`` at full
     width with the byte vocabulary on phase 29's corpus for 4 steps and
     a save, then ``cli generate --bench --reps 20`` from that checkpoint
     with two uneven prompts and 32 new tokens: its record (decode and
     prefill tokens/s, decode seconds, medians of 20 timed runs) printed
     before the last line;
  33. generation parity, fp32: greedy tokens of ``generate`` on an uneven
     batch equal each row's no-cache full-forward oracle exactly on GPT-2
     124M, Llama-300M and llama_moe 8x300m (one-token prefill, capacity
     factor raised so the oracle's routing drops nothing), and for GPT-2
     and Llama the serving engine's on the same weights and prompts, its
     decode steps through ``paged_decode`` (launches counted).
  34. one spawn of four ranks sharing the one card over gloo
     (``spawn_ranks``) runs every multi-rank job of phases 34-41 in turn,
     the ``cli train`` ones as ``torchrun`` would (each in a process group
     of its own). Phase 34's: pipeline parallelism through the entry
     point, ``cli train`` on ``configs/gpt2_pp.py`` as shipped (pp=4, dp=1
     so ZeRO-1 is a no-op, 1f1b_interleaved over 8 microbatches, bf16, the
     batch cut to 8 x 1024, vocab 50304) for 2 steps with an evaluation
     and a checkpoint
     at step 2: every loss finite and equal on the 4 ranks, each rank 14 =
     M + 2(S-1) ticks a step and 11 in the evaluation; per rank its peak
     memory and its transport seconds and megabytes a step. A path, not a
     speed;
  35. the ranks' pipelined jobs: ``configs/bert_pp.py`` as shipped (1f1b,
     64 x 512, padded rows from 64 tokens, bf16) for 2 steps; fp32 gpt2_pp
     at 8 x 1024 (TF32 off, ``adamw_fused`` over each rank's leaves:
     launches = steps x its kernel groups) to step 2 with a save, then on
     to step 4 from it; fp32 bert_pp at 8 x 512 for 3 steps. This process
     runs their pp=1 twins with the plain AdamW: losses within 1e-4
     relative and falling; it restores the gpt2_pp step-2 checkpoint at
     pp=1, whose params equal every rank's step-2 params bit for bit
     (sha256 of each leaf's bytes).
  36. tensor parallelism with Megatron sequence parallelism and FSDP
     through the entry point: the ranks' ``cli train`` on
     ``configs/gpt2_owt.py`` at dp=1 x fsdp=2 x tp=2 with
     ``train.sequence_parallel=true`` (bf16, flash, adamw_fused; the batch
     cut for time to 4 x 1024) for 2 steps, an evaluation and a checkpoint
     at step 2 (in the one-rank layout): every loss finite and equal on the
     4 ranks; per rank each flash kernel 12 x steps launches (flash_fwd 12
     more for the evaluation) at [2 rows x 6 heads, 1024, 64], fused_adamw
     2 x steps over the rank's blocks; its param, gradient and moment bytes
     against the whole 124M's, the tp and fsdp sharded fractions (each
     above 0.5), peak memory and the transport's seconds a step. A path,
     not a speed;
  37. the ranks' tp jobs: fp32 GPT-2 124M at tp2 x fsdp2 with sequence
     parallelism on phase 8's batches (4 x 1024, 2 rows and 6 heads a
     rank), to step 2 with a save, then on to 4 from it: losses within
     1e-4 relative of phase 8's one process and falling, the whole params
     after 4 steps within ``ZERO_PARAM_LIMIT``, flash at [12, 1024, 64];
     this process restores the step-2 save and cuts it to each rank's
     blocks, equal to that rank's step-2 params bit for bit (sha256);
     Llama-300M at dp2 x tp2 with ZeRO-1: bf16 as shipped (the batch cut
     for time to 2 x 2048) for 2 steps, each flash kernel 12 a step at [1
     row x 8 heads, 2048, 64], fused_adamw 2 a step over the rank's
     shards; the fp32 pair at 2 x 2048 for 2 steps within 1e-4 relative
     of phase 23's one-process kernel route and falling.
  38. the ranks' expert-parallel jobs (``ep_parity``): gpt2_moe as shipped
     (bf16, flash, top-2 of 8 at capacity factor 1.25, ZeRO-1) at dp2 x
     ep2, the batch cut for time to 4 x 1024, for 2 steps, an evaluation
     and a save: the losses equal on the ranks, drops present, each flash
     kernel 12 a step (flash_fwd 12 more for the evaluation) at [24, 1024,
     64]; per rank its param, gradient and moment bytes against the whole
     model's (a share of ~0.65, the moments half that again), aux_loss,
     moe_dropped_frac, peak memory and transport seconds a step; the save,
     restored here at ep=1 and cut to each rank's blocks, equal to every
     rank's params (sha256). llama_moe 8x300m as shipped at ep2 x tp2 with
     sequence parallelism at 2 x 2048 for 2 steps: flash at [16, 2048,
     64], a rank ~0.28 of the params. fp32 gpt2_moe (2 x 1024, one batch,
     adamw_fused, drops present at the shipped capacity) at dp2 x ep2 and
     at ep2 x cp2 on ``ring_pallas``, 2 steps each, against one process
     here: losses and aux_loss within 1e-4 relative, moe_dropped_frac
     within one assignment a layer, the losses falling, the ring kernels
     on the cp ranks (12 x steps x (cp index + 1)).
  39. the ranks' jobs of tensor and fully sharded parallelism for the rest
     of the zoo (``shard_parity``): ``configs/gpt2_pp.py`` as shipped at
     pp2 x tp2 (2 stages of 6 layers, 6 heads a rank, bf16, 8 x 1024) for
     2 steps with an evaluation and a save: losses equal on the ranks, 10
     ticks a step (20 over the 2 steps) and 9 in the evaluation, no hand
     kernel, every rank cut over tp, per rank its param and moment bytes
     against the whole model's (the table cut over tp then pp, JAX's
     ``vocab_pp``) and its transport seconds; fp32
     gpt2_pp at pp2 x tp2 on phase 35's batches within 1e-4 relative of a
     pp=1 twin here, its step-2 save restored here at pp=1 and cut to each
     rank's rows and blocks equal to that rank's params (sha256);
     ``configs/vit_imagenet21k.py`` (remat full, flash, adamw_fused) and
     ``configs/bert_mlm.py`` (4 microbatches, ragged rows) as shipped at
     tp2 x fsdp2 with sequence parallelism, 8 rows, 2 steps: flash at [4
     x 8 heads, 256, 64] limit 197 (48 flash_fwd a step with the
     recompute) and [1 x 6 heads, 128, 64] with per-row limits, fused_adamw
     2 a step over the rank's blocks; ``configs/resnet50_imagenet.py`` as
     shipped (SGD, bf16, 32 x 224²) at fsdp2 x tp2; fp32
     ViT-L and BERT at tp2 x fsdp2 within 1e-4 relative of phase 20's one
     process, and each rank's AdamW moments after step 2 (the clipped raw
     gradients, which ViT's zero head hides from its step-1 loss and
     AdamW's update from the rest) against phase 20's cut to the rank's
     blocks within ``LEAF_STATS_TOL`` leaf by leaf; ResNet-50 at dp2 x
     fsdp2 within 1e-4 of phase 16's one process, its BatchNorm running
     statistics within ``BN_STATS_TOL``.
  40. the ranks' jobs of context parallelism on a rank's heads
     (``heads_cp_parity``): ``configs/gpt2_owt.py`` as shipped (bf16,
     adamw_fused) on ``ulysses_flash`` at dp1 x tp2 x cp2, 4 x 1024, 2
     steps, an evaluation and a save: the flash kernels on every rank at [4
     rows x 3 heads, 1024, 64] (the whole sequence over the rank's heads
     after the all-to-alls), 12 a step (flash_fwd 12 more in the
     evaluation), the save restored here in one process and cut to each
     rank's blocks equal to its params (sha256); the same config on
     ``ring_pallas`` at tp2 x cp2 with sequence parallelism: the ring
     kernels on 6 heads a rank over the 512-token blocks, 12 x steps x (cp
     index + 1), no flash launch; Llama-300M as shipped on
     ``ulysses_flash`` at tp2 x cp2, 2 x 2048, 2 steps: flash at [2 x 4
     heads, 2048, 64]; fp32 GPT-2 on phase 8's batch at tp2 x cp2 on
     ``ulysses_flash`` and at fsdp2 x cp2 on ``ring_pallas``, 2 steps each,
     within 1e-4 relative of phase 8's one process and falling. Each job's
     all-to-all seconds beside its step seconds (a path, not a speed).
  41. the ranks' jobs of the compositions (``composition_parity``):
     ViT-L/16 at 240² (226 tokens, 113 a cp rank) in fp32 at dp2 x cp2 on
     ``ring_pallas`` and at tp2 x cp2 on ``ulysses_flash`` (4 images, 2
     steps) against one process here: losses within 1e-4 relative, every
     rank's AdamW moments within ``LEAF_STATS_TOL`` of the one process's
     cut to its blocks, the non-causal ring kernels at 113-row blocks or
     the flash kernels at [4 x 4 heads, 256, 64] (limit 226) on every
     rank; the same as shipped (bf16, remat full) at dp2 x cp2 on
     ``ring_pallas``, 4 images, 2 steps; fp32 GPT-2 with dropout 0.1 on
     phase 8's batch at tp2 x cp2 on ``ulysses`` and at dp2 x fsdp2 on xla
     with remat 'dots', against one process from the same seed (losses
     1e-4, moments leaf by leaf); GPT-2 124M under ``bf16_full`` at tp2 x
     fsdp2 (4 x 1024, 2 steps) against one process (losses
     ``BF16_FULL_COMP_TOL``, bf16 moments); and phase 34's gpt2_pp run:
     each rank holds a quarter of the tied table's rows and of their
     moments (JAX's ``vocab_pp`` at pp alone), its bytes before and after.
  42. the explicit data-parallel sync (``dp_sync_parity``, then
     ``dp_sync_launch``): phase 34's ranks run fp32 GPT-2 on phase 8's 4 x
     1024 (adamw, no weight decay or clip: the sharded update's fences)
     under the hierarchical sharded update (dp=4 in 2 slices), the flat
     bucketed sync and int8 over the hierarchy, 2 steps, against one
     process here (1e-4 relative; int8 ``INT8_LOSS_BAND``); then ``cli
     launch --num-processes 4`` on ``configs/gpt2_owt.py`` as shipped at
     dp=4, dcn_dp=2, int8 in 25 MiB buckets, 4 x 1024, 2 steps: losses
     finite and equal on every rank, every residual non-zero, exact
     launches a rank, and the sync's wire bytes by bucket and by phase.
  43. the serving fleet, three ``cli serve --fleet 2`` runs in
     subprocesses started in a thread when phase 34's group starts (the
     card is mostly idle under the group's host-staged gloo) and checked
     after phase 42 (``check_fleets``): the fp pool on phase 4's prompts;
     the role split (``serving.prefill_replicas=1``, the prefix cache, the
     int8 pool, fp32, one block a KV frame), whose decode worker's
     ``paged_decode_q8`` reads blocks adopted from socket frames; and
     ``serving.fault_injection=worker_crash:4`` on worker 0, restarted
     once by the fleet supervisor. Each: exit code 0 and every worker's 0,
     tokens equal to its phase-4 in-process engine's, every worker's paged
     launches equal to its decode calls x layers (its ``worker_launches``
     line), no request failed or delivered twice; the seconds, tokens/s,
     p50 TTFT and end-to-end, workers' ready seconds and the restart's
     recovery seconds.
  44. supervised training: ``tools/torch_chaos_run.py``'s runs of ``cli
     supervise`` on ``configs/gpt2_owt.py`` at 124M width (bf16, flash,
     adamw_fused, the health guard on, 8 steps, a save every 2, the batch
     cut to 8 x 1024, a 60 s hang timeout), started in three lanes of
     threads when phase 34's group starts (subprocesses at ``nice 10``)
     and checked here: ``nan:5`` skips one step in place (no restart, 8
     finite losses); ``hang:7`` is killed (``supervisor_hang_kill``) and
     restarted; ``corrupt:6`` (with ``--telemetry``) restores from the
     save before the truncated one, restarts and disarms the fault, its
     goodput file one record an attempt plus the backoff, a
     ``fault_corrupt`` flight record and the ``goodput_summary`` printed;
     a SIGTERM to the supervisor after step 3's record saves at the step
     it stops at (exit 21, ``preempt_save``, ``preempted_exit``) and a
     relaunch resumes there; every other run exits 0 at step 8. An
     undisturbed run of the same overrides in this process launches each
     flash kernel 12 x 8 times and fused_adamw 2 x 8; the hang, corrupt
     and preempt recoveries' step-8 params and moments equal its bit for
     bit (each a child in a process of its own). Then ``cli train`` with
     ``train.debug_nans`` and ``nan:2`` raises FloatingPointError at step
     2, and one ``paged_decode`` step under ``debug.bounds_checks`` with
     a table entry at num_blocks leaves that row NaN, the others equal to
     the step without it, and the card error-free. Each fault's recovery
     seconds, the preempt save's and a restart's cold start are printed;
  45. serving chaos: ``tools/torch_serve_chaos.py`` (a subprocess whose
     workers run at ``nice 10``, started with phase 44) on GPT-2 124M's
     width (vocab 256, max_len 160, the paged kernel): ``worker_crash``,
     ``worker_hang``, ``conn_drop``, ``heartbeat_stall`` and the
     exhaustion run over 2 workers, every pin of the reference held
     (exactly once, tokens equal to the undisturbed oracle's, the
     restarted worker re-warmed from its spill checkpoint and hit the
     host tier, recovery within the bound) and each worker's launches
     equal to its decode calls x layers; each kind's ``recovery_s``.
Phase 3 also holds the paged kernels at Llama-300M's decode shape (16 q
heads over 8 KV heads: bf16 and int8 pools with bf16 q at 2e-2, an fp32
twin at 2e-5), and phase 6 the flash kernels at its training shape, bf16
causal [256, 2048, 64], each timed beside its bound and the library.
Phase 6 also holds fused AdamW over one ZeRO-1 rank's shard of the 124M
groups (dp=2, rank 1, starting inside the flat buffers) bit for bit, and
the flash kernels at the encoders' shapes, non-causal, each timed beside
its bound and SDPA: ViT-L/16's [1024, 256, 64] at limit 197 in bf16 and
fp32, BERT-base's [768, 128, 64] whole and ragged, and a BERT
microbatch's [192, 128, 64] ragged; each error's share of its tolerance
is printed.
Each phase's banner gives the seconds since the start. Before the last
line come the kernels record, the card's name and power limit, the five
benchmark records, phase 32's generate record, phase 5's serving
features record, phase 43's fleet record and phases 44-45's chaos
record; the last line is
``{"ok": true, "device": {...}}``. No GPU means no result line and a
non-zero exit: nothing here falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                      "gpt2_owt.py")
SOURCES = {
    "paged_decode": "distributeddeeplearning_tpu_torch/csrc/paged_attention.cu",
    "paged_decode_q8":
        "distributeddeeplearning_tpu_torch/csrc/paged_attention.cu",
    "flash_fwd": "distributeddeeplearning_tpu_torch/csrc/flash_attention.cu",
    "flash_dq": "distributeddeeplearning_tpu_torch/csrc/flash_attention.cu",
    "flash_dkv": "distributeddeeplearning_tpu_torch/csrc/flash_attention.cu",
    "fused_adamw": "distributeddeeplearning_tpu_torch/csrc/fused_adamw.cu",
    "ring_step": "distributeddeeplearning_tpu_torch/csrc/ring_attention.cu",
    "ring_dq": "distributeddeeplearning_tpu_torch/csrc/ring_attention.cu",
    "ring_dkv": "distributeddeeplearning_tpu_torch/csrc/ring_attention.cu",
}
# gpt2_owt.py trains with flash attention; serving refuses it by name, so
# every serving phase runs the config's xla attention core.
OVERRIDES = ["model.kwargs.attn_impl=xla"]
REPLACES = {
    "paged_decode": "distributeddeeplearning_tpu/ops/paged_attention.py:71",
    "paged_decode_q8": "distributeddeeplearning_tpu/ops/paged_attention.py:118",
    "flash_fwd": "distributeddeeplearning_tpu/ops/flash_attention.py:69",
    "flash_dq": "distributeddeeplearning_tpu/ops/flash_attention.py:213",
    "flash_dkv": "distributeddeeplearning_tpu/ops/flash_attention.py:254",
    "fused_adamw": "distributeddeeplearning_tpu/ops/fused_adamw.py:59",
    "ring_step": "distributeddeeplearning_tpu/ops/ring_attention_pallas.py:56",
    "ring_dq": "distributeddeeplearning_tpu/ops/ring_attention_pallas.py:234",
    "ring_dkv": "distributeddeeplearning_tpu/ops/ring_attention_pallas.py:261",
}
TRAIN_STEPS = 6
# Instantiations in csrc/paged_attention.cu: the split kernel for 2 q types
# x 3 pool types x 3 head dims, the merge for 2 q types.
PAGED_SPLIT_KERNELS, PAGED_MERGE_KERNELS = 18, 2
# Symbol fragments of the bf16 instantiations on the tensor cores, per
# library (two head dims each, so six instantiations a library).
TC_KERNELS = {"flash_attention": ("flash_fwd_kernel_tc", "flash_dq_kernel_tc",
                                  "flash_dkv_kernel_tc"),
              "ring_attention": ("ring_step_kernel_tc", "ring_dq_kernel_tc",
                                 "ring_dkv_kernel_tc")}
CP_STEPS = 2
# Phase 10's batch, cut for time from the config's 32: over gloo on one
# card its step is ~98% transport, which scales with the rows.
CP_BATCH = 4


_T0 = time.perf_counter()


def phase(name):
    """A phase's banner, with the seconds since the script started."""
    print(f"== {name}  [t={time.perf_counter() - _T0:.1f} s]", flush=True)


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def ptxas_stats(log):
    """{kernel symbol: (registers, spill bytes stored and loaded)} from
    nvcc's ``-Xptxas -v`` output, which names each kernel and then gives
    its spills and its registers."""
    stats = {}
    for entry in re.finditer(r"Compiling entry function '([^']+)'", log):
        tail = log[entry.end():]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", tail)
        used = re.search(r"Used (\d+) registers", tail)
        stats[entry[1]] = (int(used[1]), int(spill[1]) + int(spill[2]))
    return stats


def check_tensor_core_build(_build):
    """The bf16 tensor-core instantiations of the flash and ring libraries:
    ptxas must report no spills for them, and their machine code must hold
    tensor-core (HMMA) instructions (``cuobjdump -sass`` of the built
    library); every other kernel of the two (the fp32 instantiations) runs
    on the CUDA cores and must hold none."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for lib_name, frags in TC_KERNELS.items():
        log = _build.BUILD_LOGS[lib_name]
        if log:  # "" when the library came from an earlier build
            tc = {sym: regs_spills
                  for sym, regs_spills in ptxas_stats(log).items()
                  if any(k in sym for k in frags)}
            print(f"  ptxas (registers, spill bytes) of the bf16 "
                  f"{lib_name} tensor-core kernels: {json.dumps(tc)}")
            if (len(tc) != 2 * len(frags)
                    or any(spill for _, spill in tc.values())):
                raise AssertionError(f"bf16 {lib_name} kernels spill: {tc}")
        lib = _build.build([lib_name])[lib_name]
        sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        hmma, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[-1].strip()
                hmma[fn] = 0
            elif fn is not None and "HMMA" in line:
                hmma[fn] += 1
        for fn, n in sorted(hmma.items()):
            print(f"  sass {lib_name} {fn}: {n} HMMA")
        tc = {fn: n for fn, n in hmma.items() if any(k in fn for k in frags)}
        if len(tc) != 2 * len(frags) or not all(tc.values()):
            raise AssertionError(f"bf16 {lib_name} kernels without HMMA: {tc}")
        other = {fn: n for fn, n in hmma.items() if fn not in tc and n}
        if other:
            raise AssertionError(f"CUDA-core {lib_name} kernels hold HMMA: "
                                 f"{other}")


def check_paged_build(_build):
    """Every instantiation of the paged decode library (the split kernel
    for each q type, pool type and head dim, the merge for each q type):
    ptxas must report no spills. Prints each one's registers."""
    log = _build.BUILD_LOGS["paged_attention"]
    if not log:  # "" when the library came from an earlier build
        return
    stats = {sym: regs_spills for sym, regs_spills in ptxas_stats(log).items()
             if "paged_" in sym}
    for sym, (regs, spill) in sorted(stats.items()):
        print(f"  ptxas paged_attention {sym}: {regs} registers, {spill} "
              "spill bytes")
    want = PAGED_SPLIT_KERNELS + PAGED_MERGE_KERNELS
    if len(stats) != want or any(spill for _, spill in stats.values()):
        raise AssertionError(f"paged decode kernels: {len(stats)} of {want} "
                             f"reported, or spilling: {stats}")


# ---------------------------------------------------------------------------
# 3. kernels vs plain
# ---------------------------------------------------------------------------


def decode_case(torch, *, pool, q_dtype, num_rep, seed=0, wide=False,
                heads=12):
    """GPT-2 124M decode shapes: B=8, H=12, D=64, bs=16, 64 pages per row,
    mixed cursors up to 1023, two idle rows on the null block, scattered
    block ids. ``pool`` is the pool's type, ``q_dtype`` the query's.
    ``wide``: 64 rows, every cursor at 1023 (a pool of 4,097 blocks).
    ``heads``: the query heads (Llama-300M: 16 over 8 KV heads)."""
    B, H, D, bs, pages = (64 if wide else 8), heads, 64, 16, 64
    kvh = H // num_rep
    lens = [1023] * B if wide else [0, 37, 255, 256, 511, 700, 0, 1023]
    nb = 1 + B * pages
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(B, H, D, generator=g, device=dev).to(q_dtype)
    shape = (nb, bs, kvh, D)
    sk = sv = None
    if pool == torch.int8:
        pk = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        pv = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        sk = torch.rand(shape[:3], generator=g, device=dev) / 127
        sv = torch.rand(shape[:3], generator=g, device=dev) / 127
    else:
        pk = torch.randn(shape, generator=g, device=dev).to(pool)
        pv = torch.randn(shape, generator=g, device=dev).to(pool)
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    table = torch.zeros(B, pages, dtype=torch.int32, device=dev)
    used = 0
    for b, n in enumerate(lens):
        if n:
            need = n // bs + 1
            table[b, :need] = perm[used:used + need].to(torch.int32)
            used += need
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return dict(q=q, pool_k=pk, pool_v=pv, page_table=table,
                seq_lens=seq_lens, scale_k=sk, scale_v=sv, num_rep=num_rep)


def bound(case):
    """Least time of the work on the card: the bytes this call must move
    (the visible pool columns and their scales, q, the output, the touched
    table entries and the cursors, each once) over HBM, and its flops (QK
    and PV, 4 per visible element per head) over the fp32 peak."""
    lens = case["seq_lens"].tolist()
    B, H, D = case["q"].shape
    _, bs, kvh, _ = case["pool_k"].shape
    cols = sum(n + 1 for n in lens)
    nbytes = cols * kvh * D * 2 * case["pool_k"].element_size()
    if case["scale_k"] is not None:
        nbytes += cols * kvh * 2 * 4
    nbytes += 2 * case["q"].numel() * case["q"].element_size()
    nbytes += sum(n // bs + 1 for n in lens) * 4 + B * 4
    flops = cols * H * D * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, iters=30):
    """Mean device time of ``fn`` per call, L2 flushed before each call
    (in decode, the 12 layers' pools do not fit the 50 MB L2 together).
    The card spins for ~0.5 ms after each flush, so that the host has
    enqueued the call before the start event: a call of a few microseconds
    is timed on the device, not at the host's enqueue rate."""
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(1_000_000)  # clock cycles
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def library_call(torch, case):
    """Yardstick only (the port never calls it): gather the pages, then
    ``scaled_dot_product_attention`` under the cursor mask."""
    F = torch.nn.functional
    q, tbl = case["q"], case["page_table"].long()
    B, H, D = q.shape
    _, bs, kvh, _ = case["pool_k"].shape
    rep = case["num_rep"]

    def gathered(pool, scale):
        x = pool[tbl].reshape(B, -1, kvh, D)
        if scale is not None:
            x = x.to(q.dtype) * scale[tbl].reshape(B, -1, kvh, 1).to(q.dtype)
        x = x.transpose(1, 2)
        return x.repeat_interleave(rep, dim=1) if rep > 1 else x

    def fn():
        k = gathered(case["pool_k"], case["scale_k"])
        v = gathered(case["pool_v"], case["scale_v"])
        cols = torch.arange(k.shape[2], device=q.device)
        mask = (cols[None, :] <= case["seq_lens"].long()[:, None])[:, None, None]
        return F.scaled_dot_product_attention(q[:, :, None], k, v,
                                              attn_mask=mask)[:, :, 0]
    return fn


def check_kernels(torch, pa):
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    cases = {
        # name: (pool type, q type, num_rep, atol, kernel, wide). bf16 and
        # int8_bf16q are the serving path's cases (bf16 compute); the fp32
        # cases hold the same kernels to a tight tolerance. The wide cases
        # read 64 rows x 1024 columns (~0.06 ms of HBM bytes in bf16), with
        # every split live: their outputs are ~0.01-0.05, so the bf16 ones
        # are held to 2e-3 (a few bf16 roundings of the largest output),
        # and an fp32-q twin of each holds the merge of all eight splits
        # to 2e-5.
        "bf16": (bf16, bf16, 1, 2e-2, "paged_decode", False),
        "fp32": (f32, f32, 1, 2e-5, "paged_decode", False),
        "gqa4_fp32": (f32, f32, 4, 2e-5, "paged_decode", False),
        "int8_bf16q": (i8, bf16, 1, 2e-2, "paged_decode_q8", False),
        "int8_fp32q": (i8, f32, 1, 2e-5, "paged_decode_q8", False),
        "bf16_wide": (bf16, bf16, 1, 2e-3, "paged_decode", True),
        "fp32_wide": (f32, f32, 1, 2e-5, "paged_decode", True),
        "int8_bf16q_wide": (i8, bf16, 1, 2e-3, "paged_decode_q8", True),
        "int8_fp32q_wide": (i8, f32, 1, 2e-5, "paged_decode_q8", True),
        # Llama-300M's serving path: 16 q heads over 8 KV heads (num_rep
        # 2) at the decode shape, in bf16 and over the int8 pool, and an
        # fp32 twin held to 2e-5.
        "llama_gqa_bf16": (bf16, bf16, 2, 2e-2, "paged_decode", False),
        "llama_gqa_int8_bf16q": (i8, bf16, 2, 2e-2, "paged_decode_q8",
                                 False),
        "llama_gqa_fp32": (f32, f32, 2, 2e-5, "paged_decode", False),
    }
    results = {}
    for name, (pool, qdt, rep, atol, kernel, wide) in cases.items():
        case = decode_case(torch, pool=pool, q_dtype=qdt, num_rep=rep,
                           wide=wide,
                           heads=16 if name.startswith("llama") else 12)
        args = {k: v for k, v in case.items() if k != "num_rep"}
        before = pa.LAUNCHES[kernel]
        out = pa.paged_attention(**args, num_rep=rep)
        torch.cuda.synchronize()
        if pa.LAUNCHES[kernel] != before + 1:
            raise RuntimeError(f"{name}: wrapper did not launch {kernel}")
        ref = pa.paged_attention_plain(**args, num_rep=rep)
        err = (out.float() - ref.float()).abs().max().item()
        if not (err <= atol and torch.isfinite(out).all()):
            raise AssertionError(
                f"kernel {kernel} ({name}) disagrees with its plain version: "
                f"max_abs_err {err} > atol {atol}"
            )
        lib = library_call(torch, case)
        lib_err = (lib().float() - ref.float()).abs().max().item()
        res = {
            "kernel": kernel, "max_abs_err": err, "atol": atol,
            "ms": time_ms(torch, lambda: pa.paged_attention(**args,
                                                            num_rep=rep)),
            "plain_ms": time_ms(torch, lambda: pa.paged_attention_plain(
                **args, num_rep=rep)),
            "library_ms": time_ms(torch, lib),
            "library_max_abs_err": lib_err,
        }
        res["bound_ms"], res["bound_by"] = bound(case)
        results[name] = res
        print(f"{name}: {json.dumps(res)}", flush=True)
    return results


# ---------------------------------------------------------------------------
# 4. / 5. serving
# ---------------------------------------------------------------------------


SERVE_PROMPTS = ["The H100 decodes", "paged attention reads the pool in place",
                 "hello", "continuous batching over four lanes",
                 "GPT-2 124M"]
# The role-split fleet's prompts: a shared 64-byte system prompt (4 blocks
# of 16) and distinct questions, so each handoff ships several blocks.
SPLIT_PROMPTS = [
    "You are a terse assistant on an H100. Answer in one short line. " + q
    for q in ("What is paged attention?", "Why split prefill and decode?",
              "hi", "Name a KV cache codec.", "How big is GPT-2 124M?")]
# Phase 4's role-split reference and fleet: fp32 weights (the roles'
# suffix prefill and a unified engine's cold prefill agree token for token
# at fp32, as phase 5 holds), the prefix cache, the int8 pool.
SPLIT_OVERRIDES = ("model.kwargs.dtype=float32", "serving.prefix_cache=true")


def serve_argv(kv_quant, config=CONFIG, extra=(), prompts=SERVE_PROMPTS):
    """``cli serve``'s argv on ``config`` with the byte tokenizer, the
    paged kernels and ``kv_quant`` (and ``extra`` overrides)."""
    argv = ["serve", "--config", config, "--device", "cuda"]
    for o in OVERRIDES + ["model.kwargs.vocab_size=256",
                          "serving.attn_kernel=pallas",
                          f"serving.kv_quant={kv_quant}", *extra]:
        argv += ["--override", o]
    for p in prompts:
        argv += ["--prompt", p]
    return argv + ["--max-new-tokens", "24"]


def cli_serve(cli, kv_quant, config=CONFIG, extra=(), prompts=SERVE_PROMPTS):
    """``cli serve`` in-process (:func:`serve_argv`): its record."""
    argv = serve_argv(kv_quant, config, extra, prompts)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli serve exited {rc}")
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    res = rec["results"]
    if len(res) != len(prompts) or any(r["new_tokens"] != 24 for r in res):
        raise AssertionError(f"cli serve ({kv_quant}): incomplete {res}")
    rec["tokens"] = [r["generated"] for r in res]
    print(f"cli serve {os.path.basename(config)} kv_quant={kv_quant} "
          f"{' '.join(extra)}: {json.dumps([r['completion'] for r in res])} "
          f"decode calls {rec['stats']['calls']['decode']}", flush=True)
    return rec


def cli_serve_features(cli, tmp):
    """``cli serve`` with the prefix cache, the host spill tier, int8
    weights and the telemetry bundle: the bundle's files in ``tmp`` and
    the record's ``telemetry``. Returns the decode calls."""
    rec = cli_serve(cli, "off", extra=(
        "serving.prefix_cache=true", "serving.spill_blocks=64",
        "serving.quant=int8", "telemetry.enabled=true",
        f"telemetry.dir={tmp}"))
    files = sorted(os.listdir(tmp))
    programs = sorted(rec["telemetry"]["executables"])
    if (rec["telemetry_dir"] != tmp or "serving_decode" not in programs
            or not {"trace_p0_a0.json", "stats_p0_a0.json",
                    "spans_p0_a0.jsonl"} <= set(files)):
        raise AssertionError(f"cli serve telemetry: {programs} {files}")
    with open(os.path.join(tmp, "stats_p0_a0.json")) as f:
        hists = sorted(json.load(f)["histograms"])
    print(f"cli serve telemetry: programs {programs}, files {files}, "
          f"histograms {hists}; quant {json.dumps(rec['stats']['quant'])}",
          flush=True)
    return rec["stats"]["calls"]["decode"]


def make_engine_cls(ServingEngine):
    class GapEngine(ServingEngine):
        """Records each sampled token's top-2 logit gap per request, so a
        greedy mismatch can say how close the call was."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.gaps, self._admitting = {}, None

        def _admit_one(self, state):
            self._admitting = state
            try:
                super()._admit_one(state)
            finally:
                self._admitting = None

        def _sample_body(self, logits, *a):
            top2 = logits.topk(2, dim=-1).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            owners = ([self._admitting] if self._admitting is not None
                      else self.scheduler.slots)
            for st, gap in zip(owners, gaps):
                if st is not None:
                    self.gaps.setdefault(st.request.request_id, []).append(gap)
            return super()._sample_body(logits, *a)

    return GapEngine


def serve_full_width(torch, pa, cli, ServingEngine, ServingConfig, Request,
                     load_config, apply_overrides, config=CONFIG,
                     prefix=False):
    """The engine on ``config``'s model at full width (GPT-2 124M, vocab
    50257, or Llama-300M, vocab 32000; bf16): 16 requests over 8 lanes with
    the fp and the int8 pool, then an fp32 pair, kernel against gather
    (``prefix``: then :func:`prefix_pair`, the pair with the cache on).
    Returns the stats of each bf16 run."""
    import numpy as np

    from distributeddeeplearning_tpu_torch import models

    cfg = apply_overrides(load_config(config), OVERRIDES)
    model = cli.build_model(cfg, "cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 501, 16)
    prompts = [list(map(int, rng.integers(0, model.vocab_size, n)))
               for n in lens]
    Engine = make_engine_cls(ServingEngine)

    def serve(model, **kw):
        scfg = ServingConfig(slots=8, block_size=16, max_seq_len=1024,
                             prompt_buckets=(128, 512), hbm_budget_mb=2048,
                             **kw)
        eng = Engine(model, scfg, seed=0, device="cuda")
        eng.warmup()
        before = dict(pa.LAUNCHES)
        for p in prompts:
            eng.submit(Request(prompt=p, max_new_tokens=64))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = sum(pa.LAUNCHES.values()) - sum(before.values())
        want = (eng.calls["decode"] * model.num_layers
                if kw.get("attn_kernel") == "pallas" else 0)
        if launched != want:
            raise AssertionError(
                f"full width {kw}: {launched} kernel launches, expected "
                f"{want} (decode calls x layers)"
            )
        decode_tokens = sum(len(s.generated) - 1 for s in done)
        if len(done) != len(prompts) or any(
                len(s.generated) != 64 for s in done):
            raise AssertionError(f"full width {kw}: incomplete requests")
        stats = {
            **{k: v for k, v in kw.items()},
            "dtype": str(model.dtype).replace("torch.", ""),
            "requests": len(done),
            "decode_calls": eng.calls["decode"],
            "decode_tokens_per_s": decode_tokens / sum(eng.decode_step_s),
            "p50_decode_step_ms": statistics.median(eng.decode_step_s) * 1e3,
            "wall_s": wall,
            "num_blocks": eng.num_blocks,
        }
        print(f"full width {cfg.model.name}: {json.dumps(stats)}",
              flush=True)
        return done, eng, stats

    out = {q: serve(model, attn_kernel="pallas", kv_quant=q)[2]
           for q in ("off", "int8")}
    model32 = models.get_model(cfg.model.name, **{
        **cfg.model.kwargs, "dtype": "float32"}).to("cuda")
    model32.load_state_dict(model.state_dict())
    del model
    a_done, a_eng, _ = serve(model32, attn_kernel="pallas")
    b_done, b_eng, _ = serve(model32, attn_kernel="reference")
    for a, b in zip(a_done, b_done):
        if a.generated != b.generated:
            rid = a.request.request_id
            t = next(i for i, (x, y) in enumerate(zip(a.generated,
                                                       b.generated)) if x != y)
            print(f"fp32 mismatch: request {rid} token {t}: kernel "
                  f"{a.generated[t]} vs gather {b.generated[t]}; top-2 "
                  f"logit gap {a_eng.gaps[rid][t]} (kernel) "
                  f"{b_eng.gaps[rid][t]} (gather)", flush=True)
            raise AssertionError("fp32 greedy tokens differ, kernel vs gather")
    print(f"fp32 kernel vs gather ({cfg.model.name}): {len(a_done)} requests "
          "x 64 greedy tokens identical", flush=True)
    if prefix:
        prefix_pair(torch, pa, Engine, ServingConfig, Request, model32,
                    cfg.model.name)
    return out


# ---------------------------------------------------------------------------
# 5. (and 24.) the serving features at full width
# ---------------------------------------------------------------------------

# Phase 5's shared-prefix trace: 8 requests on one 256-token prompt (16
# blocks of 16) with distinct suffixes, one of them a single token (the
# full-prefix hit's decode route); one admission a step, so each later
# request finds the prefix its predecessor published.
PREFIX_LEN, PREFIX_SUFFIXES, PREFIX_NEW = 256, (5, 1, 9, 17, 24, 33, 48, 60), 32
FEATURE_SERVING = dict(slots=8, block_size=16, max_seq_len=1024,
                       prompt_buckets=(128, 512), hbm_budget_mb=2048,
                       max_prefills_per_step=1)
PREFIX_ON = dict(prefix_cache=True, suffix_buckets=(16, 64))


def prefix_trace(vocab, seed=0, prefix=None):
    import numpy as np

    rng = np.random.default_rng(seed)
    if prefix is None:
        prefix = list(map(int, rng.integers(0, vocab, PREFIX_LEN)))
    return [prefix + list(map(int, rng.integers(0, vocab, n)))
            for n in PREFIX_SUFFIXES]


def feature_run(torch, pa, Engine, ServingConfig, Request, model, trace, *,
                new=PREFIX_NEW, waves=None, constrain=0, prefill_to=None,
                **kw):
    """One engine run of ``trace`` (or of ``waves``, each drained before
    the next) with ``kw`` over :data:`FEATURE_SERVING`. The paged kernels'
    launches must equal decode calls x layers on the 'pallas' path (none
    on 'reference'). ``prefill_to``: a prefill-role engine's handoffs are
    adopted by this engine before each request is submitted here. Returns
    (tokens by request, engine, launches)."""
    scfg = ServingConfig(**{**FEATURE_SERVING, **kw})
    eng = Engine(model, scfg, seed=0, device="cuda")
    eng.warmup()
    if constrain:
        eng.constrain_pool(constrain)
    before = sum(pa.LAUNCHES.values())
    got = {}
    for wave in (waves or [trace]):
        if prefill_to is not None:
            for i, p in enumerate(wave):
                prefill_to.submit(Request(prompt=list(p), max_new_tokens=new,
                                          request_id=len(got) + i))
            assert prefill_to.run() == []
            for h in prefill_to.take_handoffs():
                eng.adopt_chain(h["request"].prompt, h["payloads"])
                eng.submit(Request(prompt=list(h["request"].prompt),
                                   max_new_tokens=new,
                                   request_id=h["request"].request_id))
        else:
            for i, p in enumerate(wave):
                eng.submit(Request(prompt=list(p), max_new_tokens=new,
                                   request_id=len(got) + i))
        for st in eng.run():
            got[st.request.request_id] = list(st.generated)
        eng.scheduler.finished.clear()
    torch.cuda.synchronize()
    launched = sum(pa.LAUNCHES.values()) - before
    want = (eng.calls["decode"] * model.num_layers
            if scfg.attn_kernel == "pallas" else 0)
    if launched != want:
        raise AssertionError(f"serving features {kw}: {launched} kernel "
                             f"launches, expected {want} (decode calls x "
                             "layers)")
    if any(len(t) != new for t in got.values()):
        raise AssertionError(f"serving features {kw}: incomplete requests")
    return got, eng, launched


def same_tokens(name, a, b, gaps=None):
    """``a`` == ``b`` request by request, or an AssertionError naming the
    first differing token (and its top-2 logit gaps, where recorded)."""
    for rid in sorted(b):
        if a[rid] != b[rid]:
            t = next(i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                     if x != y)
            gap = "" if gaps is None else (
                f"; top-2 logit gaps {[g.get(rid, [None] * (t + 1))[t] for g in gaps]}")
            raise AssertionError(f"{name}: request {rid} token {t}: "
                                 f"{a[rid][t]} vs {b[rid][t]}{gap}")


def prefix_pair(torch, pa, Engine, ServingConfig, Request, model32, name):
    """The fp32 pair with the cache on (phases 5 and 24): the shared-prefix
    trace, kernel and gather with the cache on, each token for token the
    kernel's run with the cache off."""
    trace = prefix_trace(model32.vocab_size)
    off, off_eng, _ = feature_run(torch, pa, Engine, ServingConfig, Request,
                                  model32, trace, attn_kernel="pallas")
    for kernel in ("pallas", "reference"):
        on, eng, _ = feature_run(torch, pa, Engine, ServingConfig, Request,
                                 model32, trace, attn_kernel=kernel,
                                 **PREFIX_ON)
        pc = eng.stats()["prefix_cache"]
        if not pc["hit_tokens"] or not pc["decode_route_admits"]:
            raise AssertionError(f"{name} fp32 {kernel}: no prefix hits {pc}")
        same_tokens(f"{name} fp32 cache on ({kernel}) vs off", on, off,
                    (eng.gaps, off_eng.gaps))
    print(f"fp32 prefix cache ({name}): kernel and gather with the cache on "
          f"equal the cache-off run, {len(off)} requests x {PREFIX_NEW} "
          f"tokens; hit rate {pc['hit_rate']}", flush=True)
    return off


def serving_features(torch, pa, cli, ServingEngine, ServingConfig, Request,
                     load_config, apply_overrides):
    """Phase 5's feature runs on GPT-2 124M: the shared-prefix trace with
    the cache on and off (bf16, fp and int8 pools), the fp32 pair with
    the cache on, the host spill tier on a cut pool ('fp' and 'int8'
    codecs), ``ngram:4``, a prefill-role engine handing off to a
    decode-role engine, and int8 weights. Returns the printed record."""
    import numpy as np

    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.serving.quant import (
        dequantize_params,
        resident_param_bytes,
    )

    cfg = apply_overrides(load_config(CONFIG), OVERRIDES)
    Engine = make_engine_cls(ServingEngine)
    model = cli.build_model(cfg, "cuda")
    trace = prefix_trace(model.vocab_size)
    rec = {}
    for q in ("off", "int8"):
        runs = {}
        for cache in (False, True):
            got, eng, launched = feature_run(
                torch, pa, Engine, ServingConfig, Request, model, trace,
                attn_kernel="pallas", kv_quant=q,
                **(PREFIX_ON if cache else {}))
            st = eng.stats()
            runs[cache] = {
                "decode_calls": eng.calls["decode"], "launches": launched,
                "decode_tokens_per_s": sum(len(t) - 1 for t in got.values())
                / sum(eng.decode_step_s),
                "p50_decode_step_ms": statistics.median(eng.decode_step_s)
                * 1e3,
                "prefill_calls": eng.calls["prefill"],
            }
            if cache:
                pc = st["prefix_cache"]
                runs[cache].update(hit_rate=pc["hit_rate"],
                                   prefill_tokens_saved=pc["hit_tokens"],
                                   decode_route_admits=pc[
                                       "decode_route_admits"])
        rec[f"prefix_kv_{q}"] = {"cache_off": runs[False],
                                 "cache_on": runs[True]}
        print(f"shared prefix, kv_quant={q}: {json.dumps(rec[f'prefix_kv_{q}'])}",
              flush=True)
    model32 = models.get_model(cfg.model.name, **{
        **cfg.model.kwargs, "dtype": "float32"}).to("cuda")
    model32.load_state_dict(model.state_dict())
    fp_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    del model
    off = prefix_pair(torch, pa, Engine, ServingConfig, Request, model32,
                      "GPT-2 124M")

    # The host tier: prefixes A and B alternate on a pool cut below their
    # working set, so B's admissions spill A's blocks and A's next wave
    # promotes them back.
    rng = np.random.default_rng(1)
    other = list(map(int, rng.integers(0, model32.vocab_size, PREFIX_LEN)))
    a, b = trace[:2], prefix_trace(model32.vocab_size, 2, other)[:2]
    waves = [a, b, [p + [7] for p in a]]
    spill = dict(attn_kernel="pallas", slots=2, **PREFIX_ON)
    base, base_eng, _ = feature_run(torch, pa, Engine, ServingConfig,
                                    Request, model32, None, waves=waves,
                                    constrain=40, **spill)
    for codec in ("fp", "int8"):
        got, eng, _ = feature_run(torch, pa, Engine, ServingConfig, Request,
                                  model32, None, waves=waves, constrain=40,
                                  spill_blocks=64, spill_codec=codec, **spill)
        pc = eng.stats()["prefix_cache"]
        if not pc["spills"] or not pc["promotes"]:
            raise AssertionError(f"spill {codec}: nothing spilled or "
                                 f"promoted {pc}")
        same_tokens(f"spill {codec} vs spill off", got, base,
                    (eng.gaps, base_eng.gaps))
        rec[f"spill_{codec}"] = {k: pc[k] for k in (
            "spills", "promotes", "spill_bytes", "promote_bytes",
            "spill_transfers", "promote_transfers", "hit_tokens_host")}
        print(f"spill {codec}: {json.dumps(rec[f'spill_{codec}'])}; tokens "
              "equal to spill off", flush=True)

    # ngram:4 on the gather path (the paged kernel is single-token).
    rep = [(trace[i][:32] * 4) for i in range(8)]
    plain, plain_eng, _ = feature_run(torch, pa, Engine, ServingConfig,
                                      Request, model32, rep,
                                      attn_kernel="reference")
    spec, eng, _ = feature_run(torch, pa, Engine, ServingConfig, Request,
                               model32, rep, attn_kernel="reference",
                               speculation="ngram:4")
    same_tokens("ngram:4 vs speculation off", spec, plain,
                (eng.gaps, plain_eng.gaps))
    sp = eng.stats()["speculation"]
    if not eng.calls["verify"]:
        raise AssertionError("ngram:4: no verify step ran")
    rec["ngram_4"] = {"verify_calls": eng.calls["verify"],
                      "decode_calls": eng.calls["decode"],
                      "plain_decode_calls": plain_eng.calls["decode"],
                      "accept_rate": sp["accept_rate"],
                      "tokens_per_verify_step": sp["mean_accepted_per_step"]}
    print(f"ngram:4 (fp32, reference): {json.dumps(rec['ngram_4'])}; tokens "
          "equal to speculation off", flush=True)

    # A prefill-role engine hands every request to a decode-role engine.
    pre = Engine(model32, ServingConfig(**{
        **FEATURE_SERVING, **PREFIX_ON, "role": "prefill",
        "attn_kernel": "pallas"}), seed=0, device="cuda")
    got, dec, _ = feature_run(torch, pa, Engine, ServingConfig, Request,
                              model32, trace, prefill_to=pre, role="decode",
                              attn_kernel="pallas", **PREFIX_ON)
    same_tokens("prefill -> decode roles vs unified", got, off,
                (dec.gaps,))
    rec["roles"] = {"prefill": pre.stats()["handoff"],
                    "decode": dec.stats()["handoff"]}
    print(f"roles: {json.dumps(rec['roles'])}; tokens equal to unified",
          flush=True)

    # serving.replicas=2 behind the router, on the same fp32 weights.
    from distributeddeeplearning_tpu_torch.serving import ReplicaRouter

    rec["replicas"] = replica_runs(torch, pa, ServingEngine, ReplicaRouter,
                                   ServingConfig, Request, model32, off)

    # int8 weights: resident bytes, and tokens equal to an fp engine on the
    # dequantized weights.
    q8 = models.get_model(cfg.model.name, **{
        **cfg.model.kwargs, "dtype": "float32"}).to("cuda")
    q8.load_state_dict(model32.state_dict())
    got, eng, _ = feature_run(torch, pa, Engine, ServingConfig, Request, q8,
                              trace, attn_kernel="pallas", quant="int8")
    model32.load_state_dict(dequantize_params(eng.model))
    ref, ref_eng, _ = feature_run(torch, pa, Engine, ServingConfig, Request,
                                  model32, trace, attn_kernel="pallas")
    same_tokens("quant=int8 vs fp on the dequantized weights", got, ref,
                (eng.gaps, ref_eng.gaps))
    rec["quant_int8"] = {**eng.stats()["quant"],
                         "resident_param_bytes": resident_param_bytes(
                             eng.model),
                         "resident_param_bytes_fp": fp_bytes}
    print(f"quant=int8: {json.dumps(rec['quant_int8'])}; fp32 tokens equal "
          "to the dequantized fp engine's", flush=True)
    return rec


# ---------------------------------------------------------------------------
# 5. and 43. the serving fleet: replicas in-process, worker processes
# ---------------------------------------------------------------------------


def replica_runs(torch, pa, ServingEngine, ReplicaRouter, ServingConfig,
                 Request, model32, off):
    """Phase 5's replica runs (fp32, phase 5's engine setting,
    ``serving.replicas=2``): ``least_loaded`` over the shared-prefix trace,
    tokens equal to the single engine's ``off``; then ``prefix_affinity``
    with the cache on over two prompt families (two requests first, one a
    family, then the rest once their prefixes are published): each family
    on one replica, tokens equal to a single engine's. Each replica's
    paged launches equal its decode calls x layers. Returns the record."""
    import numpy as np

    start = time.perf_counter()
    rng = np.random.default_rng(1)
    other = list(map(int, rng.integers(0, model32.vocab_size, PREFIX_LEN)))
    trace = prefix_trace(model32.vocab_size)
    families = [p for pair in zip(trace[:4], prefix_trace(
        model32.vocab_size, 2, other)[:4]) for p in pair]
    Engine = make_engine_cls(ServingEngine)
    ref, _, _ = feature_run(torch, pa, Engine, ServingConfig, Request,
                            model32, families, attn_kernel="pallas")
    rec = {}
    for policy, prompts, want, extra in (
            ("least_loaded", trace, off, {}),
            ("prefix_affinity", families, ref, PREFIX_ON)):
        router = ReplicaRouter(model32, ServingConfig(**{
            **FEATURE_SERVING, **extra, "replicas": 2,
            "attn_kernel": "pallas", "router_policy": policy}),
            seed=0, device="cuda")
        router.warmup()
        launched = [0, 0]
        for r in router.replicas:  # count each replica's own launches
            def counted(step=r.step, i=r.index):
                before = sum(pa.LAUNCHES.values())
                busy = step()
                launched[i] += sum(pa.LAUNCHES.values()) - before
                return busy
            r.step = counted
        t0 = time.perf_counter()
        first = 2 if policy == "prefix_affinity" else len(prompts)
        for i, p in enumerate(prompts[:first]):
            router.submit(Request(prompt=list(p), max_new_tokens=PREFIX_NEW,
                                  request_id=i))
        if first < len(prompts):
            router.step()  # the first two prefill and publish their chains
            for i, p in enumerate(prompts[first:], start=first):
                router.submit(Request(prompt=list(p),
                                      max_new_tokens=PREFIX_NEW,
                                      request_id=i))
        got = {s.request.request_id: list(s.generated) for s in router.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        same_tokens(f"replicas=2 {policy} vs one engine", got, want)
        calls = [r.engine.calls["decode"] for r in router.replicas]
        want_launches = [c * model32.num_layers for c in calls]
        if launched != want_launches or not all(launched):
            raise AssertionError(
                f"replicas=2 {policy}: launches {launched} != decode calls "
                f"x layers {want_launches}")
        routes = [router.routes[i] for i in range(len(prompts))]
        if policy == "prefix_affinity" and routes != [0, 1] * 4:
            raise AssertionError(f"prefix_affinity routes {routes}: each "
                                 "family should stay on its replica")
        st = router.stats()
        rec[policy] = {"routes": routes, "decode_calls": calls,
                       "launches": launched, "wall_s": wall,
                       "num_compiles": st["num_compiles"],
                       "tokens_per_s": sum(map(len, got.values())) / wall}
        print(f"replicas=2 {policy}: {json.dumps(rec[policy])}; tokens "
              "equal to one engine's", flush=True)
    print(f"fleet check seconds: replica runs "
          f"{time.perf_counter() - start:.1f}", flush=True)
    return rec


# The three worker-process fleets of phase 43 (each ``cli serve --fleet 2``
# in a subprocess, started with phase 34's group and checked after it):
# (name, kv_quant, extra overrides, prompts, the phase-4 record whose
# tokens it must equal, restarts expected).
FLEETS = (
    ("fleet_fp", "off", (), SERVE_PROMPTS, "off", 0),
    ("fleet_split", "int8", SPLIT_OVERRIDES + (
        "serving.prefill_replicas=1", "serving.handoff_blocks_per_frame=1"),
     SPLIT_PROMPTS, "split", 0),
    ("fleet_crash", "off", ("serving.fault_injection=worker_crash:4",),
     SERVE_PROMPTS, "off", 1),
)


def start_fleets(nice=True):
    """Run the three fleets one after another on a thread (each parent a
    subprocess that touches no device; its two workers share the card):
    returns the thread and the dict it fills with (rc, stdout, stderr,
    seconds) by name. With ``nice`` the fleets run at a lower CPU priority,
    so the phase they run beside keeps the host's cores; they have that
    phase's minutes to finish in."""
    import threading

    out = {}

    def run():
        for name, q, extra, prompts, _, _ in FLEETS:
            low = (["nice", "-n", "10"] if nice and shutil.which("nice")
                   else [])
            argv = [*low, sys.executable, "-m",
                    "distributeddeeplearning_tpu_torch.cli",
                    *serve_argv(q, extra=extra, prompts=prompts),
                    "--fleet", "2"]
            t0 = time.perf_counter()
            try:
                p = subprocess.run(argv, cwd=ROOT, capture_output=True,
                                   text=True, timeout=400)
                out[name] = (p.returncode, p.stdout, p.stderr,
                             time.perf_counter() - t0)
            except subprocess.TimeoutExpired as exc:
                out[name] = (124, exc.stdout or "", exc.stderr or "",
                             time.perf_counter() - t0)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def check_fleets(out, refs, layers):
    """Phase 43: each fleet exited 0 with every worker's exit code 0, its
    greedy tokens equal to its phase-4 reference, every worker's paged
    launches equal to its decode calls x layers (the pool's kernel; none
    of the other), the role-split fleet's handoffs in several parts with
    every block its prefill worker exported adopted by its decode worker
    (none fell back to a cold prefill, so ``paged_decode_q8`` read the
    blocks that came over the socket), and the crash fleet's one restart with every request delivered exactly
    once. Returns the record and each kernel's launches in the workers."""
    rec, total = {}, {"paged_decode": 0, "paged_decode_q8": 0}
    for name, q, _, _, ref, restarts in FLEETS:
        if name not in out:
            raise AssertionError(f"{name}: did not run")
        rc, stdout, stderr, secs = out[name]
        lines = stdout.strip().splitlines()
        if rc != 0:
            raise AssertionError(f"{name}: exit {rc}\n" + "\n".join(
                lines[-20:]) + "\n" + stderr[-4000:])
        res = json.loads(lines[-1])
        tokens = [r["generated"] for r in res["results"]]
        if tokens != refs[ref]:
            raise AssertionError(f"{name}: tokens {tokens} != the "
                                 f"in-process engine's {refs[ref]}")
        st, sup = res["stats"], res["supervisor"]
        if (any(res["worker_exit_codes"]) or st["duplicate_deliveries"]
                or st["failed"] or sup["restarts"] != restarts):
            raise AssertionError(
                f"{name}: exit codes {res['worker_exit_codes']}, "
                f"duplicates {st['duplicate_deliveries']}, failed "
                f"{st['failed']}, restarts {sup['restarts']} (want "
                f"{restarts})")
        kernel = "paged_decode_q8" if q == "int8" else "paged_decode"
        workers = []
        for line in lines:
            m = re.match(r"\[w(\d)\] (\{.*\})$", line)
            if m and '"worker_launches"' in line:
                w = json.loads(m.group(2))
                want = {"paged_decode": 0, "paged_decode_q8": 0,
                        kernel: w["calls"]["decode"] * layers}
                if w["launches"] != want:
                    raise AssertionError(f"{name} worker {w['replica']}: "
                                         f"launches {w['launches']} != "
                                         f"{want}")
                for k, v in w["launches"].items():
                    total[k] += v
                workers.append({k: w[k] for k in (
                    "replica", "attempt", "role", "calls", "launches",
                    "handoff")})
        # Every process that exited cleanly reported: one per worker slot,
        # a crashed process's replacement reporting in its place.
        if len(workers) != 2:
            raise AssertionError(f"{name}: {len(workers)} launch reports")
        if sum(w["calls"]["decode"] for w in workers) == 0:
            raise AssertionError(f"{name}: no decode step ran")
        if name == "fleet_split":
            if not st["handoff_parts"] > st["handoffs"] > 0:
                raise AssertionError(f"{name}: handoffs {st['handoffs']} "
                                     f"in {st['handoff_parts']} parts")
            by_role = {w["role"]: w["handoff"] for w in workers}
            sent, got = by_role.get("prefill"), by_role.get("decode")
            if sent is None or got is None:
                raise AssertionError(f"{name}: roles {sorted(by_role)}")
            if (got["adopt_fallbacks"] or not got["adopt_blocks"]
                    or not sent["export_blocks"]
                    or got["adopt_blocks"] + got["adopt_skipped_blocks"]
                    != sent["export_blocks"]):
                raise AssertionError(
                    f"{name}: the decode worker adopted "
                    f"{got['adopt_blocks']} blocks and skipped "
                    f"{got['adopt_skipped_blocks']} of the "
                    f"{sent['export_blocks']} exported, with "
                    f"{got['adopt_fallbacks']} cold-prefill fallbacks")
        if name == "fleet_crash" and not (st["retried"] + st["rerouted"]):
            raise AssertionError(f"{name}: nothing retried or rerouted")
        new = sum(len(t) for t in tokens)
        rec[name] = {
            "seconds": secs, "serve_s": res["serve_s"],
            "tokens_per_s": new / res["serve_s"],
            "p50_ttft_s": statistics.median(
                r["ttft_s"] for r in res["results"]),
            "p50_e2e_s": statistics.median(
                r["e2e_s"] for r in res["results"]),
            "worker_ready_s": res["worker_ready_s"],
            "restart_records": sup["restart_records"],
            "retried": st["retried"], "rerouted": st["rerouted"],
            "handoffs": st["handoffs"], "handoff_parts": st["handoff_parts"],
            "handoff_bytes": sum(w["handoff"]["export_bytes"]
                                 for w in workers),
            "workers": workers,
        }
        print(f"{name}: {json.dumps(rec[name])}; tokens equal to the "
              f"in-process engine's", flush=True)
    return rec, total


# ---------------------------------------------------------------------------
# 6. training kernels vs plain
# ---------------------------------------------------------------------------


def flash_case(torch, *, dtype, bh, L, D, causal, ragged=False, limit=None,
               heads=12, seed=1):
    """Folded [bh, L, D] inputs: q, k, v, dO standard normal; ``ragged``
    gives each batch row (``heads`` folded rows) a kv limit in [1, L];
    ``limit`` is the static true length of a padded sequence (rows and
    columns past it zero, as the wrapper pads)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = [torch.randn(bh, L, D, generator=g, device="cuda") for _ in range(4)]
    limit = L if limit is None else limit
    for x in t:
        x[:, limit:] = 0
    q, k, v, do = (x.to(dtype).contiguous() for x in t)
    vl = None
    if ragged:
        lens = torch.randint(1, L + 1, (bh // heads,), generator=g,
                             device="cuda", dtype=torch.int32)
        lens[0] = L
        vl = lens.repeat_interleave(heads).contiguous()
    return dict(q=q, k=k, v=v, do=do, vl=vl, causal=causal, limit=limit,
                heads=heads, sm_scale=1.0 / D ** 0.5)


def visible_pairs(torch, case):
    """(row, column) pairs of the case's visible tiles' work: what the
    kernels must compute, row by row. Rows past the static limit are
    padding whose outputs are dropped: a padded sequence of ``limit``
    tokens counts limit x limit pairs."""
    bh, L, _ = case["q"].shape
    rows = torch.arange(L, device="cuda")
    lim = torch.full((bh,), min(case["limit"], L), device="cuda")
    if case["vl"] is not None:
        lim = torch.minimum(lim, case["vl"].long())
    per_row = lim[:, None].expand(bh, L)
    if case["causal"]:
        per_row = torch.minimum(per_row, rows[None, :] + 1)
    per_row = per_row * (rows[None, :] < case["limit"])
    return int(per_row.sum().item())


def flash_bounds(torch, case):
    """Least time of each flash kernel's work on the card: its bytes (each
    input read once, each output written once) over HBM, and its matrix
    flops over the visible (row, column) pairs over the tensor-core bf16
    peak for bf16 inputs (the fp32 CUDA-core peak for fp32):
      fwd: S = QK^T and O = PV, 4*D flops per pair; reads q, k, v, writes
           o and lse;
      dq:  S, dP = dO V^T and dQ = dS K, 6*D per pair; reads q, k, v, o,
           dO, lse, writes dq and delta;
      dkv: S, dP, dV = P^T dO and dK = dS^T Q, 8*D per pair; reads q, k, v,
           dO, lse, delta, writes dk and dv."""
    bh, L, D = case["q"].shape
    el = case["q"].element_size()
    mat, row = bh * L * D * el, bh * L * 4
    pairs = visible_pairs(torch, case)
    peak = BF16_FLOPS_PER_S if el == 2 else FP32_FLOPS_PER_S
    work = {"flash_fwd": (4 * mat + row, 4 * D * pairs),
            "flash_dq": (6 * mat + 2 * row, 6 * D * pairs),
            "flash_dkv": (6 * mat + 2 * row, 8 * D * pairs)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (max(t_b, t_o) * 1e3,
                     "bytes" if t_b >= t_o else "operations",
                     nbytes, flops)
    return out


def check_flash(torch, fa, name, case, atol, timed):
    """Each flash kernel against its plain version on the same inputs
    (the backward kernels fed the plain forward's o and lse, and dkv the
    plain dq's delta, so each is held alone)."""
    kw = dict(causal=case["causal"], sm_scale=case["sm_scale"],
              limit=case["limit"], vl=case["vl"])
    q, k, v, do = case["q"], case["k"], case["v"], case["do"]
    L = case["limit"]

    shares = {}

    def err(a, b, what):
        a, b = a[:, :L].float(), b[:, :L].float()
        e = (a - b).abs().max().item()
        share = ((a - b).abs() / (atol + atol * b.abs())).max().item()
        shares[what] = share
        if not share <= 1.0 or not torch.isfinite(a).all():
            raise AssertionError(
                f"flash {name}: {what} disagrees with its plain version: "
                f"max_abs_err {e}, tolerance {atol} + {atol} * |ref|")
        return e

    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, **kw)
    dq, delta = fa.flash_dq(q, k, v, o_ref, do, lse_ref, **kw)
    dq_ref, delta_ref = fa.flash_dq_plain(q, k, v, o_ref, do, lse_ref, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta_ref, **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, do, lse_ref, delta_ref, **kw)
    torch.cuda.synchronize()
    if any(fa.LAUNCHES[x] != before[x] + 1 for x in before):
        raise RuntimeError(f"flash {name}: a wrapper did not launch")
    errs = {
        "flash_fwd": max(err(o, o_ref, "o"),
                         err(lse[..., None], lse_ref[..., None], "lse")),
        "flash_dq": max(err(dq, dq_ref, "dq"),
                        err(delta[..., None], delta_ref[..., None], "delta")),
        "flash_dkv": max(err(dk, dk_ref, "dk"), err(dv, dv_ref, "dv")),
    }
    outputs = {"flash_fwd": ("o", "lse"), "flash_dq": ("dq", "delta"),
               "flash_dkv": ("dk", "dv")}
    res = {k: {"max_abs_err": e, "atol": atol,
               "tolerance_share": max(shares[o] for o in outputs[k])}
           for k, e in errs.items()}
    print(f"flash {name}: max_abs_err {json.dumps(errs)} (tolerance {atol} "
          f"+ {atol} * |ref|; the largest share of it by output "
          f"{json.dumps(shares)})", flush=True)
    if not timed:
        return res
    bounds = flash_bounds(torch, case)
    times = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_plain(q, k, v, **kw)),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, o_ref, do, lse_ref, **kw),
                     lambda: fa.flash_dq_plain(q, k, v, o_ref, do, lse_ref,
                                               **kw)),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse_ref, delta_ref,
                                           **kw),
                      lambda: fa.flash_dkv_plain(q, k, v, do, lse_ref,
                                                 delta_ref, **kw)),
    }
    lib_fwd, lib_bwd = sdpa_yardsticks(torch, case)
    for kname, (kern, plain) in times.items():
        r = res[kname]
        r["ms"] = time_ms(torch, kern, iters=10)
        r["plain_ms"] = time_ms(torch, plain, iters=3)
        r["bound_ms"], r["bound_by"], r["bytes"], r["flops"] = bounds[kname]
        # The library's backward computes dq, dk and dv in one call: it is
        # the yardstick of the dq + dkv pair, recorded on both.
        r["library_ms"] = lib_fwd if kname == "flash_fwd" else lib_bwd
        print(f"  {kname}: {json.dumps(r)}", flush=True)
    return res


def sdpa_yardsticks(torch, case):
    """Yardsticks only (the port never calls them): the library's
    ``scaled_dot_product_attention`` forward, and its autograd backward, on
    the case's tensors viewed [B, H, L, D], causal as the case is; a padded
    case's first ``limit`` tokens only (the library needs no pad), a ragged
    case's key limits as a boolean key mask."""
    F = torch.nn.functional
    bh, _, D = case["q"].shape
    heads, n = case["heads"], case["limit"]
    shape = (bh // heads, heads, n, D)
    q, k, v = (case[x][:, :n].reshape(shape).detach().requires_grad_()
               for x in ("q", "k", "v"))
    do = case["do"][:, :n].reshape(shape)
    kw = {"is_causal": case["causal"]}
    if case["vl"] is not None:
        lens = case["vl"].view(-1, heads)[:, 0].long()
        kw = {"attn_mask": (torch.arange(n, device="cuda")[None, :]
                            < lens[:, None])[:, None, None, :]}
    fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, **kw), iters=10)
    o = F.scaled_dot_product_attention(q, k, v, **kw)
    bwd = time_ms(torch, lambda: torch.autograd.grad(
        o, (q, k, v), do, retain_graph=True), iters=10)
    return fwd, bwd


def adamw_leaves(torch, models, cfg, fused):
    """GPT-2 124M's parameter shapes (the config's model on the meta
    device), split as the optimizer splits them: the kernel groups
    {(dtype, wd): [shapes]}."""
    meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                            device="meta")
    params = dict(meta.named_parameters())
    _, groups = fused.split_leaves(params, cfg.optim.weight_decay)
    return {key: [tuple(params[n].shape) for n in names]
            for key, names in groups.items()}


def adamw_tensors(torch, shapes, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(scale, positive=False):
        out = []
        for shp in shapes:
            x = torch.randn(shp, generator=g, device="cuda") * scale
            out.append(x.abs() if positive else x)
        return out

    return dict(p=draw(0.02), g=draw(1e-3), m=draw(1e-4),
                v=draw(1e-7, positive=True))


def check_adamw(torch, fused, groups, cfg):
    """The kernel over each group against the plain version leaf by leaf,
    at step counts 1 and 1000 and weight decay 0.1 and 0: the design gives
    the plain version's numbers bit for bit, so the tolerance is 0."""
    hp = dict(b1=cfg.optim.b1, b2=cfg.optim.b2, eps=1e-8)
    worst = 0.0
    (decayed, wd), shapes = next(
        (key, shp) for key, shp in groups.items() if key[1])
    for count in (1, 1000):
        c1, c2 = fused.bias_corrections(hp["b1"], hp["b2"], count)
        for wd_case in (wd, 0.0):
            t = adamw_tensors(torch, shapes, seed=count)
            ref = {k: [x.clone() for x in xs] for k, xs in t.items()}
            before = fused.LAUNCHES["fused_adamw"]
            fused.fused_adamw_group(t["p"], t["g"], t["m"], t["v"], lr=6e-4,
                                    wd=wd_case, c1=c1, c2=c2, **hp)
            for leaf in zip(ref["p"], ref["g"], ref["m"], ref["v"]):
                fused.fused_adamw_plain(*leaf, lr=6e-4, wd=wd_case, c1=c1,
                                        c2=c2, **hp)
            torch.cuda.synchronize()
            if fused.LAUNCHES["fused_adamw"] != before + 1:
                raise RuntimeError("fused_adamw: the wrapper did not launch")
            e = max((a - b).abs().max().item()
                    for k in ("p", "m", "v") for a, b in zip(t[k], ref[k]))
            print(f"fused_adamw count={count} wd={wd_case}: max_abs_err {e} "
                  f"over {len(shapes)} leaves", flush=True)
            if e != 0.0 or not all(torch.isfinite(x).all() for x in t["p"]):
                raise AssertionError(
                    f"fused_adamw (count={count}, wd={wd_case}) disagrees "
                    f"with its plain version: max_abs_err {e}")
            worst = max(worst, e)
    return worst


def time_adamw(torch, fused, groups, cfg):
    """One optimizer step's launches at GPT-2 124M (every kernel group),
    the plain version over the same leaves, and the library's fused AdamW
    step over the same tensors. Bound: p, g, m, v read and p, m, v written,
    28 B per element, over HBM."""
    hp = dict(lr=6e-4, b1=cfg.optim.b1, b2=cfg.optim.b2, eps=1e-8)
    c1, c2 = fused.bias_corrections(hp["b1"], hp["b2"], 1000)
    sets = [(wd, adamw_tensors(torch, shapes, seed=7))
            for (_, wd), shapes in groups.items()]

    def kernel():
        for wd, t in sets:
            fused.fused_adamw_group(t["p"], t["g"], t["m"], t["v"], wd=wd,
                                    c1=c1, c2=c2, **hp)

    def plain():
        for wd, t in sets:
            for leaf in zip(t["p"], t["g"], t["m"], t["v"]):
                fused.fused_adamw_plain(*leaf, wd=wd, c1=c1, c2=c2, **hp)

    params = [p for _, t in sets for p in t["p"]]
    for (_, t) in sets:
        for p, g in zip(t["p"], t["g"]):
            p.grad = g
    opt = torch.optim.AdamW(params, lr=hp["lr"], betas=(hp["b1"], hp["b2"]),
                            eps=hp["eps"], weight_decay=0.1, fused=True)
    elems = sum(p.numel() for p in params)
    nbytes = 28 * elems
    res = {
        "ms": time_ms(torch, kernel, iters=20),
        "plain_ms": time_ms(torch, plain, iters=5),
        "library_ms": time_ms(torch, opt.step, iters=20),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": nbytes, "elements": elems, "launches_per_step": len(sets),
    }
    print(f"  fused_adamw step: {json.dumps(res)}", flush=True)
    return res


def check_adamw_shard(torch, models, fused, cfg):
    """One ZeRO-1 rank's update at GPT-2 124M over dp=2: rank 1's shard of
    each group's flat buffer (the decay and no-decay groups, 62.2M
    elements together), starting inside the buffer, one launch a group.
    Bit for bit against the plain version; then timed beside the bound
    (p, g, m, v read and p, m, v written: 28 B an element, over HBM) and
    the library's fused AdamW over the same two shards."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh
    from distributeddeeplearning_tpu_torch.parallel.zero import ZeroLayout

    meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                            device="meta")
    lay = ZeroLayout(dict(meta.named_parameters()), Mesh({"dp": 2}, 1))
    g = torch.Generator(device="cuda").manual_seed(5)

    def draw(n, scale):
        return torch.randn(n, generator=g, device="cuda") * scale

    wds = {"decay": cfg.optim.weight_decay, "no_decay": 0.0}
    shards = {}
    for grp, n in lay.padded.items():
        flat = draw(n, 0.02)
        sl = lay.shard_slice(grp)
        k = sl.stop - sl.start
        shards[grp] = dict(p=flat[sl], g=draw(k, 1e-3), m=draw(k, 1e-4),
                           v=draw(k, 1e-7).abs())
        if sl.start * 4 % 16 or sl.start == 0:
            raise AssertionError(f"shard of {grp} starts at {sl.start}")
    hp = dict(lr=6e-4, b1=cfg.optim.b1, b2=cfg.optim.b2, eps=1e-8)
    c1, c2 = fused.bias_corrections(hp["b1"], hp["b2"], 1000)
    ref = {grp: {k: t[k].clone() for k in "pgmv"}
           for grp, t in shards.items()}
    before = fused.LAUNCHES["fused_adamw"]

    def kernel():
        for grp, t in shards.items():
            fused.fused_adamw_group([t["p"]], [t["g"]], [t["m"]], [t["v"]],
                                    wd=wds[grp], c1=c1, c2=c2, **hp)

    def plain(sets=shards):
        for grp, t in sets.items():
            fused.fused_adamw_plain(t["p"], t["g"], t["m"], t["v"],
                                    wd=wds[grp], c1=c1, c2=c2, **hp)

    kernel()
    plain(ref)
    torch.cuda.synchronize()
    if fused.LAUNCHES["fused_adamw"] != before + len(shards):
        raise RuntimeError("fused_adamw shard: the wrapper did not launch")
    err = max((shards[grp][k] - ref[grp][k]).abs().max().item()
              for grp in shards for k in "pmv")
    if err != 0.0:
        raise AssertionError(f"fused_adamw shard disagrees with its plain "
                             f"version: max_abs_err {err}")
    params = []
    for grp, t in shards.items():
        q = torch.nn.Parameter(t["p"].clone())
        q.grad = t["g"].clone()
        params.append({"params": [q], "weight_decay": wds[grp]})
    opt = torch.optim.AdamW(params, lr=hp["lr"], betas=(hp["b1"], hp["b2"]),
                            eps=hp["eps"], fused=True)
    elems = sum(t["p"].numel() for t in shards.values())
    nbytes = 28 * elems
    res = {"ms": time_ms(torch, kernel, iters=20),
           "plain_ms": time_ms(torch, plain, iters=5),
           "library_ms": time_ms(torch, opt.step, iters=20),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "elements": elems,
           "offsets": {grp: lay.shard_slice(grp).start for grp in shards},
           "launches_per_step": len(shards), "max_abs_err": err}
    print(f"  fused_adamw ZeRO-1 shard (dp=2, rank 1): {json.dumps(res)}",
          flush=True)
    return res


def check_encoder_flash(torch, fa):
    """The flash kernels at the encoders' shapes, non-causal, each timed
    beside its bound and the library's yardstick: ViT-L/16's batch 64 x 16
    heads at 197 tokens padded to 256 (the static limit; the kernels have
    run no other pad at D = 64), in bf16 and fp32; BERT-base's 64 x 12
    heads at 128 tokens, whole and with per-row key limits, and the
    shape one of its 4 microbatches gives the kernels on the main path
    (16 x 12 heads), ragged; a tp2 x fsdp2 rank's shapes of phase 39
    (ViT-L 2 x 8 heads, BERT 2 x 6 heads ragged); and a tp2 x cp2 rank's
    of phase 41 (ViT-L at 226 tokens, 4 x 4 heads)."""
    bf16, f32 = torch.bfloat16, torch.float32
    vit = dict(bh=64 * 16, L=256, D=64, causal=False, limit=197, heads=16)
    bert = dict(bh=64 * 12, L=128, D=64, causal=False, heads=12)
    cases = {
        "vit_bf16": ("bf16 ViT-L [1024, 256, 64] limit 197, non-causal",
                     dict(dtype=bf16, **vit), 2e-2),
        "vit_fp32": ("fp32 ViT-L [1024, 256, 64] limit 197, non-causal",
                     dict(dtype=f32, **vit), 2e-5),
        "bert_bf16": ("bf16 BERT [768, 128, 64], non-causal",
                      dict(dtype=bf16, **bert), 2e-2),
        "bert_bf16_ragged": ("bf16 BERT [768, 128, 64] ragged vl, "
                             "non-causal",
                             dict(dtype=bf16, ragged=True, **bert), 2e-2),
        "bert_micro_bf16_ragged": (
            "bf16 BERT microbatch [192, 128, 64] ragged vl, non-causal",
            dict(dtype=bf16, ragged=True, **{**bert, "bh": 16 * 12}), 2e-2),
        # Phase 39's per-rank shapes at tp2 x fsdp2: 2 images x 8 heads,
        # 2 rows of a microbatch x 6 heads.
        "vit_rank_bf16": ("bf16 ViT-L tp2 x fsdp2 rank [16, 256, 64] limit "
                          "197, non-causal",
                          dict(dtype=bf16, **{**vit, "bh": 2 * 8}), 2e-2),
        "bert_rank_micro_bf16_ragged": (
            "bf16 BERT tp2 x fsdp2 rank microbatch [12, 128, 64] ragged vl, "
            "non-causal",
            dict(dtype=bf16, ragged=True, **{**bert, "bh": 2 * 6}), 2e-2),
        # Phase 41's ViT-L/16 at 240² on ulysses_flash at tp2 x cp2: a
        # rank's 4 images x 4 heads over the whole 226 tokens padded to
        # 256 (fp32 there; bf16 as a shipped run would give them).
        "vit_cp_rank_fp32": ("fp32 ViT-L ulysses_flash tp2 x cp2 rank [16, "
                             "256, 64] limit 226, non-causal",
                             dict(dtype=f32, **{**vit, "bh": 4 * 4,
                                                "limit": 226, "heads": 4}),
                             2e-5),
        "vit_cp_rank_bf16": ("bf16 ViT-L ulysses_flash tp2 x cp2 rank [16, "
                             "256, 64] limit 226, non-causal",
                             dict(dtype=bf16, **{**vit, "bh": 4 * 4,
                                                 "limit": 226, "heads": 4}),
                             2e-2),
    }
    out = {}
    for key, (name, kw, atol) in cases.items():
        out[key] = check_flash(torch, fa, name, flash_case(torch, **kw),
                               atol, timed=True)
    return out


def check_training_kernels(torch, models, cfg):
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused

    bf16, f32 = torch.bfloat16, torch.float32
    # bf16: o, dq, dk, dv are rounded to bf16 (8 bits of mantissa) at the
    # output, so one rounding step apart is ~0.4% of the value, and the
    # tensor-core kernels round P and dS to bf16 inside the P V, dS K,
    # P^T dO and dS^T Q products (about 0.2% per term, averaging out over
    # the sum): 2e-2 absolute plus 2e-2 relative. fp32: only the order of the
    # fp32 sums differs (tiles vs one einsum), ~1e-6 of the magnitudes.
    res = check_flash(torch, fa, "bf16 causal [384, 1024, 64]",
                      flash_case(torch, dtype=bf16, bh=384, L=1024, D=64,
                                 causal=True), 2e-2, timed=True)
    # The bf16 kernels' other mask paths: per-row limits, a static pad
    # limit at D = 128, and a length that is no multiple of either tile.
    check_flash(torch, fa, "bf16 ragged kv_valid_lens, non-causal "
                "[96, 512, 64]",
                flash_case(torch, dtype=bf16, bh=96, L=512, D=64,
                           causal=False, ragged=True), 2e-2, timed=False)
    check_flash(torch, fa, "bf16 L=197 padded to 256, non-causal, D=128",
                flash_case(torch, dtype=bf16, bh=24, L=256, D=128,
                           causal=False, limit=197), 2e-2, timed=False)
    check_flash(torch, fa, "bf16 causal L=1000 [48, 1000, 64]",
                flash_case(torch, dtype=bf16, bh=48, L=1000, D=64,
                           causal=True), 2e-2, timed=False)
    check_flash(torch, fa, "fp32 causal [384, 1024, 64]",
                flash_case(torch, dtype=f32, bh=384, L=1024, D=64,
                           causal=True), 2e-5, timed=False)
    check_flash(torch, fa, "fp32 ragged kv_valid_lens, non-causal "
                "[96, 512, 64]",
                flash_case(torch, dtype=f32, bh=96, L=512, D=64,
                           causal=False, ragged=True), 2e-5, timed=False)
    check_flash(torch, fa, "fp32 L=197 padded to 256, non-causal, D=128",
                flash_case(torch, dtype=f32, bh=24, L=256, D=128,
                           causal=False, limit=197), 2e-5, timed=False)
    res["encoder"] = check_encoder_flash(torch, fa)
    # Llama-300M's training shape: 16 x 16 heads at 2048 tokens, causal
    # (K and V repeated to 16 heads before the kernels). Held on the full
    # shape: the plain versions' [256, 2048, 2048] fp32 scores take 4.3 GB
    # each, ~20 GB at their peak.
    res["llama"] = check_flash(
        torch, fa, "bf16 causal [256, 2048, 64] (Llama-300M)",
        flash_case(torch, dtype=bf16, bh=256, L=2048, D=64, causal=True,
                   heads=16), 2e-2, timed=True)
    # Phase 40's per-rank shapes under ulysses_flash at tp2 x cp2: the
    # whole sequence over a rank's heads (GPT-2 4 rows x 3 heads, Llama-300M
    # 2 rows x 4 heads).
    res["ulysses"] = {
        "gpt2": check_flash(
            torch, fa, "bf16 causal [12, 1024, 64] (GPT-2 ulysses_flash tp2 "
            "x cp2 rank)", flash_case(torch, dtype=bf16, bh=12, L=1024, D=64,
                                      causal=True, heads=3), 2e-2,
            timed=True),
        "llama": check_flash(
            torch, fa, "bf16 causal [8, 2048, 64] (Llama-300M ulysses_flash "
            "tp2 x cp2 rank)", flash_case(torch, dtype=bf16, bh=8, L=2048,
                                          D=64, causal=True, heads=4), 2e-2,
            timed=True)}
    groups = adamw_leaves(torch, models, cfg, fused)
    err = check_adamw(torch, fused, groups, cfg)
    res["fused_adamw"] = {**time_adamw(torch, fused, groups, cfg),
                          "max_abs_err": err}
    res["fused_adamw_shard"] = check_adamw_shard(torch, models, fused, cfg)
    return res


# ---------------------------------------------------------------------------
# 7. / 8. training
# ---------------------------------------------------------------------------


def cli_train(torch, cli, steps):
    argv = ["train", "--config", CONFIG, "--device", "cuda", "--sync-steps",
            "--override", f"train.steps={steps}",
            "--override", "train.log_every=1"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli train exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    losses = [r["loss"] for r in recs if "loss" in r]
    end = next(r for r in recs if r.get("event") == "train_end")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"cli train: losses {losses}")
    step_s = end["step_s"][1:]  # the first step warms the libraries up
    return losses, step_s, [x for x in lines if not x.startswith("{")]


def parity_pair(torch, cli, load_config, apply_overrides, steps=4):
    """fp32 at 124M width: (flash, adamw_fused) against (xla, adamw) from
    the same seed's weights on the same batches."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused
    from distributeddeeplearning_tpu_torch.train import fit

    base = ["model.kwargs.dtype=float32", "data.batch_size=4",
            "data.n_distinct=1", "optim.schedule=constant",
            "optim.warmup_steps=0", "optim.grad_clip=1.0",
            f"train.steps={steps}"]
    routes = {"kernels": ["model.kwargs.attn_impl=flash",
                          "optim.name=adamw_fused"],
              "plain": ["model.kwargs.attn_impl=xla", "optim.name=adamw"]}
    out = {}
    from distributeddeeplearning_tpu_torch import data

    for name, extra in routes.items():
        cfg = apply_overrides(load_config(CONFIG), base + extra)
        model, trainer, dataset = cli.build_all(cfg, "cuda")
        state = trainer.init(cfg.train.seed)
        before = sum(fa.LAUNCHES.values()) + fused.LAUNCHES["fused_adamw"]
        state, hist = fit(trainer, state,
                          data.prefetch(dataset.iter_from(0), "cuda"),
                          steps=steps, log_every=1, log_fn=lambda m: None)
        torch.cuda.synchronize()
        launched = (sum(fa.LAUNCHES.values()) + fused.LAUNCHES["fused_adamw"]
                    - before)
        if (launched > 0) != (name == "kernels"):
            raise AssertionError(f"parity route {name}: {launched} kernel "
                                 "launches")
        out[name] = ([r["loss"] for r in hist],
                     {k: p.detach().clone() for k, p in state.params.items()})
        del model, trainer, state
        torch.cuda.empty_cache()
    (la, pa_), (lb, pb) = out["kernels"], out["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    pdiff = max((pa_[k] - pb[k]).abs().max().item() for k in pa_)
    print(f"fp32 parity: losses kernels {la} plain {lb} max rel diff {rel}; "
          f"max abs param diff after {steps} steps {pdiff} (information)",
          flush=True)
    if not rel <= 1e-4:
        raise AssertionError(f"fp32 parity: loss rel diff {rel} > 1e-4")
    if not (la[-1] < la[0] and lb[-1] < lb[0]):
        raise AssertionError(f"fp32 parity: loss did not fall {la} {lb}")
    return {"losses_kernels": la, "losses_plain": lb, "max_rel_diff": rel,
            "max_abs_param_diff": pdiff, "params_kernels": pa_,
            "overrides": base + routes["kernels"]}


# ---------------------------------------------------------------------------
# 9. ring kernels vs plain
# ---------------------------------------------------------------------------


def ring_case(torch, rp, *, dtype, bh, L, D, seed=11, heads=12):
    """Inputs of one ring visit as rank 1 of cp=2 meets them: its queries
    q, a diagonal block (k1, v1) and the block of rank 0 (k0, v0), dO; the
    carries after the diagonal visit (plain versions), the lse and delta of
    the whole forward, and the dq, dk, dv carried into the mode-0 visit."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k0, v0, k1, v1, do = (
        torch.randn(bh, L, D, generator=g, device="cuda").to(dtype)
        for _ in range(6))
    scale = D ** -0.5
    qf = q.float() * scale
    zero = dict(m=torch.full((bh, L, 1), -1e30, device="cuda"),
                l=torch.zeros(bh, L, 1, device="cuda"),
                acc=torch.zeros(bh, L, D, device="cuda"))
    diag = rp.ring_step_plain(qf, k1, v1, zero["m"], zero["l"], zero["acc"], 1)
    m, l, acc = rp.ring_step_plain(qf, k0, v0, *diag, 0)
    lse = m + torch.log(l)
    out = (acc / l).to(dtype)
    delta = (do.float() * out.float()).sum(-1, keepdim=True)
    zd = torch.zeros(bh, L, D, device="cuda")
    dq1 = rp.ring_dq_plain(q, k1, v1, do, lse, delta, zd, 1, scale)
    dk1, dv1 = rp.ring_dkv_plain(q, k1, v1, do, lse, delta, zd, zd, 1, scale)
    return dict(q=q, qf=qf, blocks={1: (k1, v1), 0: (k0, v0)},
                carries={1: (zero["m"], zero["l"], zero["acc"]), 0: diag},
                grads={1: (zd, zd, zd), 0: (dq1, dk1, dv1)},
                do=do, lse=lse, delta=delta, scale=scale, heads=heads)


def ring_calls(rp, case, mode, plain=False):
    """(name -> zero-argument call) of the three kernels (or their plain
    versions) on the case's mode-``mode`` visit."""
    k, v = case["blocks"][mode]
    dq, dk, dv = case["grads"][mode]
    bwd = (case["q"], k, v, case["do"], case["lse"], case["delta"])
    sfx = "_plain" if plain else ""
    step, rdq, rdkv = (getattr(rp, n + sfx)
                       for n in ("ring_step", "ring_dq", "ring_dkv"))
    return {
        "ring_step": lambda: step(case["qf"], k, v, *case["carries"][mode],
                                  mode),
        "ring_dq": lambda: rdq(*bwd, dq, mode, case["scale"]),
        "ring_dkv": lambda: rdkv(*bwd, dk, dv, mode, case["scale"]),
    }


def ring_bounds(case, mode):
    """Least time of each ring kernel's work: its bytes (each input read
    once, each output written once) over HBM, and its matrix flops over the
    visible (row, column) pairs (mode 0: all L^2, mode 1: L(L+1)/2 per
    row block) over the bf16 tensor-core peak for bf16 k/v (fp32 CUDA-core
    peak for fp32):
      ring_step: S and PV, 4*D flops per pair; reads qf, k, v, m, l, acc
                 (fp32 but k, v), writes m, l, acc;
      ring_dq:   S, dP and dS K, 6*D per pair; reads q, k, v, dO, lse,
                 delta, dq, writes dq (fp32);
      ring_dkv:  S, dP, P^T dO and dS^T Q, 8*D per pair; reads q, k, v, dO,
                 lse, delta, dk, dv, writes dk, dv (fp32)."""
    bh, L, D = case["q"].shape
    el = case["q"].element_size()
    mat_t, mat_f, row = bh * L * D * el, bh * L * D * 4, bh * L * 4
    pairs = bh * L * L if mode == 0 else bh * L * (L + 1) // 2
    peak = BF16_FLOPS_PER_S if el == 2 else FP32_FLOPS_PER_S
    work = {"ring_step": (mat_f + 2 * mat_t + 4 * row + 2 * mat_f,
                          4 * D * pairs),
            "ring_dq": (4 * mat_t + 2 * row + 2 * mat_f, 6 * D * pairs),
            "ring_dkv": (4 * mat_t + 2 * row + 4 * mat_f, 8 * D * pairs)}
    out = {}
    for name, (nbytes, flops) in work.items():
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        out[name] = (max(t_b, t_o) * 1e3,
                     "bytes" if t_b >= t_o else "operations", nbytes, flops)
    return out


RING_OUTPUTS = {"ring_step": ("m", "l", "acc"), "ring_dq": ("dq",),
                "ring_dkv": ("dk", "dv")}


def check_ring(torch, rp, name, case, atol, timed):
    """Each ring kernel against its plain version on the same inputs, in
    mode 1 (the diagonal visit) and mode 0 (a visible block); errors are
    held to atol + atol * |ref|, ``atol`` per kernel. Prints every output's
    max abs error and the largest share of its tolerance used."""
    res, errs = {}, {}
    for mode in (1, 0):
        kern, plain = ring_calls(rp, case, mode), ring_calls(rp, case, mode,
                                                             plain=True)
        for kname in kern:
            tol = atol[kname]
            before = rp.LAUNCHES[kname]
            got = kern[kname]()
            want = plain[kname]()
            torch.cuda.synchronize()
            if rp.LAUNCHES[kname] != before + 1:
                raise RuntimeError(f"ring {name}: {kname} did not launch")
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            e = 0.0
            for out, a, b in zip(RING_OUTPUTS[kname], got, want):
                diff = (a - b).abs()
                e_out = diff.max().item()
                used = (diff / (tol + tol * b.abs())).max().item()
                errs[f"{kname} mode {mode} {out}"] = [e_out, used]
                e = max(e, e_out)
                if used > 1 or not torch.isfinite(a).all():
                    raise AssertionError(
                        f"ring {name}: {kname} mode {mode} {out} disagrees "
                        f"with its plain version: max_abs_err {e_out}, "
                        f"tolerance {tol} + {tol} * |ref|")
            res[(kname, mode)] = {"max_abs_err": e, "atol": tol}
    print(f"ring {name}: [max_abs_err, share of the tolerance used] "
          f"{json.dumps(errs)} (atol {json.dumps(atol)})", flush=True)
    if not timed:
        return res
    out = {}
    lib_fwd, lib_bwd = ring_yardsticks(torch, case)
    for mode in (1, 0):
        bounds = ring_bounds(case, mode)
        kern, plain = ring_calls(rp, case, mode), ring_calls(rp, case, mode,
                                                             plain=True)
        for kname in kern:
            r = dict(res[(kname, mode)])
            r["ms"] = time_ms(torch, kern[kname], iters=10)
            r["plain_ms"] = time_ms(torch, plain[kname], iters=3)
            r["bound_ms"], r["bound_by"], r["bytes"], r["flops"] = (
                bounds[kname])
            # The library's backward computes dq, dk and dv in one call: the
            # yardstick of the dq + dkv pair, recorded on both.
            r["library_ms"] = lib_fwd if kname == "ring_step" else lib_bwd
            print(f"  {kname} mode {mode}: {json.dumps(r)}", flush=True)
            if mode == 0:  # the full visible block: the kernels' record
                out[kname] = r
    return out


def ring_yardsticks(torch, case):
    """Yardsticks only (the port never calls them): the library's
    ``scaled_dot_product_attention`` forward over one visible block (no
    mask) and its autograd backward, on the case's tensors viewed [B, H,
    L, D]."""
    F = torch.nn.functional
    bh, L, D = case["q"].shape
    heads = case["heads"]
    k, v = case["blocks"][0]
    shape = (bh // heads, heads, L, D)
    q, k, v = (x.reshape(shape).detach().requires_grad_()
               for x in (case["q"], k, v))
    do = case["do"].reshape(shape)
    fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v),
                  iters=10)
    o = F.scaled_dot_product_attention(q, k, v)
    bwd = time_ms(torch, lambda: torch.autograd.grad(
        o, (q, k, v), do, retain_graph=True), iters=10)
    return fwd, bwd


def composed_ring(torch, rp, fa, *, dtype, atol, cp=4, bh=48, L=512, D=64):
    """cp virtual ranks in lockstep in one process: the forward ring through
    ``ring_step``, then the backward ring through ``ring_dq``/``ring_dkv``,
    blocks rotating as Python lists (rank i receives from i + 1; dk, dv
    rotate with k, v and hop home at the end), as ``_ring_fwd`` and
    ``_ring_bwd`` drive them (qf = scale q in fp32, the output in q's type
    for delta). Outputs, lse, dq, dk, dv against full causal attention over
    the cp * L sequence through the flash module's plain versions, in fp32
    on the same (``dtype``) input values."""
    g = torch.Generator(device="cuda").manual_seed(21)
    full = [torch.randn(bh, cp * L, D, generator=g, device="cuda")
            .to(dtype).float() for _ in range(4)]
    q, k, v, do = ([x[:, i * L:(i + 1) * L].to(dtype).contiguous()
                    for i in range(cp)] for x in full)
    scale = D ** -0.5

    def rotate(xs):
        return xs[1:] + xs[:1]

    def visits():
        for t in range(cp):
            for i in range(cp):
                src = (i + t) % cp
                if src <= i:
                    yield t, i, int(src == i)

    carries = [(torch.full((bh, L, 1), -1e30, device="cuda"),
                torch.zeros(bh, L, 1, device="cuda"),
                torch.zeros(bh, L, D, device="cuda")) for _ in range(cp)]
    qf = [x.float() * scale for x in q]
    kt, vt = list(k), list(v)
    t_prev = 0
    for t, i, mode in visits():
        while t_prev < t:
            kt, vt, t_prev = rotate(kt), rotate(vt), t_prev + 1
        carries[i] = rp.ring_step(qf[i], kt[i], vt[i], *carries[i], mode)
    out = [acc / l for (_, l, acc) in carries]
    lse = [m + torch.log(l) for (m, l, _) in carries]
    delta = [(d.float() * o.to(dtype).float()).sum(-1, keepdim=True)
             for d, o in zip(do, out)]
    zeros = [torch.zeros(bh, L, D, device="cuda") for _ in range(cp)]
    dq, dk, dv = list(zeros), list(zeros), list(zeros)
    kt, vt = list(k), list(v)
    t_prev = 0
    for t, i, mode in visits():
        while t_prev < t:
            kt, vt, dk, dv = map(rotate, (kt, vt, dk, dv))
            t_prev += 1
        args = (q[i], kt[i], vt[i], do[i], lse[i], delta[i])
        dq[i] = rp.ring_dq(*args, dq[i], mode, scale)
        dk[i], dv[i] = rp.ring_dkv(*args, dk[i], dv[i], mode, scale)
    for _ in range(cp - t_prev):  # the last lap's remaining hops home
        dk, dv = rotate(dk), rotate(dv)
    torch.cuda.synchronize()
    kw = dict(causal=True, sm_scale=scale, limit=cp * L)
    o_ref, lse_ref = fa.flash_fwd_plain(*full[:3], **kw)
    dq_ref, delta_ref = fa.flash_dq_plain(*full[:3], o_ref, full[3], lse_ref,
                                          **kw)
    dk_ref, dv_ref = fa.flash_dkv_plain(*full[:3], full[3], lse_ref,
                                        delta_ref, **kw)
    errs = {}
    for name, got, want in (("out", out, o_ref), ("lse", lse, lse_ref[..., None]),
                            ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        a = torch.cat(got, dim=1)
        e = (a - want).abs().max().item()
        errs[name] = e
        if ((a - want).abs() > atol + atol * want.abs()).any():
            raise AssertionError(f"composed ring (cp={cp}, {dtype}): {name} "
                                 f"disagrees with full causal attention: "
                                 f"max_abs_err {e}, tolerance {atol} + "
                                 f"{atol} * |ref|")
    print(f"composed ring cp={cp} [{bh}, {cp} x {L}, {D}] "
          f"{str(dtype).replace('torch.', '')} vs full causal: "
          f"max_abs_err {json.dumps(errs)} (atol {atol})", flush=True)
    return errs


def check_ring_kernels(torch):
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import ring_attention_pallas as rp

    bf16, f32 = torch.bfloat16, torch.float32
    # Every output is an fp32 carry. fp32: only the order of the fp32 sums
    # differs, 2e-5. The bf16 kernels run on the tensor cores, where the
    # bf16 inputs are exact. ring_dkv rounds P to bf16 inside P^T dO and dS
    # inside dS^T Q, ~0.2% per term as in the flash kernels: 2e-2 absolute
    # plus 2e-2 relative, their tolerance. ring_step takes P (and qf at
    # D = 128) as two bf16 terms and ring_dq takes dS as two, ~2^-16 left
    # of each, so the sums' order dominates again, over the carries'
    # larger magnitudes: 2e-3, the fp32 design's bf16 tolerance.
    bf16_tol = {"ring_step": 2e-3, "ring_dq": 2e-3, "ring_dkv": 2e-2}
    f32_tol = dict.fromkeys(bf16_tol, 2e-5)
    res = check_ring(torch, rp, "bf16 [384, 512, 64] (cp=2 training)",
                     ring_case(torch, rp, dtype=bf16, bh=384, L=512, D=64),
                     bf16_tol, timed=True)
    for dtype, tol in ((bf16, bf16_tol), (f32, f32_tol)):
        tname = str(dtype).replace("torch.", "")
        if dtype == f32:
            check_ring(torch, rp, "float32 [384, 512, 64]",
                       ring_case(torch, rp, dtype=f32, bh=384, L=512, D=64),
                       tol, timed=False)
        check_ring(torch, rp, f"{tname} D=128 [24, 256, 128]",
                   ring_case(torch, rp, dtype=dtype, bh=24, L=256, D=128),
                   tol, timed=False)
        check_ring(torch, rp, f"{tname} L=200, no multiple of 64 "
                   "[24, 200, 64]",
                   ring_case(torch, rp, dtype=dtype, bh=24, L=200, D=64),
                   tol, timed=False)
    # Phase 40's per-rank shape of ring_pallas at tp2 x cp2: 8 rows x 6
    # heads over a 512-token block.
    res["tp_rank"] = check_ring(
        torch, rp, "bf16 [48, 512, 64] (GPT-2 ring_pallas tp2 x cp2 rank)",
        ring_case(torch, rp, dtype=bf16, bh=48, L=512, D=64), bf16_tol,
        timed=True)
    # Phase 41's ViT-L/16 at 240² on ring_pallas at dp2 x cp2: a rank's 2
    # images x 16 heads (bf16 as shipped, and fp32) over a 113-token block,
    # no multiple of the 64-row tile, non-causal (every visit a mode-0
    # one; mode 1 is checked at the shape as well).
    res["vit_cp_rank"] = check_ring(
        torch, rp, "bf16 [32, 113, 64] (ViT-L ring_pallas dp2 x cp2 rank)",
        ring_case(torch, rp, dtype=bf16, bh=32, L=113, D=64, heads=16),
        bf16_tol, timed=True)
    res["vit_cp_rank_fp32"] = check_ring(
        torch, rp, "float32 [32, 113, 64] (ViT-L fp32 dp2 x cp2 rank)",
        ring_case(torch, rp, dtype=f32, bh=32, L=113, D=64, heads=16),
        f32_tol, timed=True)
    composed_ring(torch, rp, fa, dtype=f32, atol=1e-4)
    # bf16: the tensor-core kernels' roundings, folded over every visit of
    # four ranks, against fp32 attention on the same bf16 values.
    composed_ring(torch, rp, fa, dtype=bf16, atol=2e-2)
    return res


# ---------------------------------------------------------------------------
# 10. / 11. context-parallel training
# ---------------------------------------------------------------------------


def cp_cli_job(steps=CP_STEPS):
    """Phase 10's job for the pair of :func:`pair_group`."""
    return cli_job([f"data.batch_size={CP_BATCH}", "mesh.cp=2", "mesh.dp=1",
                    "model.kwargs.attn_impl=ring_pallas",
                    f"train.steps={steps}", "train.log_every=1"])


def cli_train_cp(torch, layers, ranks, steps=CP_STEPS):
    """Phase 10: ``cli train`` on 2 ranks (the job of :func:`cp_cli_job`),
    cp=2, ring_pallas, full width. Returns (the losses, the train_end
    record, each rank's launches)."""
    lines, recs, end = cli_result(ranks)
    losses = [r["loss"] for r in recs if "loss" in r]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"cp cli train: losses {losses}")
    if len(end["ranks"]) != 2 or any(r["losses"] != losses
                                     for r in end["ranks"]):
        raise AssertionError(f"cp cli train: the ranks' losses differ "
                             f"{[r['losses'] for r in end['ranks']]}")
    want = [{"ring_step": layers * steps * (i + 1),
             "ring_dq": layers * steps * (i + 1),
             "ring_dkv": layers * steps * (i + 1),
             "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
             "fused_adamw": 2 * steps} for i in range(2)]
    got = [r["launches"] for r in end["ranks"]]
    print("\n".join(lines))
    print(f"losses {losses}")
    print(f"launches per rank {got} expected {want}", flush=True)
    if got != want:
        raise AssertionError(f"cp train launches {got} != {want}")
    return losses, end, got


def _rank_fit(rank, ports, jobs, out_dir, world=2):
    """One of ``world`` ranks (a child process): for each job
    ``(overrides, ckpt_dir, save_every, config[, options])`` in turn,
    build_all + fit of the config to ``train.steps``; with ``ckpt_dir``,
    restored from its latest step when it holds one and saved every
    ``save_every`` steps. ``options``: ``{"hashes": True}`` records a
    digest of every param this rank holds (in place of rank 0's params)
    and its fused AdamW kernel groups; ``{"params": False}`` keeps no
    params; ``{"whole": True}``: rank 0 keeps the whole params of a model
    cut over tp, fsdp or ep (every rank takes part in the gather);
    ``{"eval": True}``: an evaluation after the last step (the config's
    ``train.eval_batches``); ``{"stats": True}``: :func:`leaf_stats` of
    this rank's AdamW moments; ``{"restore_step": N}``: restore
    step N, not
    the latest. Each result carries its job's ``seconds`` and each step's
    (``step_s``). A job ``{"cli": argv}`` runs ``cli.main(argv)``
    on these ranks as ``torchrun`` would run it on fresh ones (its own
    process group, which it leaves at its end), keeping rank 0's standard
    output. Job ``j`` that joins a group meets on ``ports[j]``."""
    import contextlib
    import io

    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch import cli, comms, data
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.config import (
        apply_overrides,
        load_config,
    )
    from distributeddeeplearning_tpu_torch.mesh import (
        build_mesh,
        init_distributed,
        rank_device,
    )
    from distributeddeeplearning_tpu_torch.ops import flash_attention
    from distributeddeeplearning_tpu_torch.ops import fused_adamw
    from distributeddeeplearning_tpu_torch.ops import ring_attention_pallas
    from distributeddeeplearning_tpu_torch.parallel import fsdp, pp
    from distributeddeeplearning_tpu_torch.train import fit, opt_state_bytes

    device = rank_device("cuda")
    torch.cuda.set_device(device)
    for j, job in enumerate(jobs):
        t_job = time.perf_counter()
        flash_attention.reset_launches()
        fused_adamw.reset_launches()
        ring_attention_pallas.reset_launches()
        pp.reset_ticks()
        os.environ["MASTER_PORT"] = str(ports[j])
        if isinstance(job, dict):
            if dist.is_initialized():
                dist.barrier()
                dist.destroy_process_group()
            buf = io.StringIO()
            torch.cuda.reset_peak_memory_stats(device)
            with contextlib.redirect_stdout(buf):
                rc = cli.main(job["cli"])
            out = {"rc": rc, "text": buf.getvalue() if rank == 0 else "",
                   "seconds": time.perf_counter() - t_job}
            torch.save(out, os.path.join(out_dir, f"rank{rank}_job{j}.pt"))
            torch.cuda.empty_cache()
            continue
        overrides, ckpt_dir, save_every, config, *opts = job
        opts = opts[0] if opts else {}
        if not dist.is_initialized():
            init_distributed("cuda")
        cfg = apply_overrides(load_config(config), overrides)
        mesh = build_mesh(cfg.mesh)
        _, trainer, dataset = cli.build_all(cfg, device, mesh)
        state = trainer.init(cfg.train.seed)
        ckpt = None if ckpt_dir is None else CheckpointManager(ckpt_dir)
        if ckpt is not None and ckpt.latest_step() is not None:
            state, _ = ckpt.restore(state, step=opts.get("restore_step"))
        torch.cuda.reset_peak_memory_stats(device)
        comms.reset_transport()
        transport, a2a, step_s = [], [], []
        steps = cfg.train.steps
        state, hist = fit(trainer, state, data.prefetch(
            data.sharded_batches(dataset.iter_from(state.step), mesh,
                                 cfg.train.grad_accum), device),
            steps=steps, log_every=1, log_fn=lambda m: None,
            ckpt=ckpt, save_every=save_every,
            eval_every=steps if opts.get("eval") else 0,
            eval_fn=(cli.make_eval_fn(cfg, mesh, device)
                     if opts.get("eval") else None),
            step_times=step_s,
            on_step=lambda _: (
                transport.append(comms.TRANSPORT["seconds"]),
                a2a.append(comms.TRANSPORT["by_call"].get("all_to_all", 0.0))))
        torch.cuda.synchronize()
        if ckpt is not None:
            ckpt.close()
        whole = None
        if opts.get("whole"):
            whole = state.shards.gather(state.params)
        train_recs = [r for r in hist if "loss" in r]
        out = {"losses": [r["loss"] for r in train_recs],
               "metrics": {k: [r[k] for r in train_recs]
                           for k in ("aux_loss", "moe_dropped_frac")
                           if train_recs and k in train_recs[0]},
               "evals": [r for r in hist if "eval_loss" in r],
               "launches": {**flash_attention.LAUNCHES,
                            **ring_attention_pallas.LAUNCHES,
                            **fused_adamw.LAUNCHES},
               "flash_shapes": {k: sorted(v) for k, v in
                                flash_attention.SHAPES.items()},
               "opt_state_bytes": opt_state_bytes(state.opt_state),
               "timings": [] if ckpt is None else ckpt.timings,
               "pipeline": dict(pp.TICKS), "coords": mesh.coords,
               "transport_s_by_step": [
                   b - a for a, b in zip([0.0, *transport], transport)],
               "all_to_all_s_by_step": [
                   b - a for a, b in zip([0.0, *a2a], a2a)],
               "step_s": step_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        if opts.get("stats"):
            out["stats"] = {"mu": leaf_stats(torch, state.opt_state.mu),
                            "nu": leaf_stats(torch, state.opt_state.nu)}
        if state.shards is not None:
            out["shards"] = {
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in state.params.values()),
                "whole_param_bytes":
                    4 * state.shards.whole_numel(state.params),
                "sharded_fraction": {a: fsdp.sharded_fraction(
                    state.shards, a) for a in ("tp", "fsdp", "ep")}}
        if whole is not None:
            out["params"] = {k: p.detach().cpu() for k, p in whole.items()}
        elif opts.get("whole"):
            pass  # the gather's other ranks
        elif opts.get("hashes"):
            out["hashes"] = {k: param_digest(p)
                             for k, p in state.params.items()}
            out["groups"] = len(fused_adamw.split_leaves(
                state.params, cfg.optim.weight_decay)[1])
        elif rank == 0 and opts.get("params", True):
            out["params"] = {k: p.detach().cpu()
                             for k, p in state.params.items()}
            out["model_state"] = {k: b.detach().cpu()
                                  for k, b in state.model_state.items()}
        out["seconds"] = time.perf_counter() - t_job
        torch.save(out, os.path.join(out_dir, f"rank{rank}_job{j}.pt"))
        del trainer, state
        torch.cuda.empty_cache()
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def param_digest(t) -> str:
    """A digest of a tensor's bytes: equal digests, equal bits."""
    import hashlib

    import torch

    flat = t.detach().contiguous().cpu().reshape(-1)
    return hashlib.sha256(flat.view(torch.uint8).numpy().tobytes()
                          ).hexdigest()


def leaf_stats(torch, tree) -> dict:
    """Per leaf of ``tree`` (name -> tensor), in float64: (its 2-norm, its
    dot product with random signs drawn from the leaf's name at its
    shape). Equal tensors give equal pairs, a scaled one a scaled pair, one
    pointing elsewhere another projection: a rank's block is held against
    the one process's cut of it without moving either."""
    import zlib

    out = {}
    for k, t in tree.items():
        x = t.detach().double()
        gen = torch.Generator(device=x.device)
        gen.manual_seed(zlib.crc32(k.encode()))
        signs = torch.randint(0, 2, x.shape, generator=gen, device=x.device,
                              dtype=torch.float64) * 2 - 1
        out[k] = (x.norm().item(), (x * signs).sum().item())
    return out


# Leaves whose gradient is zero but for rounding: a key bias shifts every
# score of a query's row alike, which the softmax ignores. AdamW turns
# that rounding into steps of up to lr, so two runs' key biases share no
# digits, and a gate on them would hold rounding.
UNOBSERVED = r"\.attn\.key\.bias$"


def stats_diff(got: dict, want: dict) -> list[tuple[float, str]]:
    """The differences of two :func:`leaf_stats` over ``want``'s leaves
    but :data:`UNOBSERVED`, each over its leaf's norm in ``want`` (a
    tensor's relative error, about), largest first, with their leaves."""
    out = []
    for k, (n, p) in want.items():
        if re.search(UNOBSERVED, k):
            continue
        m, q = got[k]
        out.append((max(abs(m - n), abs(q - p)) / n if n
                    else (0.0 if m == 0 else math.inf), k))
    return sorted(out, reverse=True)


def spawn_ranks(torch, jobs, out_dir, nranks=2):
    """``nranks`` ranks of :func:`_rank_fit` sharing the one card over
    gloo, which run each job ``(overrides, ckpt_dir, save_every, config[,
    options])`` or ``{"cli": argv}`` in turn in the same processes: each
    job's [rank 0, ..., rank n-1] results."""
    import socket

    socks = [socket.socket() for _ in jobs]
    for so in socks:
        so.bind(("localhost", 0))
    ports = [so.getsockname()[1] for so in socks]
    for so in socks:
        so.close()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_rank_fit,
                                args=(ports, jobs, out_dir, nranks),
                                nprocs=nranks, join=True)
    out = [[torch.load(os.path.join(out_dir, f"rank{r}_job{j}.pt"))
            for r in range(nranks)] for j in range(len(jobs))]
    print(f"spawned {nranks} ranks for {len(jobs)} job(s): "
          f"{time.perf_counter() - t0:.1f} s; rank 0's seconds by job "
          f"{[round(job[0]['seconds'], 1) for job in out]}", flush=True)
    return out


def zero1_overrides(parity):
    """Phase 13's fp32 run: dp=2 with ZeRO-1 and grad_accum=2."""
    return parity["overrides"] + [
        "mesh.dp=2", "train.zero1=true", f"train.grad_accum={ZERO_ACCUM}"]


# Phase 11's steps (cut for time from phase 8's 4).
CP_PARITY_STEPS = 2


def pair_group(torch, parity, ck, ck12, logs, steps=4):
    """Phase 10: one spawn of 2 ranks sharing the card over gloo runs, in
    turn, phase 10's ``cli train`` (as ``torchrun`` would), phase 11's fp32
    cp=2 run, phase 13's straight ZeRO-1 run (saving halfway into ``ck``)
    and phase 12's ``cli train`` (saving into ``ck12``, its metrics in
    ``logs``). Returns each job's [rank 0, rank 1]."""
    import tempfile

    overrides = parity["overrides"] + [
        "model.kwargs.attn_impl=ring_pallas", "mesh.cp=2", "mesh.dp=1",
        f"train.steps={CP_PARITY_STEPS}"]
    with tempfile.TemporaryDirectory() as tmp:
        return spawn_ranks(torch, [
            cp_cli_job(),
            (overrides, None, 0, CONFIG, {"params": False}),
            (zero1_overrides(parity), ck, steps // 2, CONFIG),
            zero1_cli_job(ck12, logs)], tmp)


def cp_parity(torch, parity, ranks):
    """Phase 11: fp32 at 124M width, 2 ranks at cp=2 (ring_pallas,
    adamw_fused) for ``CP_PARITY_STEPS`` steps (a job of
    :func:`pair_group`) against phase 8's first steps in one process (the
    flash route) on the same weights and batches."""
    la, lb = ranks[0]["losses"], parity["losses_kernels"][:CP_PARITY_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    print(f"cp=2 fp32 parity: losses ring {la} flash {lb} max rel diff "
          f"{rel}; launches per rank {[r['launches'] for r in ranks]}",
          flush=True)
    if ranks[1]["losses"] != la:
        raise AssertionError("cp=2 fp32 parity: the ranks' losses differ")
    if not rel <= 1e-4:
        raise AssertionError(f"cp=2 fp32 parity: loss rel diff {rel} > 1e-4")
    if not la[-1] < la[0]:
        raise AssertionError(f"cp=2 fp32 parity: loss did not fall {la}")
    return {"losses_ring": la, "losses_flash": lb, "max_rel_diff": rel}


# ---------------------------------------------------------------------------
# 12. / 13. ZeRO-1 training
# ---------------------------------------------------------------------------

ZERO_STEPS, ZERO_ACCUM, EVAL_BATCHES = 2, 2, 2
# Phase 13's largest param difference from the one-rank route after 4
# steps (clip and weight decay on): 5.1e-5 on an H100, gated at about
# twice that.
ZERO_PARAM_LIMIT = 1e-4


def cli_job(overrides, config=CONFIG):
    """A job of :func:`spawn_ranks`: ``cli train --sync-steps`` on
    ``config`` run by the spawned ranks as ``torchrun`` would run it."""
    argv = ["train", "--config", config, "--sync-steps"]
    for o in overrides:
        argv += ["--override", o]
    return {"cli": argv}


def cli_result(ranks):
    """A :func:`cli_job`'s (rank 0's text lines, its JSON records, the
    train_end record)."""
    if any(r["rc"] != 0 for r in ranks):
        raise RuntimeError(f"spawned cli train exited "
                           f"{[r['rc'] for r in ranks]}:\n"
                           f"{ranks[0]['text'][-4000:]}")
    print(f"spawned cli train: {ranks[0]['seconds']:.1f} s", flush=True)
    lines = ranks[0]["text"].strip().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    end = next(r for r in recs if r.get("event") == "train_end")
    return [x for x in lines if not x.startswith("{")], recs, end


def zero1_expected(layers, steps, evals):
    """Each rank's launches over ``steps`` steps and ``evals`` passes."""
    train = layers * steps * ZERO_ACCUM
    return {"flash_fwd": train + layers * evals * EVAL_BATCHES,
            "flash_dq": train, "flash_dkv": train, "fused_adamw": 2 * steps,
            "ring_step": 0, "ring_dq": 0, "ring_dkv": 0}


def zero1_cli_job(ck, logs):
    """Phase 12's job for the pair of :func:`pair_group`."""
    return cli_job([f"train.grad_accum={ZERO_ACCUM}", "train.save_every=2",
                    "train.eval_every=2", f"train.eval_batches={EVAL_BATCHES}",
                    "train.log_every=1", f"train.checkpoint_dir={ck}",
                    f"train.log_dir={logs}", f"train.steps={ZERO_STEPS}"])


def cli_train_zero1(torch, layers, n_params, ck, ranks, logs):
    """Phase 12: ``cli train`` on 2 ranks (the job of
    :func:`zero1_cli_job`) on gpt2_owt as shipped (zero1=True, dp=-1 -> 2,
    flash, adamw_fused, bf16, batch 32 x 1024) with grad_accum=2,
    evaluation and checkpoints every 2 steps into ``ck`` and the metrics
    writer into ``logs``, 2 steps (phase 13's fresh pair resumes from the
    save to 4 and runs ZeRO-1 off). Returns the numbers to report and each
    rank's launches."""
    full_bytes = 8 * n_params  # two fp32 moments, unsharded
    text, recs, end = cli_result(ranks)
    print("\n".join(text))
    losses = [r["loss"] for r in recs if "loss" in r]
    evals = [r["step"] for r in recs if "eval_loss" in r]
    if len(losses) != ZERO_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"zero1 cli train: losses {losses}")
    if evals != [2]:
        raise AssertionError(f"zero1 cli train: eval records at {evals}")
    want = zero1_expected(layers, ZERO_STEPS, len(evals))
    got = [r["launches"] for r in end["ranks"]]
    print(f"losses {losses}\nlaunches per rank {got} expected {want}",
          flush=True)
    if got != [want, want]:
        raise AssertionError(f"zero1 train launches {got} != {want}")
    opt = [r["opt_state_bytes"] for r in end["ranks"]]
    # The padding: < dp x 4 = 8 elements in each of two groups, 8 bytes
    # of moments an element.
    if any(not 0 <= 2 * b - full_bytes < 2 * 8 * 8 for b in opt):
        raise AssertionError(f"zero1: per-rank optimizer bytes {opt} "
                             f"are not half of {full_bytes}")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        jl = [json.loads(x) for x in f]
    if ([r["step"] for r in jl if "loss" in r] != [1, 2]
            or [r["step"] for r in jl if "eval_loss" in r] != [2]
            or any(r.get("schema") != 1 for r in jl)):
        raise AssertionError(f"metrics.jsonl: {jl}")
    steps_on_disk = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
    if steps_on_disk != [2]:
        raise AssertionError(f"checkpoints at {steps_on_disk}")
    saves = end["ranks"][0]["checkpoints"]
    step_s = end["step_s"][1:]  # the first step warms the libraries up
    res = {
        "backend": end["backend"], "ranks_on_one_card": 2,
        "p50_step_ms": statistics.median(step_s) * 1e3,
        "step_ms": [x * 1e3 for x in step_s],
        "opt_state_bytes_per_rank": opt,
        "peak_mem_gb": [r["peak_mem_gb"] for r in end["ranks"]],
        "checkpoint_saves": saves,
    }
    print(f"zero1 train: {json.dumps(res)} (both ranks share the one card "
          "over gloo: not a data-parallel speed)", flush=True)
    return res, got


def zero1_jobs(parity, ck, ck12, steps=4):
    """Phase 13's jobs for a pair of fresh processes (phase 16's): the
    resume from the halfway save of phase 13's straight run in ``ck``;
    phase 12's ZeRO-1-off job, gpt2_owt as shipped with grad_accum=2 for 2
    steps; phase 12's run resumed from its step-2 save in ``ck12`` to 4."""
    on_disk = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
    if on_disk != [steps // 2, steps]:
        raise AssertionError(f"zero1 parity: checkpoints at {on_disk}")
    shutil.rmtree(os.path.join(ck, str(steps)))  # resume from halfway
    return [(zero1_overrides(parity), ck, 0, CONFIG),
            ([f"train.grad_accum={ZERO_ACCUM}", "train.zero1=false",
              "train.steps=2"], None, 0, CONFIG, {"params": False}),
            ([f"train.grad_accum={ZERO_ACCUM}", "train.steps=4"], ck12, 0,
             CONFIG, {"params": False})]


def zero1_parity(torch, parity, ranks, fresh, steps=4):
    """Phase 13: fp32 at 124M width, 2 ranks at dp=2 with ZeRO-1 and
    grad_accum=2 (flash, adamw_fused), run in phase 11's processes
    (``ranks``), against phase 8's single-process flash route; then fresh
    processes (phase 16's pair, running :func:`zero1_jobs`: ``fresh``, the
    results) resume from its halfway save and run the second half, which
    must equal the straight run bit for bit. The same two processes run
    phase 12's ZeRO-1-off job: gpt2_owt as shipped with grad_accum=2 for 2
    steps (the gradient all-reduce, then fused_adamw over the whole
    leaves), whose moments are the whole 8 bytes a parameter a rank, for
    its memory beside phase 12's; and resume phase 12's run from its
    step-2 save to step 4 (exact launches). Returns each rank's launches
    of that resumed run."""
    second, off, resumed12 = fresh
    n_params = sum(p.numel() for p in parity["params_kernels"].values())
    off_opt = [r["opt_state_bytes"] for r in off]
    layers = sum(k.endswith("attn.query.kernel")
                 for k in parity["params_kernels"])
    want_off = zero1_expected(layers, 2, 0)
    got_off = [r["launches"] for r in off]
    print(f"zero1 off: optimizer bytes per rank {off_opt}, peak memory "
          f"{[r['peak_mem_gb'] for r in off]} GB, losses "
          f"{[r['losses'] for r in off]}, launches {got_off}", flush=True)
    if off_opt != [8 * n_params] * 2 or got_off != [want_off] * 2:
        raise AssertionError(f"zero1 off: optimizer bytes {off_opt} (want "
                             f"{8 * n_params}), launches {got_off} != "
                             f"{want_off}")
    got12 = [r["launches"] for r in resumed12]
    l12 = [r["losses"] for r in resumed12]
    print(f"phase 12's run resumed from step 2 in fresh processes: losses "
          f"{l12}, launches {got12}", flush=True)
    if (len(l12[0]) != 2 or l12[1] != l12[0]
            or not all(map(math.isfinite, l12[0]))
            or got12 != [zero1_expected(layers, 2, 0)] * 2):
        raise AssertionError(f"phase 12 resume: losses {l12}, launches "
                             f"{got12}")
    la, lb = ranks[0]["losses"], parity["losses_kernels"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    pb = parity["params_kernels"]
    pdiff = max((ranks[0]["params"][k] - pb[k].cpu()).abs().max().item()
                for k in pb)
    resumed = [s["losses"] for s in second]
    print(f"zero1 fp32 parity: losses dp=2 zero1 accum=2 {la} one rank {lb} "
          f"max rel diff {rel}; max abs param diff after {steps} steps "
          f"{pdiff} (limit {ZERO_PARAM_LIMIT}); saved and resumed {resumed}; "
          f"checkpoint "
          f"saves {ranks[0]['timings']}", flush=True)
    if ranks[1]["losses"] != la:
        raise AssertionError("zero1 fp32 parity: the ranks' losses differ")
    if not rel <= 1e-4:
        raise AssertionError(f"zero1 fp32 parity: loss rel diff {rel} > 1e-4")
    if not pdiff <= ZERO_PARAM_LIMIT:
        raise AssertionError(f"zero1 fp32 parity: param diff {pdiff} > "
                             f"{ZERO_PARAM_LIMIT}")
    if not la[-1] < la[0]:
        raise AssertionError(f"zero1 fp32 parity: loss did not fall {la}")
    if any(r != la[steps // 2:] for r in resumed):
        raise AssertionError(f"zero1 resume is not bit-exact: {resumed} "
                             f"against {la[steps // 2:]}")
    if any(not torch.equal(second[0]["params"][k], ranks[0]["params"][k])
           for k in pb):
        raise AssertionError("zero1 resume: params differ from the "
                             "straight run")
    return got12


# ---------------------------------------------------------------------------
# 14. - 16. ResNet-50 data-parallel training (no hand kernel on the path)
# ---------------------------------------------------------------------------

RESNET = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                      "resnet50_imagenet.py")
RESNET_STEPS, NATIVE_STEPS = 4, 4
# Phase 16's fp32 parity at a global batch of 16 (8 a rank), one batch
# repeated at a constant lr low enough that the loss falls smoothly in 4
# steps. The runs agree to ~4e-7 through step 3, and then rounding grows
# by x20-x200 a step: at lr 0.1 the loss overshoots by step 3 and step 4
# parts by 3.5e-3; at 0.01 by 8.4e-5 (H100 runs of this phase).
RESNET_PARITY = ["model.kwargs.dtype=float32", "data.batch_size=16",
                 "data.n_distinct=1", "optim.schedule=constant",
                 "optim.warmup_steps=0", "optim.lr=0.002", "train.steps=4"]
# Phase 16's BatchNorm running statistics against one process after 4
# steps, each tensor's largest difference over its largest value: flax's
# E[x²] - E[x]² loses ~1e-7 of E[x²] to the order of the sums, which is
# much of a small variance's value.
BN_STATS_TOL = 1e-3


def all_launches():
    """Every hand kernel's launch count, by name."""
    from distributeddeeplearning_tpu_torch.ops import (
        flash_attention,
        fused_adamw,
        paged_attention,
        ring_attention_pallas,
    )

    return {**paged_attention.LAUNCHES, **flash_attention.LAUNCHES,
            **fused_adamw.LAUNCHES, **ring_attention_pallas.LAUNCHES}


def reset_all_launches():
    from distributeddeeplearning_tpu_torch.ops import (
        flash_attention,
        fused_adamw,
        paged_attention,
        ring_attention_pallas,
    )

    for mod in (paged_attention, flash_attention, fused_adamw,
                ring_attention_pallas):
        mod.reset_launches()


def config_cli_train(cli, config, steps, overrides=(), start=0):
    """``cli train --sync-steps`` in-process on ``config`` as shipped but
    for ``overrides``, to step ``steps`` from step ``start`` (a resume):
    (losses, step seconds after the first, train_end record, text lines,
    step records)."""
    argv = ["train", "--config", config, "--device", "cuda", "--sync-steps",
            "--override", f"train.steps={steps}",
            "--override", "train.log_every=1"]
    for o in overrides:
        argv += ["--override", o]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    name = os.path.basename(config)
    if rc != 0:
        raise RuntimeError(f"{name} cli train exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    steps_recs = [r for r in recs if "loss" in r]
    losses = [r["loss"] for r in steps_recs]
    end = next(r for r in recs if r.get("event") == "train_end")
    if (len(losses) != steps - start
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"{name} cli train: losses {losses}")
    return losses, end["step_s"][1:], end, [
        x for x in lines if not x.startswith("{")], steps_recs


def resnet_train(torch, cli, batch):
    """Phase 14: 4 steps of the shipped config, then 4 with the C++
    loader; no hand kernel launches on this path."""
    out = {}
    for kind, steps, extra in (
            ("synthetic_image", RESNET_STEPS, ()),
            ("native_image", NATIVE_STEPS, ("data.kind=native_image",))):
        reset_all_launches()  # this path's counts start here
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, end, text, _ = config_cli_train(cli, RESNET, steps,
                                                        extra)
        launched = all_launches()
        print("\n".join(text))
        res = {"data": kind, "losses": losses,
               "images_per_s": batch / statistics.mean(step_s),
               "p50_step_ms": statistics.median(step_s) * 1e3,
               "step_ms": [x * 1e3 for x in step_s],
               "peak_mem_gb": end["peak_mem_gb"],
               "opt_state_bytes": end["opt_state_bytes"]}
        print(f"resnet50 train: {json.dumps(res)}", flush=True)
        if any(launched.values()):
            raise AssertionError(f"resnet path launched hand kernels "
                                 f"{launched}: it should run none")
        out[kind] = res
    print("launches on the resnet path: none of the nine (as expected)",
          flush=True)
    return out


# Every benchmark phase runs ``cli benchmark`` at this depth: 4 timed
# steps and 4 synced ones after the 5 warm-up steps, and the multi-step
# probe at K = 2 in 2 calls (the defaults, 30, 12 and K = 8 in 3 calls,
# took 38 s on llama_moe).
BENCH_DEPTH = ["--steps", "4", "--latency-steps", "4", "--probe", "2"]


def config_benchmark(cli, config):
    """Phases 15, 18, 22 and 26: ``cli benchmark`` on a shipped config at
    ``BENCH_DEPTH``. The record, checked."""
    argv = ["benchmark", "--config", config, "--device", "cuda",
            *BENCH_DEPTH]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli benchmark exited {rc}")
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if not (rec.get("fused_steps_per_sec", 0) > 0
            and isinstance(rec.get("dispatch_overhead_ms_per_step"), float)):
        raise AssertionError(f"benchmark probe: {rec}")
    for key in ("value", "p50_step_ms", "p90_step_ms", "mfu",
                "hbm_peak_bytes", "model_tflops_per_step"):
        if not isinstance(rec.get(key), (int, float)) or not rec[key] > 0:
            raise AssertionError(f"benchmark record: {key}={rec.get(key)!r}")
    if rec["platform"] != "gpu" or not math.isfinite(rec["loss"]):
        raise AssertionError(f"benchmark record: {rec}")
    return rec


def resnet_one_process(torch, cli, load_config, apply_overrides, accum):
    """Phase 16's reference: the parity config in this process."""
    from distributeddeeplearning_tpu_torch import data
    from distributeddeeplearning_tpu_torch.train import fit

    cfg = apply_overrides(load_config(RESNET), RESNET_PARITY + [
        f"train.grad_accum={accum}"])
    _, trainer, dataset = cli.build_all(cfg, "cuda")
    state = trainer.init(cfg.train.seed)
    state, hist = fit(trainer, state, data.prefetch(data.sharded_batches(
        dataset.iter_from(0), None, accum), "cuda"),
        steps=cfg.train.steps, log_every=1, log_fn=lambda m: None)
    torch.cuda.synchronize()
    out = ([r["loss"] for r in hist],
           {k: b.detach().cpu() for k, b in state.model_state.items()})
    del trainer, state
    torch.cuda.empty_cache()
    return out


def resnet_dp2(torch, cli, load_config, apply_overrides, extra=()):
    """Phase 16: one pair of fresh processes runs ``cli train`` on the
    shipped config at dp=2 with eval and checkpoints every 2 steps (as
    ``torchrun`` would), the fp32 parity of dp=2 (grad_accum 1 and 2)
    against one process, a resume from the step-2 save that repeats steps
    3 and 4 bit for bit, and the ``extra`` jobs (phase 13's). Returns (the
    record, the extra jobs' results, the one process's (losses, running
    statistics) at grad_accum 1, phase 39's reference)."""
    import tempfile

    accums = (1, 2)
    one = [resnet_one_process(torch, cli, load_config, apply_overrides, a)
           for a in accums]
    with tempfile.TemporaryDirectory() as tmp:
        ck, logs = os.path.join(tmp, "ckpt"), os.path.join(tmp, "logs")
        base = ["train.save_every=2", "train.eval_every=2",
                "train.eval_batches=1", "train.log_every=1",
                f"train.checkpoint_dir={ck}", f"train.log_dir={logs}"]
        out = spawn_ranks(torch, [
            cli_job(base + ["train.steps=4"], config=RESNET),
            *[(RESNET_PARITY + ["mesh.dp=2", f"train.grad_accum={a}"], None,
               0, RESNET) for a in accums],
            (["train.steps=4"], ck, 0, RESNET, {"restore_step": 2}),
            *extra], tmp)
        text, recs, end = cli_result(out[0])
        print("\n".join(text))
        losses = [r["loss"] for r in recs if "loss" in r]
        evals = [r["step"] for r in recs if "eval_loss" in r]
        if len(losses) != 4 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"resnet dp=2 cli train: losses {losses}")
        if evals != [2, 4] or end["backend"] != "gloo":
            raise AssertionError(f"resnet dp=2 cli train: evals {evals}, "
                                 f"backend {end['backend']}")
        if any(r["losses"] != losses for r in end["ranks"]):
            raise AssertionError("resnet dp=2 cli train: ranks differ")
        steps_on_disk = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
        if steps_on_disk != [2, 4]:
            raise AssertionError(f"checkpoints at {steps_on_disk}")
        *dp2, resume = out[1:len(accums) + 2]
    resumed = resume[0]["losses"]
    print(f"resnet dp=2 resumed from step 2 in fresh processes: {resumed} "
          f"against {losses[2:]}", flush=True)
    if resumed != losses[2:] or resume[1]["losses"] != resumed:
        raise AssertionError(f"resnet resume: {resumed} against "
                             f"{losses[2:]}")
    parity = {}
    for accum, (la, sa), ranks in zip(accums, one, dp2):
        lb, sb = ranks[0]["losses"], ranks[0]["model_state"]
        rels = [abs(a - b) / abs(b) for a, b in zip(lb, la)]
        rel = max(rels)
        sdiff = max(((sb[k] - sa[k]).abs().max()
                     / sa[k].abs().max()).item() for k in sa)
        print(f"resnet50 fp32 dp=2 grad_accum={accum}: losses {lb} one "
              f"process {la} rel diff by step {rels}; running statistics' "
              f"largest diff over the tensor's largest value {sdiff} "
              f"(limit {BN_STATS_TOL}); launches per rank "
              f"{[r['launches'] for r in ranks]}", flush=True)
        if ranks[1]["losses"] != lb:
            raise AssertionError("resnet dp=2: the ranks' losses differ")
        if not rel <= 1e-4:
            raise AssertionError(f"resnet dp=2: loss rel diff {rel} > 1e-4")
        if not (lb[-1] < lb[0] and la[-1] < la[0]):
            raise AssertionError(f"resnet dp=2: loss did not fall {lb} {la}")
        if not sdiff <= BN_STATS_TOL:
            raise AssertionError(f"resnet dp=2: running statistics off by "
                                 f"{sdiff}")
        if any(any(r["launches"].values()) for r in ranks):
            raise AssertionError("resnet dp=2 launched hand kernels")
        parity[accum] = {"losses_dp2": lb, "losses_one": la,
                         "max_rel_diff": rel, "bn_stats_diff": sdiff}

    step_s = end["step_s"][1:]
    res = {"backend": end["backend"], "ranks_on_one_card": 2,
           "p50_step_ms": statistics.median(step_s) * 1e3,
           "step_ms": [x * 1e3 for x in step_s], "losses": losses,
           "resumed_losses": resumed,
           "peak_mem_gb": [r["peak_mem_gb"] for r in end["ranks"]],
           "checkpoint_saves": end["ranks"][0]["checkpoints"],
           "parity": parity}
    print(f"resnet50 dp=2 train: {json.dumps(res)} (both ranks share the one "
          "card over gloo: not a data-parallel speed)", flush=True)
    return res, out[len(accums) + 2:], one[0]


# ---------------------------------------------------------------------------
# 17. - 20. the encoders: ViT-L/16 with remat, BERT-base MLM
# ---------------------------------------------------------------------------

VIT = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                   "vit_imagenet21k.py")
BERT = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                    "bert_mlm.py")
VIT_STEPS, BERT_STEPS = 4, 4
# Phase 20's fp32 pairs: one batch repeated at the config's lr held
# constant, as phase 8. (BERT at ViT's lr of 1e-3 overshoots by step 3.)
ENCODER_PARITY = ["model.kwargs.dtype=float32", "data.batch_size=4",
                  "data.n_distinct=1", "optim.schedule=constant",
                  "optim.warmup_steps=0", "optim.grad_clip=1.0",
                  "train.steps=2"]
MASKED_FRACTION_TOL = 0.01  # 8192 tokens a step: one sd of 0.15 is 0.004


def model_shape(models, load_config, apply_overrides, config, overrides=()):
    """(layers, fused AdamW groups, params, the model on the meta device)
    of a config."""
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused

    cfg = apply_overrides(load_config(config), list(overrides))
    meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                            device="meta")
    params = dict(meta.named_parameters())
    _, groups = fused.split_leaves(params, cfg.optim.weight_decay)
    return (meta.num_layers, len(groups),
            sum(p.numel() for p in params.values()), meta)


def flash_model_train(torch, cli, name, config, steps, layers, groups,
                      fwd_per, accum, overrides=(), start=0, skipped=0):
    """``cli train`` on a flash config, to ``steps`` from ``start`` (a
    resume): (record, launches). Per step ``flash_fwd`` launches layers x
    fwd_per x accum times (fwd_per 2 under remat: the forward and the
    recompute), ``flash_dq`` and ``flash_dkv`` layers x accum,
    ``fused_adamw`` once a group on each step the health guard did not
    skip (``skipped`` of them)."""
    reset_all_launches()  # this path's counts start here
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, end, text, recs = config_cli_train(cli, config, steps,
                                                       overrides, start)
    launched = all_launches()
    ran = steps - start
    want = {k: 0 for k in launched}
    want.update(flash_fwd=layers * fwd_per * accum * ran,
                flash_dq=layers * accum * ran,
                flash_dkv=layers * accum * ran,
                fused_adamw=groups * (ran - skipped))
    print("\n".join(text))
    res = {"config": os.path.basename(config), "overrides": list(overrides),
           "losses": losses, "p50_step_ms": statistics.median(step_s) * 1e3,
           "step_ms": [x * 1e3 for x in step_s],
           "peak_mem_gb": end["peak_mem_gb"],
           "opt_state_bytes": end["opt_state_bytes"],
           "launches": launched}
    for key in ("masked_fraction", "aux_loss", "moe_dropped_frac",
                "skipped", "anomalies"):
        extra = [r.get(key) for r in recs]
        if extra[0] is not None:
            res[key] = extra
    print(f"{name} train: {json.dumps(res)}", flush=True)
    print(f"launches {launched} expected {want}", flush=True)
    if launched != want:
        raise AssertionError(f"{name} launches {launched} != {want}")
    return res, launched


def vit_train(torch, cli, models, load_config, apply_overrides):
    """Phase 17: ViT-L/16 as shipped (remat 'full') for 4 steps, then 2
    with remat off, for the memory remat saves."""
    layers, groups, n, _ = model_shape(models, load_config,
                                       apply_overrides, VIT)
    batch = load_config(VIT).data.batch_size
    print(f"vit: {layers} layers, {n:,} params, {groups} AdamW groups; "
          f"per step flash_fwd {2 * layers}, flash_dq and flash_dkv "
          f"{layers} each, fused_adamw {groups}", flush=True)
    full, launched = flash_model_train(torch, cli, "vit remat=full", VIT,
                                       VIT_STEPS, layers, groups, 2, 1)
    full["images_per_s"] = batch / (statistics.mean(full["step_ms"]) / 1e3)
    none, more = flash_model_train(torch, cli, "vit remat=none", VIT, 2,
                                   layers, groups, 1, 1,
                                   ["train.remat=none"])
    none["images_per_s"] = batch / (statistics.mean(none["step_ms"]) / 1e3)
    print(f"vit: remat full {full['images_per_s']:.1f} images/s, p50 "
          f"{full['p50_step_ms']:.2f} ms, peak {full['peak_mem_gb']:.2f} "
          f"GB; remat none {none['images_per_s']:.1f} images/s, p50 "
          f"{none['p50_step_ms']:.2f} ms, peak {none['peak_mem_gb']:.2f} GB",
          flush=True)
    return {"full": full, "none": none}, [launched, more]


def bert_train(torch, cli, models, load_config, apply_overrides):
    """Phase 19: BERT-base MLM as shipped (4 microbatches) for 4 steps,
    then 2 with padded rows (``data.pad_min_len=32``: the attention mask
    becomes the flash kernels' per-row key limits)."""
    cfg = load_config(BERT)
    layers, groups, n, _ = model_shape(models, load_config,
                                       apply_overrides, BERT)
    accum = cfg.train.grad_accum
    tokens = cfg.data.batch_size * cfg.data.seq_len
    print(f"bert: {layers} layers, {n:,} params, {groups} AdamW groups, "
          f"grad_accum {accum}; per step each flash kernel "
          f"{layers * accum}, fused_adamw {groups}", flush=True)
    out, launches = {}, []
    for key, steps, extra in (("dense", BERT_STEPS, ()),
                              ("padded", 2, ("data.pad_min_len=32",))):
        res, launched = flash_model_train(torch, cli, f"bert {key}", BERT,
                                          steps, layers, groups, 1, accum,
                                          extra)
        res["tokens_per_s"] = tokens / (statistics.mean(res["step_ms"]) / 1e3)
        launches.append(launched)
        out[key] = res
    dense = out["dense"]["masked_fraction"]
    if not all(abs(f - 0.15) < MASKED_FRACTION_TOL for f in dense):
        raise AssertionError(f"bert masked_fraction {dense}: not 0.15")
    padded = out["padded"]["masked_fraction"]
    if not all(0 < f < 0.15 for f in padded):
        raise AssertionError(f"bert padded masked_fraction {padded}")
    print(f"bert: {out['dense']['tokens_per_s']:.0f} tokens/s, p50 "
          f"{out['dense']['p50_step_ms']:.2f} ms, peak "
          f"{out['dense']['peak_mem_gb']:.2f} GB; masked_fraction {dense}",
          flush=True)
    return out, launches


CAUSAL_LMS = ("gpt2", "llama", "gpt2_moe", "llama_moe")


def flash_flops_per_step(cfg, meta):
    """The flash kernels' matrix FLOPs in one training step of ``cfg``'s
    model (``meta``), from the shapes: 4·D a visible pair forward (twice
    under remat), 6·D dq, 8·D dkv; a causal LM's row of L tokens sees
    L (L + 1) / 2 pairs. ``FlopCounterMode`` does not see them."""
    tokens = (meta.pos_embed.shape[0] if hasattr(meta, "pos_embed")
              else cfg.data.seq_len)
    fwd = 2 if cfg.train.remat != "none" else 1
    per_row = (tokens * (tokens + 1) // 2 if cfg.model.name in CAUSAL_LMS
               else tokens * tokens)
    pairs = cfg.data.batch_size * meta.num_heads * per_row
    return meta.num_layers * (4 * fwd + 6 + 8) * meta.head_dim * pairs


def flash_benchmarks(torch, cli, models, load_config, apply_overrides,
                     configs):
    """Phases 18, 22 and 26: ``cli benchmark`` (at ``BENCH_DEPTH``) on each
    ``(name, config)`` as shipped; each record, with the flash kernels'
    share of the step's FLOPs."""
    out = {}
    for name, config in configs:
        torch.cuda.empty_cache()
        rec = config_benchmark(cli, config)
        cfg = load_config(config)
        meta = model_shape(models, load_config, apply_overrides, config)[3]
        flash = flash_flops_per_step(cfg, meta)
        counted = rec["model_tflops_per_step"] * 1e12
        note = {"flash_tflops_per_step": flash / 1e12,
                "flash_share_of_step_flops": flash / (flash + counted),
                "counted_includes_recompute": cfg.train.remat != "none"}
        print(f"{name} benchmark: {json.dumps(rec)}", flush=True)
        print(f"{name} benchmark: FlopCounterMode counts the products it "
              f"dispatches (the remat recompute's too: "
              f"{note['counted_includes_recompute']}); the flash kernels "
              f"launch by ctypes and are not counted: "
              f"{json.dumps(note)}", flush=True)
        out[name] = {**rec, **note}
    return out


def route_run(torch, cli, load_config, apply_overrides, config, overrides,
              keep=None):
    """fp32 training on one route: (losses, params on the host, hand
    kernel launches, ``keep(state)`` or None)."""
    from distributeddeeplearning_tpu_torch import data
    from distributeddeeplearning_tpu_torch.train import fit

    cfg = apply_overrides(load_config(config), list(overrides))
    torch.cuda.empty_cache()
    _, trainer, dataset = cli.build_all(cfg, "cuda")
    state = trainer.init(cfg.train.seed)
    before = sum(all_launches().values())
    state, hist = fit(trainer, state, data.prefetch(data.sharded_batches(
        dataset.iter_from(0), None, cfg.train.grad_accum), "cuda"),
        steps=cfg.train.steps, log_every=1, log_fn=lambda m: None)
    torch.cuda.synchronize()
    out = ([r["loss"] for r in hist],
           {k: p.detach().cpu() for k, p in state.params.items()},
           sum(all_launches().values()) - before,
           None if keep is None else keep(state))
    del trainer, state
    torch.cuda.empty_cache()
    return out


def rel_diff(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def parity_runs(torch, cli, load_config, apply_overrides, routes, pairs,
                keep=None):
    """fp32 training on each route of ``routes`` ((key, config,
    overrides)), then each pair of ``pairs`` ((a, b, limit)): the losses
    of a within ``limit`` relative of b's. Every run's loss falls; the
    routes whose key names ``kernels`` launch kernels, the others none.
    ``keep``: route key -> a function of its final state, whose results
    the record holds under ``kept``."""
    runs, keep = {}, keep or {}
    for key, config, extra in routes:
        runs[key] = route_run(torch, cli, load_config, apply_overrides,
                              config, extra, keep.get(key))
        losses, _, launched, _ = runs[key]
        if (launched > 0) != ("kernels" in key):
            raise AssertionError(f"parity route {key}: {launched} launches")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"parity route {key}: loss did not fall "
                                 f"{losses}")
    out = {}
    for a, b, limit in pairs:
        (la, pa, _, _), (lb, pb, _, _) = runs[a], runs[b]
        rel = rel_diff(la, lb)
        pdiff = max((pa[k] - pb[k]).abs().max().item() for k in pa)
        equal = la == lb and all(torch.equal(pa[k], pb[k]) for k in pa)
        print(f"fp32 parity {a} vs {b}: losses {la} vs {lb}, max rel diff "
              f"{rel} (limit {limit}); max abs param diff {pdiff}; "
              f"bit-equal {equal}", flush=True)
        if not rel <= limit:
            raise AssertionError(f"fp32 parity {a} vs {b}: {rel} > {limit}")
        out[f"{a}_vs_{b}"] = {"losses": [la, lb], "max_rel_diff": rel,
                              "max_abs_param_diff": pdiff,
                              "bit_equal": equal}
    if keep:
        out["kept"] = {k: runs[k][3] for k in keep}
    return out


def rank_cuts(torch, load_config, apply_overrides, config, overrides):
    """A ``keep`` of :func:`parity_runs`: for each rank of ``TP_MESH``
    (tp2 x fsdp2), :func:`leaf_stats` of the one process's AdamW moments
    cut to that rank's blocks, what phase 39(f)'s rank holds if its
    sharded step is right."""
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    cfg = apply_overrides(load_config(config), list(overrides) + TP_MESH)
    shape = {a: getattr(cfg.mesh, a) for a in ("fsdp", "tp")}

    def keep(state):
        out = []
        for rank in range(math.prod(shape.values())):
            meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                                    mesh=Mesh(shape, rank=rank),
                                    device="meta")
            out.append({
                name: leaf_stats(torch, meta.shards.take(tree))
                for name, tree in (("mu", state.opt_state.mu),
                                   ("nu", state.opt_state.nu))})
        return out
    return keep


def encoder_parity(torch, cli, load_config, apply_overrides):
    """Phase 20: fp32 at full width, batch 4, 2 steps from one seed's
    weights on one batch: ViT-L/16 (flash, adamw_fused, remat full)
    against (xla, adamw, remat none) within 1e-4 relative, and against
    (flash, adamw_fused, remat none) within 1e-6; BERT-base with padded
    rows and grad_accum 2, flash against xla within 1e-4. The kernel
    routes' AdamW moments are kept cut to phase 39(f)'s ranks
    (:func:`rank_cuts`)."""
    routes = [(key, config, ENCODER_PARITY + extra) for key, config, extra in (
            ("vit_kernels", VIT, ["model.kwargs.attn_impl=flash",
                                  "optim.name=adamw_fused",
                                  "train.remat=full"]),
            ("vit_plain", VIT, ["model.kwargs.attn_impl=xla",
                                "optim.name=adamw", "train.remat=none"]),
            ("vit_kernels_no_remat", VIT, ["model.kwargs.attn_impl=flash",
                                           "optim.name=adamw_fused",
                                           "train.remat=none"]),
            ("bert_kernels", BERT, ["model.kwargs.attn_impl=flash",
                                    "optim.name=adamw_fused",
                                    "data.pad_min_len=32",
                                    "train.grad_accum=2"]),
            ("bert_plain", BERT, ["model.kwargs.attn_impl=xla",
                                  "optim.name=adamw", "data.pad_min_len=32",
                                  "train.grad_accum=2"]))]
    keep = {key: rank_cuts(torch, load_config, apply_overrides, config,
                           extra)
            for key, config, extra in routes if key in ("vit_kernels",
                                                        "bert_kernels")}
    return parity_runs(torch, cli, load_config, apply_overrides, routes, (
        ("vit_kernels", "vit_plain", 1e-4),
        ("vit_kernels", "vit_kernels_no_remat", 1e-6),
        ("bert_kernels", "bert_plain", 1e-4)), keep)


# ---------------------------------------------------------------------------
# 21. - 24. Llama-300M
# ---------------------------------------------------------------------------

LLAMA = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                     "llama_lm.py")
LLAMA_STEPS = 4
# Phase 23's fp32 pair: one batch of 2 x 2048 repeated at the config's lr
# held constant, as phases 8 and 20.
LLAMA_PARITY = ["model.kwargs.dtype=float32", "data.batch_size=2",
                "data.n_distinct=1", "optim.schedule=constant",
                "optim.warmup_steps=0", "optim.grad_clip=1.0",
                "train.steps=3"]


def llama_train(torch, cli, models, load_config, apply_overrides):
    """Phase 21: Llama-300M as shipped (16 x 2048, bf16, flash over K and V
    repeated to 16 heads, chunked head, adamw_fused, zero1 at dp = 1) for
    4 steps: each flash kernel 12 launches a step, fused_adamw once a
    group; tokens/s over steps 2..N, p50 step, peak memory."""
    layers, groups, n, _ = model_shape(models, load_config,
                                       apply_overrides, LLAMA)
    cfg = load_config(LLAMA)
    tokens = cfg.data.batch_size * cfg.data.seq_len
    print(f"llama: {layers} layers, {n:,} params, {groups} AdamW groups; "
          f"per step each flash kernel {layers}, fused_adamw {groups}",
          flush=True)
    res, launched = flash_model_train(torch, cli, "llama", LLAMA,
                                      LLAMA_STEPS, layers, groups, 1, 1)
    res["tokens_per_s"] = tokens / (statistics.mean(res["step_ms"]) / 1e3)
    print(f"llama: {res['tokens_per_s']:.0f} tokens/s, p50 "
          f"{res['p50_step_ms']:.2f} ms, peak {res['peak_mem_gb']:.2f} GB",
          flush=True)
    return res, launched


def llama_parity(torch, cli, load_config, apply_overrides):
    """Phase 23: fp32 at full width, batch 2 x 2048, 3 steps on one batch:
    (flash, adamw_fused) against (xla, adamw) within 1e-4 relative."""
    routes = [
        ("llama_kernels", LLAMA, LLAMA_PARITY + [
            "model.kwargs.attn_impl=flash", "optim.name=adamw_fused"]),
        ("llama_plain", LLAMA, LLAMA_PARITY + [
            "model.kwargs.attn_impl=xla", "optim.name=adamw"])]
    return parity_runs(torch, cli, load_config, apply_overrides, routes,
                       (("llama_kernels", "llama_plain", 1e-4),))


# ---------------------------------------------------------------------------
# 25. - 29. the MoE models and the token-file path
# ---------------------------------------------------------------------------

LLAMA_MOE = os.path.join(ROOT, "distributeddeeplearning_tpu_torch",
                         "configs", "llama_moe.py")
GPT2_MOE = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                        "gpt2_moe.py")
OWT_FILE = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                        "gpt2_owt_file.py")
MOE_STEPS = 4
# Phase 28's fp32 pair: one batch of 2 x 2048 at the config's lr held
# constant, at the shipped capacity factor (a fresh router's loads already
# overflow 640 slots: about a third of the assignments drop).
MOE_PARITY = ["model.kwargs.dtype=float32", "data.batch_size=2",
              "data.n_distinct=1", "optim.schedule=constant",
              "optim.warmup_steps=0", "optim.grad_clip=1.0",
              "train.steps=2"]
OWT_FILE_STEPS = 4


def moe_onehot_flops(models, load_config, apply_overrides, config,
                     overrides=()):
    """The one-hot dispatch and combine einsums' FLOPs in one training step
    of ``config`` (``models.moe.onehot_flops``, from the shapes)."""
    from distributeddeeplearning_tpu_torch.models.moe import (
        moe_mlps,
        onehot_flops,
    )

    cfg = apply_overrides(load_config(config), list(overrides))
    meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                            device="meta")
    fwd = 2 if cfg.train.remat != "none" else 1
    return sum(onehot_flops(m, cfg.data.batch_size, cfg.data.seq_len, fwd)
               for m in moe_mlps(meta))


def moe_train(torch, cli, models, load_config, apply_overrides, name,
              config, overrides=()):
    """Phases 25 and 27: an MoE config as shipped (but for ``overrides``)
    for MOE_STEPS steps: each flash kernel launches once a layer a step
    (twice for flash_fwd under remat), fused_adamw never (the configs ship
    the plain AdamW, as the reference's do); every loss, aux_loss and
    moe_dropped_frac finite; tokens/s over steps 2..N, p50 step, peak
    memory."""
    cfg = apply_overrides(load_config(config), list(overrides))
    layers, _, n, _ = model_shape(models, load_config, apply_overrides,
                                  config, overrides)
    fwd = 2 if cfg.train.remat != "none" else 1
    tokens = cfg.data.batch_size * cfg.data.seq_len
    print(f"{name}: {layers} layers, {n:,} params, optim {cfg.optim.name}, "
          f"remat {cfg.train.remat}; per step flash_fwd {fwd * layers}, "
          f"flash_dq and flash_dkv {layers} each, fused_adamw 0", flush=True)
    if cfg.optim.name != "adamw":
        raise AssertionError(f"{name}: optim {cfg.optim.name}, not adamw")
    res, launched = flash_model_train(torch, cli, name, config, MOE_STEPS,
                                      layers, 0, fwd, 1, overrides)
    for key in ("aux_loss", "moe_dropped_frac"):
        vals = res.get(key)
        if not vals or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{name} {key}: {vals}")
    res["tokens_per_s"] = tokens / (statistics.mean(res["step_ms"]) / 1e3)
    print(f"{name}: {res['tokens_per_s']:.0f} tokens/s, p50 "
          f"{res['p50_step_ms']:.2f} ms, peak {res['peak_mem_gb']:.2f} GB; "
          f"aux_loss {res['aux_loss']}; moe_dropped_frac "
          f"{res['moe_dropped_frac']}", flush=True)
    return res, launched


def moe_benchmark(torch, cli, models, load_config, apply_overrides):
    """Phase 26: ``cli benchmark`` on llama_moe as shipped, its record
    printed with the flash kernels' FLOPs and the one-hot einsums' share
    of the counted FLOPs beside the MFU."""
    config = LLAMA_MOE
    out = flash_benchmarks(torch, cli, models, load_config, apply_overrides,
                           (("llama_moe", config),))
    rec = out["llama_moe"]
    onehot = moe_onehot_flops(models, load_config, apply_overrides, config)
    counted = rec["model_tflops_per_step"] * 1e12
    if not math.isclose(rec["onehot_tflops_per_step"] * 1e12, onehot,
                        rel_tol=1e-9):
        raise AssertionError(f"one-hot FLOPs {rec['onehot_tflops_per_step']}"
                             f" != {onehot / 1e12}")
    print(f"llama_moe benchmark: {rec['value']:.0f} tokens/sec/chip, p50 "
          f"{rec['p50_step_ms']:.2f} ms, p90 {rec['p90_step_ms']:.2f} ms, "
          f"MFU {rec['mfu']:.4f}; the one-hot einsums' {onehot / 1e12:.2f} "
          f"TFLOP a step are {onehot / counted:.1%} of the "
          f"{counted / 1e12:.2f} TFLOP counted: MFU without them "
          f"{rec['mfu'] * (1 - onehot / counted):.4f}", flush=True)
    return out


def moe_parity(torch, cli, load_config, apply_overrides):
    """Phase 28: fp32 llama_moe at full width, batch 2 x 2048, 2 steps on
    one batch, (flash, adamw) against (xla, adamw) in lockstep: before
    each step the xla trainer takes the flash trainer's params and Adam
    state, so each step is compared from the same state. (Apart, one
    routing flip, a near-tie in a top-k choice that the two attention
    cores' last bits decide, moves every weight the token touched by about
    the learning rate under Adam, and the trajectories part.) Per step the
    losses and aux_loss within 1e-4 relative, moe_dropped_frac within one
    assignment a layer (1 / (tokens x k)), drops present, the flash route's
    losses falling; only the flash route launches kernels."""
    from distributeddeeplearning_tpu_torch import data

    routes = {"kernels": "flash", "plain": "xla"}
    trainers, states = {}, {}
    for key, impl in routes.items():
        cfg = apply_overrides(load_config(LLAMA_MOE), MOE_PARITY + [
            f"model.kwargs.attn_impl={impl}"])
        _, trainers[key], dataset = cli.build_all(cfg, "cuda")
        states[key] = trainers[key].init(cfg.train.seed)
    k = cfg.model.kwargs["num_selected"]
    one = 1 / (cfg.data.batch_size * cfg.data.seq_len * k)
    records = {key: [] for key in routes}
    launched = dict.fromkeys(routes, 0)
    for step in range(cfg.train.steps):
        a, b = states["kernels"], states["plain"]
        with torch.no_grad():
            for name, p in a.params.items():
                b.params[name].copy_(p)
            for tree in ("mu", "nu"):
                for name, t in getattr(a.opt_state, tree).items():
                    getattr(b.opt_state, tree)[name].copy_(t)
        states["plain"] = dataclasses.replace(
            b, step=a.step, opt_state=b.opt_state._replace(
                count=a.opt_state.count))
        batch = data.to_device(dataset.batch(step), "cuda")
        for key in routes:
            before = sum(all_launches().values())
            states[key], m = trainers[key].train_step(states[key], batch)
            torch.cuda.synchronize()
            launched[key] += sum(all_launches().values()) - before
            records[key].append({x: float(v) for x, v in m.items()})
    ra, rb = records["kernels"], records["plain"]
    res = {key: {x: [r[x] for r in records[key]]
                 for x in ("loss", "aux_loss", "moe_dropped_frac")}
           for key in routes}
    res.update(
        loss_max_rel_diff=rel_diff([r["loss"] for r in ra],
                                   [r["loss"] for r in rb]),
        aux_loss_max_rel_diff=rel_diff([r["aux_loss"] for r in ra],
                                       [r["aux_loss"] for r in rb]),
        dropped_max_abs_diff=max(abs(x["moe_dropped_frac"]
                                     - y["moe_dropped_frac"])
                                 for x, y in zip(ra, rb)),
        one_assignment=one, launches=launched)
    print(f"moe fp32 parity (lockstep): {json.dumps(res)}", flush=True)
    del trainers, states
    torch.cuda.empty_cache()
    if not (launched["kernels"] > 0 and launched["plain"] == 0):
        raise AssertionError(f"moe parity launches {launched}")
    for key in ("loss", "aux_loss"):
        if not res[f"{key}_max_rel_diff"] <= 1e-4:
            raise AssertionError(f"moe parity {key}: "
                                 f"{res[f'{key}_max_rel_diff']} > 1e-4")
    if not res["dropped_max_abs_diff"] <= one:
        raise AssertionError(f"moe parity dropped: "
                             f"{res['dropped_max_abs_diff']} > {one}")
    if not all(r["moe_dropped_frac"] > 0 for r in ra + rb):
        raise AssertionError("moe parity: no assignment dropped")
    losses = res["kernels"]["loss"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"moe parity: loss did not fall {losses}")
    return res


def write_byte_corpus(tmp) -> str:
    """The repository's own Markdown files as a byte corpus, written into
    ``tmp`` by the port's ``prepare_data``; the token file's path."""
    from distributeddeeplearning_tpu_torch import prepare_data

    texts = sorted(f for f in os.listdir(ROOT) if f.endswith(".md"))
    src, tok = os.path.join(tmp, "corpus.txt"), os.path.join(tmp,
                                                             "corpus.tok")
    with open(src, "wb") as out:
        for name in texts:
            with open(os.path.join(ROOT, name), "rb") as f:
                out.write(f.read())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        prepare_data.main(["--input", src, "--output", tok, "--tokenizer",
                           "byte"])
    print(buf.getvalue().strip(), f"from {len(texts)} files", flush=True)
    return tok


def token_file_train(torch, cli, models, load_config, apply_overrides):
    """Phase 29: a byte corpus of the repository's own text written by the
    port's ``prepare_data``; ``cli train`` on ``configs/gpt2_owt_file.py``
    at full width for 4 steps straight, then 2 steps with a checkpoint and
    a resume to 4: the resumed losses equal the straight run's bit for bit;
    per step flash 12 launches each, fused_adamw one a group."""
    import tempfile

    from distributeddeeplearning_tpu_torch import data_text

    layers, groups, _, _ = model_shape(models, load_config,
                                       apply_overrides, OWT_FILE)
    cfg = load_config(OWT_FILE)
    with tempfile.TemporaryDirectory() as tmp:
        tok = write_byte_corpus(tmp)
        n_tokens = len(data_text.read_token_file(tok)[0])
        rows = cfg.data.batch_size * cfg.data.seq_len
        if n_tokens // cfg.data.seq_len < cfg.data.batch_size:
            raise AssertionError(f"corpus of {n_tokens} tokens holds no "
                                 f"batch of {rows}")
        base = [f"data.path={tok}"]
        runs = {}
        for key, steps, extra in (
                ("straight", OWT_FILE_STEPS, ()),
                ("first", 2, ("train.save_every=2",
                              f"train.checkpoint_dir={tmp}/ckpt")),
                ("resumed", OWT_FILE_STEPS, (
                    "train.save_every=2",
                    f"train.checkpoint_dir={tmp}/ckpt"))):
            if key == "straight":
                extra = (f"train.checkpoint_dir={tmp}/none",)
            done = 2 if key == "resumed" else 0
            res, launched = flash_model_train(
                torch, cli, f"gpt2_owt_file {key}", OWT_FILE, steps, layers,
                groups, 1, 1, base + list(extra), start=done)
            runs[key] = (res, launched)
    straight = runs["straight"][0]["losses"]
    resumed = runs["first"][0]["losses"] + runs["resumed"][0]["losses"]
    print(f"gpt2_owt_file: straight {straight}, resumed {resumed}, "
          f"bit-equal {straight == resumed}; {n_tokens:,} tokens, "
          f"{n_tokens // cfg.data.seq_len} rows of {cfg.data.seq_len}",
          flush=True)
    if straight != resumed:
        raise AssertionError("token-file resume is not step-exact")
    return runs


BF16_FULL = ["train.precision.policy=bf16_full", "optim.name=adamw"]
BF16_FULL_STEPS = 4


def bf16_full_train(torch, cli, models, load_config, apply_overrides):
    """Phase 30: ``cli train`` on gpt2_owt as shipped but for the
    ``bf16_full`` policy with ``optim.name=adamw`` (the reference fences
    bf16 moments to the plain AdamW), 4 steps: each flash kernel 12 a
    step, fused_adamw never (``LowPrecisionAdamW`` is plain torch); the
    moments are bf16, so the optimizer state is 2 x 2 bytes a parameter,
    half the plain fp32 AdamW's 2 x 4; p50 and peak memory."""
    layers, _, n, _ = model_shape(models, load_config, apply_overrides,
                                  CONFIG)
    res, launched = flash_model_train(torch, cli, "gpt2 bf16_full", CONFIG,
                                      BF16_FULL_STEPS, layers, 0, 1, 1,
                                      BF16_FULL)
    fp32_bytes = 2 * 4 * n
    print(f"bf16_full: optimizer state {res['opt_state_bytes']:,} bytes "
          f"against fp32 AdamW's {fp32_bytes:,} "
          f"({res['opt_state_bytes'] / fp32_bytes:.3f}); p50 "
          f"{res['p50_step_ms']:.2f} ms, peak {res['peak_mem_gb']:.2f} GB",
          flush=True)
    if res["opt_state_bytes"] != 2 * 2 * n:
        raise AssertionError(f"bf16_full moments: {res['opt_state_bytes']} "
                             f"bytes, not bf16's {2 * 2 * n}")
    return res, launched


HEALTH_STEPS, FAULT_STEP = 6, 3
HEALTH = ["health.enabled=true", f"train.fault_injection=nan:{FAULT_STEP}"]


def skip_is_exact(torch, cli, load_config, apply_overrides):
    """Phase 31's exactness check, on the Trainer that ``cli train`` runs:
    the state after the step whose gradients the fault poisons equals the
    state before it, bit for bit (fp32 masters, both moments, the
    optimizer's count), the step counter advanced; that step runs the
    forward and backward (flash) and launches no fused_adamw, since the
    guard decides on the host before the update."""
    from distributeddeeplearning_tpu_torch import data

    cfg = apply_overrides(load_config(CONFIG), HEALTH)
    _, trainer, dataset = cli.build_all(cfg, "cuda",
                                        fault_nan_step=FAULT_STEP)
    state = trainer.init(cfg.train.seed)
    batches = data.prefetch(data.sharded_batches(
        dataset.iter_from(0), trainer.mesh), "cuda")
    for _ in range(FAULT_STEP):
        state, m = trainer.train_step(state, next(batches))
    before = {
        "params": {k: p.detach().clone() for k, p in state.params.items()},
        "mu": {k: v.clone() for k, v in state.opt_state.mu.items()},
        "nu": {k: v.clone() for k, v in state.opt_state.nu.items()}}
    count, step = state.opt_state.count, state.step
    launched0 = all_launches()
    state, m = trainer.train_step(state, next(batches))
    torch.cuda.synchronize()
    delta = {k: v - launched0[k] for k, v in all_launches().items()}
    adamw = delta["fused_adamw"]
    flash = delta["flash_fwd"] + delta["flash_dq"] + delta["flash_dkv"]
    after = {"params": state.params, "mu": state.opt_state.mu,
             "nu": state.opt_state.nu}
    equal = all(torch.equal(after[t][k], before[t][k])
                for t in before for k in before[t])
    res = {"skipped": int(m["skipped"]), "anomalies": int(m["anomalies"]),
           "bit_equal": equal, "count": [count, state.opt_state.count],
           "step": [step, state.step], "fused_adamw_on_skip": adamw,
           "flash_on_skip": flash}
    print(f"skipped step {FAULT_STEP} (pre-step counter): {json.dumps(res)}",
          flush=True)
    if not (res["skipped"] == res["anomalies"] == 1 and equal
            and count == state.opt_state.count and state.step == step + 1
            and adamw == 0 and flash > 0):
        raise AssertionError(f"skip-update is not exact: {res}")
    del trainer, state, before
    torch.cuda.empty_cache()
    return res


def rollback_run(torch, cli, layers, groups):
    """Phase 31's rollback: ``cli train`` to 4 steps with the guard,
    ``max_consecutive_anomalies=1``, a checkpoint every 2 steps and the
    fault at step 2: the streak is read one logging interval late (at step
    4's dispatch), the run restarts from step 2 with the fault disarmed
    (one ``rollback_restart``) and ends at step 4. 6 steps run (4, then 2),
    5 of them update."""
    import tempfile

    reset_all_launches()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["train", "--config", CONFIG, "--device", "cuda"]
        for o in ("train.steps=4", "train.log_every=1",
                  "health.enabled=true", "train.fault_injection=nan:2",
                  "health.max_consecutive_anomalies=1",
                  "train.save_every=2", f"train.checkpoint_dir={tmp}/ckpt"):
            argv += ["--override", o]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    text = buf.getvalue()
    recs = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    events = [r["event"] for r in recs if "event" in r]
    steps = [r["step"] for r in recs if "event" not in r]
    skipped = [int(r["skipped"]) for r in recs if "event" not in r]
    launched = all_launches()
    want = {k: 0 for k in launched}
    want.update(flash_fwd=6 * layers, flash_dq=6 * layers,
                flash_dkv=6 * layers, fused_adamw=5 * groups)
    res = {"rc": rc, "events": events, "steps": steps, "skipped": skipped,
           "resumed_from_2": "resumed from step 2" in text,
           "launches": launched}
    print(f"rollback: {json.dumps(res)}", flush=True)
    if not (rc == 0 and events == ["health_rollback", "rollback_restart"]
            and steps == [1, 2, 3, 3, 4] and skipped == [0, 0, 1, 0, 0]
            and res["resumed_from_2"] and launched == want):
        raise AssertionError(f"rollback run: {res}, launches expected {want}")
    return res, launched


def health_guard(torch, cli, models, load_config, apply_overrides):
    """Phase 31: ``cli train`` on gpt2_owt as shipped (adamw_fused, ZeRO-1
    a no-op at dp = 1) for 6 steps with the guard off, then on with the
    fault ``nan:3``: the step of pre-step counter 3 (logged as step 4)
    reports skipped 1 and anomalies 1, and launches no fused_adamw (2
    launches a step on the other 5); p50 with the guard on (one host read
    of the loss and gradient norm a step) and off. Then the exactness
    check and the rollback."""
    layers, groups, _, _ = model_shape(models, load_config, apply_overrides,
                                       CONFIG)
    off, off_launched = flash_model_train(
        torch, cli, "gpt2 guard off", CONFIG, HEALTH_STEPS, layers, groups,
        1, 1, ["health.enabled=false"])
    on, on_launched = flash_model_train(
        torch, cli, "gpt2 guard on", CONFIG, HEALTH_STEPS, layers, groups,
        1, 1, HEALTH, skipped=1)
    want = [int(i == FAULT_STEP) for i in range(HEALTH_STEPS)]
    anomalies = [int(i >= FAULT_STEP) for i in range(HEALTH_STEPS)]
    if ([int(x) for x in on["skipped"]] != want
            or [int(x) for x in on["anomalies"]] != anomalies):
        raise AssertionError(f"guard records: skipped {on['skipped']}, "
                             f"anomalies {on['anomalies']}")
    print(f"health guard: p50 on {on['p50_step_ms']:.2f} ms, off "
          f"{off['p50_step_ms']:.2f} ms (the host read a step: "
          f"{on['p50_step_ms'] - off['p50_step_ms']:+.2f} ms)", flush=True)
    exact = skip_is_exact(torch, cli, load_config, apply_overrides)
    rollback, rb_launched = rollback_run(torch, cli, layers, groups)
    launched = {k: off_launched[k] + on_launched[k] + rb_launched[k]
                for k in off_launched}
    return {"p50_on_ms": on["p50_step_ms"], "p50_off_ms": off["p50_step_ms"],
            "exact": exact, "rollback": rollback}, launched


GEN_PROMPTS = ["The H100 decodes from a contiguous KV cache", "generate"]
GEN_NEW = 32
GEN_STEPS = 4
# Timed runs of each stage: one run of the 31 decode steps lasts about
# half a second, so the median of 3 moved with the host's jitter.
GEN_REPS = 20


def generate_full_width(torch, cli, models, load_config, apply_overrides):
    """Phase 32: ``cli train`` on gpt2_owt_file at full width with the
    byte vocabulary (``model.kwargs.vocab_size=256``, as the reference's
    own test overrides it) on the repository's byte corpus, 4 steps and a
    save; then ``cli generate --bench`` from that checkpoint with two
    uneven prompts and 32 new tokens (bf16, the cache attention in plain
    torch), ``GEN_REPS`` timed runs: its record, decode and prefill
    rates."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        tok = write_byte_corpus(tmp)
        base = [f"data.path={tok}", "model.kwargs.vocab_size=256",
                f"train.checkpoint_dir={tmp}/ckpt",
                f"train.save_every={GEN_STEPS}"]
        layers, groups, _, _ = model_shape(models, load_config,
                                           apply_overrides, OWT_FILE, base)
        res, launched = flash_model_train(
            torch, cli, "gpt2_owt_file byte vocab", OWT_FILE, GEN_STEPS,
            layers, groups, 1, 1, base)
        argv = ["generate", "--config", OWT_FILE, "--device", "cuda"]
        for o in base:
            argv += ["--override", o]
        for p in GEN_PROMPTS:
            argv += ["--prompt", p]
        argv += ["--max-new-tokens", str(GEN_NEW), "--bench", "--reps",
                 str(GEN_REPS)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    rec = json.loads(lines[-1])
    print(f"cli generate: {json.dumps(rec)}", flush=True)
    if not (rc == 0 and lines[0] == f"generating from checkpoint at step "
            f"{GEN_STEPS}" and rec["step"] == GEN_STEPS
            and len(rec["results"]) == len(GEN_PROMPTS)
            and rec["reps"] == GEN_REPS):
        raise AssertionError(f"cli generate: rc {rc}, {lines[:2]}")
    for key in ("decode_tokens_per_sec", "prefill_tokens_per_sec",
                "decode_time_s", "e2e_tokens_per_sec"):
        if not (isinstance(rec.get(key), float) and rec[key] > 0):
            raise AssertionError(f"cli generate record: {key}={rec.get(key)}")
    if rec["generated_tokens"] != len(GEN_PROMPTS) * (GEN_NEW - 1):
        raise AssertionError(f"cli generate: {rec['generated_tokens']} "
                             "generated tokens")
    return rec, launched


GEN_PARITY_NEW = 32
GEN_PARITY_LENS = (61, 37)


def _oracle_row(torch, model, prompt, new):
    """No-cache greedy continuation of one row: a full forward over the
    growing prefix a token. Returns (tokens, the top-2 logit gap at each
    pick)."""
    from distributeddeeplearning_tpu_torch.generate import _logits_of

    buf = torch.tensor([prompt], device="cuda")
    gaps = []
    with torch.no_grad():
        for _ in range(new):
            logits = _logits_of(model(buf))[:, -1].float()
            top2 = logits.topk(2, dim=-1).values[0]
            gaps.append(float(top2[0] - top2[1]))
            buf = torch.cat([buf, logits.argmax(-1)[:, None]], dim=1)
    return buf[0, len(prompt):].tolist(), gaps


def generation_parity(torch, cli, load_config, apply_overrides, pa,
                      ServingEngine, ServingConfig, Request):
    """Phase 33: fp32 at full width (xla attention core for the oracle;
    TF32 off). Greedy tokens of ``generate`` on an uneven, left-padded
    batch of two rows must equal, exactly, each row's no-cache oracle (a
    full forward over the growing prefix, the row alone) on GPT-2 124M,
    Llama-300M and llama_moe 8x300m; for GPT-2 and Llama also the serving
    engine's on the same weights and prompts, whose decode steps run
    ``paged_decode`` (launches = decode calls x layers). llama_moe decodes
    through the one-token prefill; its capacity factor is raised to
    experts / selected (4.0), so the oracle's batched routing of a whole
    row has a slot for every token and drops none, as a one-token decode
    step never does (at the shipped 1.25 the oracle would drop tokens
    that the decode keeps, a different function)."""
    import numpy as np

    from distributeddeeplearning_tpu_torch.generate import (
        generate,
        pad_prompts,
    )

    out, paged = {}, {"paged_decode": 0}
    for name, config, extra in (
            ("gpt2", CONFIG, ()), ("llama", LLAMA, ()),
            ("llama_moe", LLAMA_MOE, ("model.kwargs.capacity_factor=4.0",))):
        cfg = apply_overrides(load_config(config), [
            "model.kwargs.dtype=float32", "model.kwargs.attn_impl=xla",
            *extra])
        torch.cuda.empty_cache()
        model = cli.build_model(cfg, "cuda")
        rng = np.random.default_rng(0)
        prompts = [list(map(int, rng.integers(0, model.vocab_size, n)))
                   for n in GEN_PARITY_LENS]
        padded, lens = pad_prompts(prompts)
        P = padded.shape[1]
        got = generate(model, padded, max_new_tokens=GEN_PARITY_NEW,
                       prompt_lens=lens)[:, P:].tolist()
        res = {"rows": len(prompts), "new_tokens": GEN_PARITY_NEW}
        for i, p in enumerate(prompts):
            want, gaps = _oracle_row(torch, model, p, GEN_PARITY_NEW)
            if got[i] != want:
                t = next(j for j, (a, b) in enumerate(zip(got[i], want))
                         if a != b)
                raise AssertionError(
                    f"{name} row {i} token {t}: generate {got[i][t]}, "
                    f"oracle {want[t]}, top-2 gap {gaps[t]}")
            res[f"min_top2_gap_row{i}"] = min(gaps)
        if name != "llama_moe":
            eng = ServingEngine(model, ServingConfig(
                slots=2, block_size=16, max_seq_len=128,
                prompt_buckets=(64,), hbm_budget_mb=256,
                attn_kernel="pallas"), seed=0, device="cuda")
            eng.warmup()
            before = sum(pa.LAUNCHES.values())
            for p in prompts:
                eng.submit(Request(prompt=p, max_new_tokens=GEN_PARITY_NEW))
            served = {tuple(st.request.prompt): st.generated
                      for st in eng.run()}
            torch.cuda.synchronize()
            launched = sum(pa.LAUNCHES.values()) - before
            if launched != eng.calls["decode"] * model.num_layers:
                raise AssertionError(f"{name} engine: {launched} paged "
                                     "launches")
            for i, p in enumerate(prompts):
                if list(served[tuple(p)]) != got[i]:
                    raise AssertionError(f"{name} row {i}: engine "
                                         f"{served[tuple(p)]} != generate "
                                         f"{got[i]}")
            res["engine_paged_launches"] = launched
            paged["paged_decode"] += launched
        out[name] = res
        print(f"generation parity {name} (fp32): generate == oracle"
              f"{' == engine' if name != 'llama_moe' else ''}, "
              f"{json.dumps(res)}", flush=True)
        del model
    return out, paged


# ---------------------------------------------------------------------------
# 34. / 35. pipeline parallelism (no attention kernel in the stages)
# ---------------------------------------------------------------------------

GPT2_PP = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                       "gpt2_pp.py")
BERT_PP = os.path.join(ROOT, "distributeddeeplearning_tpu_torch", "configs",
                       "bert_pp.py")
PP_RANKS, PP_STEPS = 4, 2
# Phase 34's batch, cut for time from the config's 32 x 1024: one row a
# microbatch.
PP_BATCH = 8
# Phase 35's fp32 pairs: gpt2_pp at 8 x 1024 (adamw_fused on the ranks),
# bert_pp at 8 x 512 (one row a microbatch; cut for time from 16), on one
# repeated batch at a constant lr.
PP_PARITY = ["model.kwargs.dtype=float32", "data.n_distinct=1",
             "optim.schedule=constant", "optim.warmup_steps=0"]
GPT2_PP_PARITY = PP_PARITY + ["data.batch_size=8"]
BERT_PP_PARITY = PP_PARITY + ["data.batch_size=8", "train.steps=3"]


def pp_cli_job(tmp):
    """Phase 34's job (the first of the four spawned ranks'): ``cli
    train`` on ``configs/gpt2_pp.py`` as shipped for 2 steps, an
    evaluation and a checkpoint at step 2. Returns (the job, its
    checkpoint directory)."""
    ck = os.path.join(tmp, "pp_cli_ckpt")
    return cli_job([f"train.steps={PP_STEPS}", f"data.batch_size={PP_BATCH}",
                    "train.log_every=1",
                    "train.eval_every=2", "train.eval_batches=1",
                    "train.save_every=2", f"train.checkpoint_dir={ck}",
                    f"train.log_dir={tmp}/pp_logs"], config=GPT2_PP), ck


def pp_cli_train(torch, ranks, ck):
    """Phase 34: ``cli train`` with 4 ranks on ``configs/gpt2_pp.py`` as
    shipped (pp=4, dp=1, 1f1b_interleaved, M=8, bf16, 8 x 1024, vocab
    50304) for 2 steps, an evaluation and a checkpoint at step 2 (the job
    of :func:`pp_cli_job`): every loss finite and equal on the 4 ranks,
    each rank 14 = M + 2(S-1) ticks a step and M + S - 1 = 11 in the
    evaluation; per rank its peak memory, the seconds inside the
    transport's calls each step (waiting for the neighbours included) and
    the megabytes it sent a step."""
    text, recs, end = cli_result(ranks)
    on_disk = sorted(os.listdir(ck))
    print("\n".join(text))
    losses = [r["loss"] for r in recs if "loss" in r]
    evals = [r["step"] for r in recs if "eval_loss" in r]
    ranks = end["ranks"]
    if (len(losses) != PP_STEPS or not all(map(math.isfinite, losses))
            or evals != [2] or on_disk != ["2"]):
        raise AssertionError(f"pp train: losses {losses}, evals at {evals}, "
                             f"checkpoints {on_disk}")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"pp train: the ranks' losses differ "
                             f"{[r['losses'] for r in ranks]}")
    S, M = PP_RANKS, 8
    per_rank = []
    for i, r in enumerate(ranks):
        t = r["pipeline"]
        if (t["train_ticks"] != PP_STEPS * (M + 2 * (S - 1))
                or t["eval_ticks"] != M + S - 1):
            raise AssertionError(f"pp train rank {i}: ticks {t}")
        per_rank.append({
            "rank": i, "peak_mem_gb": r["peak_mem_gb"],
            "transport_s_by_step": t["transport_s_by_step"],
            "transport_mb_sent_per_step":
                t["train_transport_bytes"] / PP_STEPS / 1e6,
            "ticks_per_step": t["train_ticks"] // PP_STEPS,
            "eval_ticks": t["eval_ticks"], "max_stash": t["max_stash"]})
    res = {"backend": end["backend"], "ranks_on_one_card": PP_RANKS,
           "losses": losses, "step_ms": [x * 1e3 for x in end["step_s"]],
           "per_rank": per_rank, "launches": ranks[0]["launches"]}
    print(f"pp train: {json.dumps(res)} (four ranks share the one card over "
          "gloo: the step time is a path, not a speed)", flush=True)
    return res


def pp_jobs(tmp):
    """Phase 35's jobs for 4 spawned ranks: bert_pp as shipped for 2
    steps; fp32 gpt2_pp with adamw_fused to step 2 with a save, then on to
    4 from it; fp32 bert_pp for 3 steps."""
    ck = os.path.join(tmp, "gpt2_pp_ckpt")
    hashes = {"hashes": True}
    fused = GPT2_PP_PARITY + ["optim.name=adamw_fused"]
    return [
        (["train.steps=2"], None, 0, BERT_PP, hashes),
        (fused + ["train.steps=2"], ck, 2, GPT2_PP, hashes),
        (fused + ["train.steps=4"], ck, 0, GPT2_PP, hashes),
        (BERT_PP_PARITY, None, 0, BERT_PP, hashes),
    ], ck


def pp_twin(torch, cli, load_config, apply_overrides, config, overrides):
    """A pp=1 run of ``config`` in this process (the plain AdamW): its
    losses and the trainer's state."""
    from distributeddeeplearning_tpu_torch import data
    from distributeddeeplearning_tpu_torch.train import fit

    cfg = apply_overrides(load_config(config), overrides + [
        "mesh.pp=1", "optim.name=adamw"])
    _, trainer, dataset = cli.build_all(cfg, "cuda")
    state = trainer.init(cfg.train.seed)
    state, hist = fit(trainer, state, data.prefetch(data.sharded_batches(
        dataset.iter_from(0), None), "cuda"), steps=cfg.train.steps,
        log_every=1, log_fn=lambda m: None)
    torch.cuda.synchronize()
    return [r["loss"] for r in hist], trainer, state


def four_rank_group(torch, parity, tmp):
    """Phase 34: one spawn of four ranks sharing the card over gloo runs,
    in turn, ``cli train`` on gpt2_pp (phase 34) and on gpt2_owt at tp2 x
    fsdp2 with SP (phase 36), as ``torchrun`` would run them, then the fit
    jobs of phases 35 (:func:`pp_jobs`), 37 (:func:`tp_jobs`, set up by
    phase 8's ``parity``), 38 (:func:`ep_jobs`) and 39
    (:func:`shard_jobs`), 40 (:func:`heads_cp_jobs`), 41
    (:func:`composition_jobs`) and 42 (:func:`dp_sync_jobs`). Returns each
    phase's results and checkpoint directories."""
    pp_cli, pp_ck = pp_cli_job(tmp)
    tp_cli, tp_cli_ck = tp_cli_job(tmp)
    groups = {"pp": pp_jobs(tmp), "tp": tp_jobs(tmp, parity),
              "ep": ep_jobs(tmp), "shard": shard_jobs(tmp),
              "heads_cp": heads_cp_jobs(tmp, parity),
              "compositions": composition_jobs(tmp, parity),
              "dp_sync": dp_sync_jobs(tmp, parity)}
    jobs = [pp_cli, tp_cli] + [j for js, _ in groups.values() for j in js]
    out = spawn_ranks(torch, jobs, tmp, nranks=PP_RANKS)
    res = {"pp_cli": (out[0], pp_ck), "tp_cli": (out[1], tp_cli_ck)}
    at = 2
    for key, (js, ck) in groups.items():
        res[key] = (out[at:at + len(js)], ck)
        at += len(js)
    return res


def pp_parity(torch, cli, load_config, apply_overrides, results, ck):
    """Phase 35: the results of :func:`pp_jobs` (jobs of phase 34's
    ranks): the shipped bert_pp losses finite and equal on every rank; the
    fp32 gpt2_pp (4 steps, fused_adamw over each rank's leaves: launches
    = steps x its kernel groups) and bert_pp (3 steps) losses within 1e-4
    relative of their pp=1 twins here (plain AdamW) and falling; the
    step-2 checkpoint ``ck``, restored here at pp=1 and cut to each rank's
    rows and table block, equals every rank's step-2 params bit for bit.
    Returns (the record, fused_adamw launches on the ranks)."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )

    bert, gpt_a, gpt_b, bert32 = results
    for name, ranks in (("bert_pp", bert), ("gpt2_pp fp32", gpt_a),
                        ("gpt2_pp fp32 resumed", gpt_b),
                        ("bert_pp fp32", bert32)):
        ls = [r["losses"] for r in ranks]
        if any(x != ls[0] for x in ls) or not all(
                map(math.isfinite, ls[0])):
            raise AssertionError(f"{name}: rank losses {ls}")
    launched = 0
    for ranks in (gpt_a, gpt_b):
        for r in ranks:
            want = len(r["losses"]) * r["groups"]
            if r["launches"]["fused_adamw"] != want or want == 0:
                raise AssertionError(
                    f"pp fused_adamw launches {r['launches']} != {want}")
            launched += want
    t0 = time.perf_counter()
    twin_gpt, trainer, state = pp_twin(
        torch, cli, load_config, apply_overrides, GPT2_PP,
        GPT2_PP_PARITY + ["train.steps=4"])
    with CheckpointManager(ck) as mgr:
        state, _ = mgr.restore(state, step=2)
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    restored = {k: param_digest(p) for k, p in state.params.items()}
    rows = state.stage_rows
    cfg = apply_overrides(load_config(GPT2_PP), GPT2_PP_PARITY)
    mismatched = []
    for r in gpt_a:
        s = r["coords"]["pp"]
        # A rank's layout: its stage's rows, its block of the tables
        # (JAX's vocab_pp, at pp alone too).
        tables = models.get_model(cfg.model.name, **cfg.model.kwargs,
                                  mesh=Mesh({"pp": PP_RANKS}, rank=s),
                                  device="meta").shards
        for k, h in r["hashes"].items():
            p = state.params[k]
            if k in rows.names:
                want = param_digest(p[s:s + 1])
            elif "pp" in tables.dims.get(k, {}):
                want = param_digest(tables.take_leaf(k, p))
            else:
                want = restored[k]
            if h != want:
                mismatched.append((s, k))
    del trainer, state
    torch.cuda.empty_cache()
    twin_bert, trainer, state = pp_twin(
        torch, cli, load_config, apply_overrides, BERT_PP,
        BERT_PP_PARITY)
    del trainer, state
    torch.cuda.empty_cache()
    twin_s = time.perf_counter() - t0
    pp_gpt = gpt_a[0]["losses"] + gpt_b[0]["losses"]
    rel_gpt = max(abs(a - b) / abs(b) for a, b in zip(pp_gpt, twin_gpt))
    rel_bert = max(abs(a - b) / abs(b)
                   for a, b in zip(bert32[0]["losses"], twin_bert))
    res = {"bert_pp_losses": bert[0]["losses"],
           "bert_pp_peak_mem_gb": [r["peak_mem_gb"] for r in bert],
           "bert_pp_per_rank_pipeline": [r["pipeline"] for r in bert],
           "gpt2_pp_fp32": {"pp4": pp_gpt, "pp1": twin_gpt,
                            "max_rel_diff": rel_gpt},
           "bert_pp_fp32": {"pp4": bert32[0]["losses"], "pp1": twin_bert,
                            "max_rel_diff": rel_bert},
           "restore_at_pp1_mismatched_leaves": len(mismatched),
           "checkpoint_saves": gpt_a[0]["timings"],
           "fused_adamw_launches": launched, "twins_s": twin_s}
    print(f"pp parity: {json.dumps(res)}", flush=True)
    if mismatched:
        raise AssertionError(f"pp restore at pp=1: {mismatched[:4]} differ")
    for name, a, b, rel in (("gpt2_pp", pp_gpt, twin_gpt, rel_gpt),
                            ("bert_pp", bert32[0]["losses"], twin_bert,
                             rel_bert)):
        if not rel <= 1e-4:
            raise AssertionError(f"{name} fp32 pp=4 vs pp=1: rel {rel}")
        if not (a[-1] < a[0] and b[-1] < b[0]):
            raise AssertionError(f"{name} fp32: loss did not fall {a} {b}")
    return res, launched


# ---------------------------------------------------------------------------
# 36. - 37. tensor parallelism with sequence parallelism, and FSDP
# ---------------------------------------------------------------------------

TP_RANKS, TP_STEPS = 4, 2
# Phase 36: gpt2_owt as shipped (bf16, flash, adamw_fused) at tp2 x fsdp2
# with sequence parallelism, the batch cut for time to 4 x 1024 (2 rows a
# rank over dp x fsdp = 2, 6 heads a rank).
TP_MESH = ["mesh.dp=1", "mesh.fsdp=2", "mesh.tp=2",
           "train.sequence_parallel=true"]
# Phase 37's Llama-300M jobs at dp2 x tp2 with ZeRO-1 (the config's
# zero1=True): the shipped bf16 run with the batch cut for time to 2 x
# 2048 (1 row a rank, 8 heads), and the fp32 pair of phase 23.
LLAMA_TP = ["mesh.dp=2", "mesh.tp=2"]


def tp_cli_job(tmp):
    """Phase 36's job (the second of the four spawned ranks'): ``cli
    train`` on ``configs/gpt2_owt.py`` at tp2 x fsdp2 with SP. Returns
    (the job, its checkpoint directory)."""
    ck = os.path.join(tmp, "tp_cli_ckpt")
    return cli_job(TP_MESH + [
        "data.batch_size=4", f"train.steps={TP_STEPS}", "train.log_every=1",
        "train.eval_every=2", "train.eval_batches=1", "train.save_every=2",
        f"train.checkpoint_dir={ck}", f"train.log_dir={tmp}/tp_logs"]), ck


def tp_cli_train(torch, models, load_config, apply_overrides, ranks, ck):
    """Phase 36: ``cli train`` with 4 ranks on ``configs/gpt2_owt.py`` at
    dp=1 x fsdp=2 x tp=2 with sequence parallelism (bf16, flash,
    adamw_fused, batch 4 x 1024) for 2 steps, an evaluation and a
    checkpoint at step 2 (the job of :func:`tp_cli_job`): every loss
    finite and equal on the 4 ranks; per rank each flash kernel 12 x steps
    launches (flash_fwd 12 more for the evaluation) at [2 rows x 6 heads,
    1024, 64], fused_adamw 2 x steps over the rank's blocks; its param
    (and gradient) and moment bytes against the whole 124M's, the sharded
    fractions, peak memory and the transport's seconds a step. The
    checkpoint holds the one-rank layout. Returns (the record, each
    rank's launches)."""
    cfg = apply_overrides(load_config(CONFIG), TP_MESH)
    whole = {k: tuple(p.shape) for k, p in models.get_model(
        cfg.model.name, **cfg.model.kwargs, device="meta").named_parameters()}
    n_params = sum(math.prod(v) for v in whole.values())
    layers = sum(k.endswith("attn.query.kernel") for k in whole)
    text, recs, end = cli_result(ranks)
    on_disk = sorted(os.listdir(ck))
    host = torch.load(os.path.join(ck, "2", "state.pt"), mmap=True,
                      weights_only=True)
    saved = {t: {k: tuple(v.shape) for k, v in host[t].items()}
             for t in ("params", "mu", "nu")}
    del host
    print("\n".join(text))
    losses = [r["loss"] for r in recs if "loss" in r]
    evals = [r["step"] for r in recs if "eval_loss" in r]
    ranks = end["ranks"]
    if (len(losses) != TP_STEPS or not all(map(math.isfinite, losses))
            or evals != [2] or on_disk != ["2"]):
        raise AssertionError(f"tp train: losses {losses}, evals at {evals}, "
                             f"checkpoints {on_disk}")
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise AssertionError(f"tp train: the ranks' losses differ "
                             f"{[r['losses'] for r in ranks]}")
    if any(v != whole for v in saved.values()):
        raise AssertionError("tp train: the checkpoint is not in the "
                             "one-rank layout")
    steps = layers * TP_STEPS
    want = {"flash_fwd": steps + layers, "flash_dq": steps,
            "flash_dkv": steps, "fused_adamw": 2 * TP_STEPS,
            "ring_step": 0, "ring_dq": 0, "ring_dkv": 0}
    shape = [[2 * 6, 1024, 64]]
    per_rank = []
    for i, r in enumerate(ranks):
        sh = r["shards"]
        shapes = {k: [list(x) for x in v] for k, v in r["flash_shapes"].items()}
        if r["launches"] != want or any(v != shape for v in shapes.values()):
            raise AssertionError(f"tp train rank {i}: launches {r['launches']}"
                                 f" != {want}, shapes {shapes} != {shape}")
        if not (sh["sharded_fraction"]["tp"] > 0.5
                and sh["sharded_fraction"]["fsdp"] > 0.5):
            raise AssertionError(f"tp train rank {i}: {sh}")
        if r["opt_state_bytes"] != 2 * sh["param_bytes"]:
            raise AssertionError(f"tp train rank {i}: moments "
                                 f"{r['opt_state_bytes']} != 2 x params")
        per_rank.append({
            "rank": i, "param_bytes": sh["param_bytes"],
            "grad_bytes": sh["param_bytes"],
            "moment_bytes": r["opt_state_bytes"],
            "whole_param_bytes": sh["whole_param_bytes"],
            "param_share": sh["param_bytes"] / sh["whole_param_bytes"],
            "sharded_fraction": {a: sh["sharded_fraction"][a]
                                 for a in ("tp", "fsdp")},
            "peak_mem_gb": r["peak_mem_gb"],
            "transport_s_by_step": sh["transport_s_by_step"],
            "launches": r["launches"], "flash_shape": shape[0]})
    if sh["whole_param_bytes"] != 4 * n_params:
        raise AssertionError(f"tp train: whole bytes {sh['whole_param_bytes']}"
                             f" != 4 x {n_params}")
    res = {"backend": end["backend"], "ranks_on_one_card": TP_RANKS,
           "losses": losses, "step_ms": [x * 1e3 for x in end["step_s"]],
           "per_rank": per_rank}
    print(f"tp train: {json.dumps(res)} (four ranks share the one card over "
          "gloo: the step time is a path, not a speed)", flush=True)
    return res, [r["launches"] for r in ranks]


def tp_jobs(tmp, parity):
    """Phase 37's jobs, run in phase 35's four spawned ranks: fp32 GPT-2
    124M at tp2 x fsdp2 with sequence parallelism on phase 8's overrides
    (4 x 1024, flash, adamw_fused) to step 2 with a save, then on to 4 from
    it (rank 0 gathering the whole params); Llama-300M at dp2 x tp2 with
    ZeRO-1, bf16 as shipped at 2 x 2048 (cut for time) for 2 steps, then
    the fp32 pair of phase 23 (2 x 2048; 2 of its 3 steps)."""
    ck = os.path.join(tmp, "gpt2_tp_ckpt")
    gpt = parity["overrides"] + TP_MESH
    return [
        (gpt + ["train.steps=2"], ck, 2, CONFIG, {"hashes": True}),
        (gpt + ["train.steps=4"], ck, 0, CONFIG, {"whole": True}),
        (LLAMA_TP + ["data.batch_size=2", "train.steps=2"], None, 0, LLAMA,
         {"params": False}),
        (LLAMA_TP + LLAMA_PARITY + ["model.kwargs.attn_impl=flash",
                                    "optim.name=adamw_fused",
                                    "train.steps=2"], None, 0,
         LLAMA, {"params": False}),
    ], ck


def tp_parity(torch, cli, models, load_config, apply_overrides, parity,
              llama_ref, results, ck):
    """Phase 37: the results of :func:`tp_jobs`. fp32 GPT-2 at tp2 x fsdp2
    with sequence parallelism: the 4 losses (2 straight, 2 after a restore
    at the same mesh) within 1e-4 relative of phase 8's one process and
    falling, the whole params after step 4 within ``ZERO_PARAM_LIMIT`` of
    its params; the step-2 save, restored here in one process, cut to each
    rank's blocks equals that rank's step-2 params bit for bit. Llama-300M
    at dp2 x tp2 with ZeRO-1: the shipped bf16 run's losses finite and
    equal on the ranks, each flash kernel 12 launches a step at [1 row x
    8 heads, 2048, 64], fused_adamw 2 a step over each rank's ZeRO-1
    shards; the fp32 pair's losses within 1e-4 relative of phase 23's
    kernel route. Returns (the record, the launches on these paths)."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    gpt_a, gpt_b, llama_bf16, llama32 = results
    for name, ranks in (("gpt2 tp fp32", gpt_a), ("gpt2 tp fp32 resumed",
                                                  gpt_b),
                        ("llama tp bf16", llama_bf16),
                        ("llama tp fp32", llama32)):
        ls = [r["losses"] for r in ranks]
        if any(x != ls[0] for x in ls) or not all(map(math.isfinite, ls[0])):
            raise AssertionError(f"{name}: rank losses {ls}")
    got = gpt_a[0]["losses"] + gpt_b[0]["losses"]
    want = parity["losses_kernels"]
    rel = rel_diff(got, want)
    pk = parity["params_kernels"]
    pdiff = max((gpt_b[0]["params"][k] - pk[k].cpu()).abs().max().item()
                for k in pk)
    # The step-2 save restored in one process, cut to each rank's blocks.
    cfg = apply_overrides(load_config(CONFIG), parity["overrides"])
    _, trainer, _ = cli.build_all(cfg, "cuda")
    state = trainer.init(cfg.train.seed)
    with CheckpointManager(ck) as mgr:
        state, _ = mgr.restore(state, step=2)
    restored = {k: p.detach().cpu() for k, p in state.params.items()}
    del trainer, state
    torch.cuda.empty_cache()
    tcfg = apply_overrides(cfg, TP_MESH)
    mismatched = []
    for rank, r in enumerate(gpt_a):
        mesh = Mesh({"fsdp": 2, "tp": 2}, rank=rank)
        if mesh.coords != r["coords"]:
            raise AssertionError(f"rank {rank}: coords {r['coords']}")
        layout = models.get_model(
            tcfg.model.name, **tcfg.model.kwargs, sequence_parallel=True,
            mesh=mesh, device="meta").shards
        for k, h in r["hashes"].items():
            if param_digest(layout.take_leaf(k, restored[k])) != h:
                mismatched.append((rank, k))
    layers = model_shape(models, load_config, apply_overrides, LLAMA)[0]
    bf16_want = {"flash_fwd": 2 * layers, "flash_dq": 2 * layers,
                 "flash_dkv": 2 * layers, "fused_adamw": 2 * 2,
                 "ring_step": 0, "ring_dq": 0, "ring_dkv": 0}
    bf16_shape = [(1 * 8, 2048, 64)]
    for r in llama_bf16:
        shapes = {k: [tuple(x) for x in v] for k, v in
                  r["flash_shapes"].items()}
        if r["launches"] != bf16_want or any(v != bf16_shape
                                             for v in shapes.values()):
            raise AssertionError(f"llama tp bf16: launches {r['launches']} "
                                 f"!= {bf16_want}, shapes {shapes}")
    lref = llama_ref["llama_kernels_vs_llama_plain"]["losses"][0]
    lrel = rel_diff(llama32[0]["losses"], lref)
    gpt_shapes = sorted({tuple(x) for r in gpt_a + gpt_b
                         for v in r["flash_shapes"].values() for x in v})
    res = {"gpt2_tp2_fsdp2_sp_fp32": {"losses": got, "one_process": want,
                                      "max_rel_diff": rel,
                                      "max_abs_param_diff": pdiff,
                                      "flash_shapes": gpt_shapes,
                                      "peak_mem_gb": [r["peak_mem_gb"]
                                                      for r in gpt_a]},
           "restore_in_one_process_mismatched_leaves": len(mismatched),
           "checkpoint_saves": gpt_a[0]["timings"],
           "llama_dp2_tp2_zero1_bf16": {
               "losses": llama_bf16[0]["losses"],
               "peak_mem_gb": [r["peak_mem_gb"] for r in llama_bf16],
               "opt_state_bytes": [r["opt_state_bytes"] for r in llama_bf16],
               "launches": llama_bf16[0]["launches"],
               "flash_shape": list(bf16_shape[0])},
           "llama_dp2_tp2_zero1_fp32": {"losses": llama32[0]["losses"],
                                        "one_process": lref,
                                        "max_rel_diff": lrel}}
    print(f"tp parity: {json.dumps(res)}", flush=True)
    if mismatched:
        raise AssertionError(f"tp restore in one process: {mismatched[:4]} "
                             "differ")
    if not rel <= 1e-4 or not got[-1] < got[0]:
        raise AssertionError(f"gpt2 tp fp32: losses {got} vs {want}, rel "
                             f"{rel}")
    if not pdiff <= ZERO_PARAM_LIMIT:
        raise AssertionError(f"gpt2 tp fp32: param diff {pdiff} > "
                             f"{ZERO_PARAM_LIMIT}")
    if gpt_shapes != [(2 * 6, 1024, 64)]:
        raise AssertionError(f"gpt2 tp fp32: flash shapes {gpt_shapes}")
    ls32 = llama32[0]["losses"]
    if not lrel <= 1e-4 or not ls32[-1] < ls32[0]:
        raise AssertionError(f"llama tp fp32: {llama32[0]['losses']} vs "
                             f"{lref}, rel {lrel}")
    launched = {k: sum(r["launches"][k] for job in results for r in job)
                for k in ("flash_fwd", "flash_dq", "flash_dkv",
                          "fused_adamw")}
    return res, launched


# ---------------------------------------------------------------------------
# 38. expert parallelism
# ---------------------------------------------------------------------------

EP_STEPS = 2
# (a) gpt2_moe as shipped (bf16, flash, top-2 of 8 at capacity factor
# 1.25, 6 routed blocks of 12, the plain AdamW, ZeRO-1) at dp2 x ep2, the
# batch cut for time to 2 x 1024 (1 row a dp rank, 12 heads).
GPT2_MOE_EP = ["mesh.dp=2", "mesh.ep=2", "data.batch_size=2",
               f"train.steps={EP_STEPS}", "train.eval_batches=1"]
# (b) llama_moe 8x300m as shipped at ep2 x tp2 with sequence parallelism
# (JAX's GQA composition), the batch cut for time to 2 x 2048 (8 heads a
# rank).
LLAMA_MOE_EP = ["mesh.dp=1", "mesh.ep=2", "mesh.tp=2",
                "train.sequence_parallel=true", "data.batch_size=2",
                f"train.steps={EP_STEPS}"]
# (c) fp32 gpt2_moe on one batch of 2 x 1024 at the config's lr held
# constant, adamw_fused, the shipped capacity (a fresh router drops 18-44%
# of a layer's assignments), 2 steps, against one process; at dp2 x ep2
# (ZeRO-1 over dp) and at ep2 x cp2 on ring_pallas.
EP_PARITY = ["model.kwargs.dtype=float32", "data.batch_size=2",
             "data.n_distinct=1", "optim.schedule=constant",
             "optim.warmup_steps=0", "optim.name=adamw_fused",
             "train.steps=2"]
EP_PARITY_MESHES = {
    "dp2_ep2": ["mesh.dp=2", "mesh.ep=2"],
    "ep2_cp2": ["mesh.dp=1", "mesh.ep=2", "mesh.cp=2",
                "model.kwargs.attn_impl=ring_pallas"],
}


def ep_jobs(tmp):
    """Phase 38's jobs, run in phase 34's four spawned ranks: (a) gpt2_moe
    as shipped at dp2 x ep2 for 2 steps, an evaluation and a save; (b)
    llama_moe as shipped at ep2 x tp2 with SP for 2 steps; (c) the fp32
    gpt2_moe runs of ``EP_PARITY`` at dp2 x ep2 and ep2 x cp2. Returns
    (the jobs, (a)'s checkpoint directory)."""
    ck = os.path.join(tmp, "gpt2_moe_ep_ckpt")
    return [
        (GPT2_MOE_EP, ck, EP_STEPS, GPT2_MOE, {"hashes": True, "eval": True}),
        (LLAMA_MOE_EP, None, 0, LLAMA_MOE, {"params": False}),
        *[(EP_PARITY + mesh, None, 0, GPT2_MOE, {"params": False})
          for mesh in EP_PARITY_MESHES.values()],
    ], ck


def ep_one_process(torch, cli, load_config, apply_overrides):
    """(c)'s reference: the fp32 ``EP_PARITY`` run of gpt2_moe in this
    process (flash, adamw_fused): each step's loss, aux_loss and
    moe_dropped_frac."""
    from distributeddeeplearning_tpu_torch import data
    from distributeddeeplearning_tpu_torch.train import fit

    cfg = apply_overrides(load_config(GPT2_MOE), EP_PARITY)
    _, trainer, dataset = cli.build_all(cfg, "cuda")
    state = trainer.init(cfg.train.seed)
    _, hist = fit(trainer, state, data.prefetch(dataset.iter_from(0),
                                                "cuda"),
                  steps=cfg.train.steps, log_every=1, log_fn=lambda m: None)
    torch.cuda.synchronize()
    del trainer, state
    torch.cuda.empty_cache()
    return {k: [r[k] for r in hist]
            for k in ("loss", "aux_loss", "moe_dropped_frac")}


def _same_on_ranks(name, ranks):
    ls = [r["losses"] for r in ranks]
    if any(x != ls[0] for x in ls) or not all(map(math.isfinite, ls[0])):
        raise AssertionError(f"{name}: rank losses {ls}")


def ep_parity(torch, cli, models, load_config, apply_overrides, results,
              ck):
    """Phase 38: the results of :func:`ep_jobs`.

    (a) gpt2_moe at dp2 x ep2: losses, aux_loss and moe_dropped_frac
    finite, the losses equal on the 4 ranks, drops present; per rank each
    flash kernel 12 launches a step (flash_fwd 12 more for the evaluation)
    at [1 row x 12 heads, 1024, 64], no fused_adamw (the config's plain
    AdamW); a rank's params are its 4 of the 8 experts and the rest whole
    (a share of ~0.65 of the 322.8M), its moments half that again
    (ZeRO-1); the save, restored here in one process at ep=1 and cut to
    each rank's blocks, equals every rank's params (sha256). (b) llama_moe
    at ep2 x tp2 with SP: losses finite and equal, each flash kernel 12 a
    step at [2 rows x 8 heads, 2048, 64], a rank ~0.28 of the 933.9M
    params. (c) fp32 gpt2_moe at dp2 x ep2 and ep2 x cp2 (ring_pallas)
    against one process: losses and aux_loss within 1e-4 relative each
    step, moe_dropped_frac within one assignment a layer (1 / (tokens x
    k)), drops present, the losses falling; the ring kernels launched on
    the cp ranks (12 x steps x (cp index + 1) each), fused_adamw on every
    rank. Every rank's peak memory and transport seconds a step are
    printed: four ranks share one card over gloo, so no time here is a
    speed. Returns (the record, the launches on these paths)."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    gpt, llama, *pars = results
    _same_on_ranks("gpt2_moe dp2 x ep2", gpt)
    _same_on_ranks("llama_moe ep2 x tp2", llama)
    cfg = apply_overrides(load_config(GPT2_MOE), GPT2_MOE_EP)
    layers, _, n_gpt, meta = model_shape(models, load_config,
                                         apply_overrides, GPT2_MOE)
    experts = sum(math.prod(p.shape) for k, p in meta.named_parameters()
                  if ".moe_mlp." in k)
    want = {"flash_fwd": layers * (EP_STEPS + 1),
            "flash_dq": layers * EP_STEPS, "flash_dkv": layers * EP_STEPS,
            "fused_adamw": 0, "ring_step": 0, "ring_dq": 0, "ring_dkv": 0}
    shape = [(cfg.data.batch_size // 2 * meta.num_heads, cfg.data.seq_len,
              meta.head_dim)]
    per_rank = []
    for i, r in enumerate(gpt):
        sh = r["shards"]
        share = sh["param_bytes"] / sh["whole_param_bytes"]
        shapes = {k: [tuple(x) for x in v]
                  for k, v in r["flash_shapes"].items()}
        if r["launches"] != want or any(v != shape for v in shapes.values()):
            raise AssertionError(f"gpt2_moe ep rank {i}: launches "
                                 f"{r['launches']} != {want}, shapes "
                                 f"{shapes}")
        m = r["metrics"]
        if not (all(math.isfinite(x) for x in m["aux_loss"])
                and all(0 < x < 1 for x in m["moe_dropped_frac"])
                and len(r["evals"]) == 1):
            raise AssertionError(f"gpt2_moe ep rank {i}: {m}, evals "
                                 f"{r['evals']}")
        if not (0.6 < share < 0.7 and sh["sharded_fraction"]["ep"] > 0.6):
            raise AssertionError(f"gpt2_moe ep rank {i}: {sh}")
        if not 0 <= r["opt_state_bytes"] - sh["param_bytes"] < 2 ** 20:
            raise AssertionError(f"gpt2_moe ep rank {i}: moments "
                                 f"{r['opt_state_bytes']}, params "
                                 f"{sh['param_bytes']}")
        per_rank.append({
            "rank": i, "coords": {a: r["coords"][a] for a in ("dp", "ep")},
            "param_bytes": sh["param_bytes"],
            "grad_bytes": sh["param_bytes"],
            "moment_bytes": r["opt_state_bytes"],
            "whole_param_bytes": sh["whole_param_bytes"],
            "param_share": share, "sharded_fraction": sh["sharded_fraction"],
            "peak_mem_gb": r["peak_mem_gb"], "step_s": r["step_s"],
            "transport_s_by_step": r["transport_s_by_step"],
            "aux_loss": m["aux_loss"],
            "moe_dropped_frac": m["moe_dropped_frac"],
            "eval_loss": r["evals"][0]["eval_loss"]})
    # The save, restored in one process at ep=1, cut to each rank's blocks.
    one = apply_overrides(cfg, ["mesh.dp=1", "mesh.ep=1"])
    _, trainer, _ = cli.build_all(one, "cuda")
    state = trainer.init(one.train.seed)
    with CheckpointManager(ck) as mgr:
        state, _ = mgr.restore(state, step=EP_STEPS)
    restored = {k: p.detach().cpu() for k, p in state.params.items()}
    del trainer, state
    torch.cuda.empty_cache()
    mismatched = []
    for rank, r in enumerate(gpt):
        mesh = Mesh({"dp": 2, "ep": 2}, rank=rank)
        layout = models.get_model(cfg.model.name, **cfg.model.kwargs,
                                  mesh=mesh, device="meta").shards
        for k, h in r["hashes"].items():
            if param_digest(layout.take_leaf(k, restored[k])) != h:
                mismatched.append((rank, k))
    # (b)
    lcfg = apply_overrides(load_config(LLAMA_MOE), LLAMA_MOE_EP)
    llayers, _, n_llama, lmeta = model_shape(models, load_config,
                                             apply_overrides, LLAMA_MOE)
    lwant = {k: llayers * EP_STEPS for k in ("flash_fwd", "flash_dq",
                                             "flash_dkv")}
    lshape = [(lcfg.data.batch_size * lmeta.num_heads // 2,
               lcfg.data.seq_len, lmeta.head_dim)]
    llama_ranks = []
    for i, r in enumerate(llama):
        sh = r["shards"]
        share = sh["param_bytes"] / sh["whole_param_bytes"]
        shapes = {k: [tuple(x) for x in v]
                  for k, v in r["flash_shapes"].items()}
        got = {k: r["launches"][k] for k in lwant}
        if got != lwant or any(v != lshape for v in shapes.values()):
            raise AssertionError(f"llama_moe ep rank {i}: launches {got} != "
                                 f"{lwant}, shapes {shapes}")
        if not 0.25 < share < 0.31:
            raise AssertionError(f"llama_moe ep rank {i}: {sh}")
        llama_ranks.append({
            "rank": i, "param_share": share,
            "sharded_fraction": sh["sharded_fraction"],
            "moment_bytes": r["opt_state_bytes"],
            "peak_mem_gb": r["peak_mem_gb"], "step_s": r["step_s"],
            "transport_s_by_step": r["transport_s_by_step"],
            "aux_loss": r["metrics"]["aux_loss"],
            "moe_dropped_frac": r["metrics"]["moe_dropped_frac"]})
    # (c)
    ref = ep_one_process(torch, cli, load_config, apply_overrides)
    pcfg = apply_overrides(load_config(GPT2_MOE), EP_PARITY)
    one_assignment = 1 / (pcfg.data.batch_size * pcfg.data.seq_len
                          * pcfg.model.kwargs["num_selected"])
    parity = {"one_process": ref, "one_assignment": one_assignment}
    for (name, mesh), ranks in zip(EP_PARITY_MESHES.items(), pars):
        _same_on_ranks(f"gpt2_moe fp32 {name}", ranks)
        m = ranks[0]["metrics"]
        rec = {"losses": ranks[0]["losses"], "aux_loss": m["aux_loss"],
               "moe_dropped_frac": m["moe_dropped_frac"],
               "loss_max_rel_diff": rel_diff(ranks[0]["losses"],
                                             ref["loss"]),
               "aux_loss_max_rel_diff": rel_diff(m["aux_loss"],
                                                 ref["aux_loss"]),
               "dropped_max_abs_diff": max(
                   abs(a - b) for a, b in zip(m["moe_dropped_frac"],
                                              ref["moe_dropped_frac"])),
               "launches": [r["launches"] for r in ranks],
               "peak_mem_gb": [r["peak_mem_gb"] for r in ranks]}
        parity[name] = rec
        for i, r in enumerate(ranks):
            c = r["coords"]["cp"]
            ring = {k: r["launches"][k] for k in ("ring_step", "ring_dq",
                                                   "ring_dkv")}
            steps = len(r["losses"])
            rwant = dict.fromkeys(ring, layers * steps * (c + 1)
                                  if "cp" in name else 0)
            if ring != rwant or r["launches"]["fused_adamw"] == 0:
                raise AssertionError(f"gpt2_moe fp32 {name} rank {i}: "
                                     f"launches {r['launches']}, ring "
                                     f"{rwant}")
    res = {"gpt2_moe_dp2_ep2": {"losses": gpt[0]["losses"],
                                "per_rank": per_rank,
                                "flash_shape": list(shape[0]),
                                "n_params": n_gpt, "expert_params": experts,
                                "checkpoint_saves": gpt[0]["timings"]},
           "restore_at_ep1_mismatched_leaves": len(mismatched),
           "llama_moe_ep2_tp2_sp": {"losses": llama[0]["losses"],
                                    "per_rank": llama_ranks,
                                    "flash_shape": list(lshape[0]),
                                    "n_params": n_llama},
           "fp32_parity": parity}
    print(f"ep parity: {json.dumps(res)} (four ranks share the one card "
          "over gloo: paths, not speeds)", flush=True)
    if mismatched:
        raise AssertionError(f"ep restore at ep=1: {mismatched[:4]} differ")
    for name in EP_PARITY_MESHES:
        rec = parity[name]
        if not (rec["loss_max_rel_diff"] <= 1e-4
                and rec["aux_loss_max_rel_diff"] <= 1e-4):
            raise AssertionError(f"gpt2_moe fp32 {name}: {rec}")
        if not rec["dropped_max_abs_diff"] <= one_assignment:
            raise AssertionError(f"gpt2_moe fp32 {name} dropped: {rec}")
        if not (all(x > 0 for x in rec["moe_dropped_frac"])
                and rec["losses"][-1] < rec["losses"][0]):
            raise AssertionError(f"gpt2_moe fp32 {name}: {rec}")
    launched = {k: sum(r["launches"][k] for job in results for r in job)
                for k in ("flash_fwd", "flash_dq", "flash_dkv",
                          "fused_adamw", "ring_step", "ring_dq",
                          "ring_dkv")}
    return res, launched


# ---------------------------------------------------------------------------
# 39. pp x tp and pp x fsdp; tp, SP and fsdp for ViT-L/16, BERT-base and
#     ResNet-50
# ---------------------------------------------------------------------------

# The four ranks of phase 34 as pp2 x tp2 (gpt2_pp's 12 layers in 2 stages
# of 6, 6 heads a tp rank) and as tp2 x fsdp2 with sequence parallelism.
PP_TP_MESH = ["mesh.dp=1", "mesh.pp=2", "mesh.tp=2",
              "model.kwargs.num_stages=2"]
ENC_STEPS = 2
# (a) gpt2_pp as shipped (bf16, 1F1B interleaved over 8 microbatches, the
# plain AdamW), the batch cut for time to 8 x 1024 (one row a microbatch).
GPT2_PP_TP = PP_TP_MESH + ["data.batch_size=8", f"train.steps={ENC_STEPS}",
                           "train.eval_batches=1"]
# (b) fp32 gpt2_pp at pp2 x tp2 on phase 35's batches, adamw_fused.
GPT2_PP_TP_PARITY = GPT2_PP_PARITY + PP_TP_MESH + [
    "optim.name=adamw_fused", f"train.steps={ENC_STEPS}"]
# (c) ViT-L/16 as shipped (bf16, remat full, flash, adamw_fused) and (d)
# BERT-base as shipped (4 microbatches) on ragged rows, at tp2 x fsdp2
# with SP, the batch cut for time to 4 (ViT) and 8 (BERT):
# ViT 2 images a rank, 8 heads, 197 tokens in shards of 99; BERT 1 row a
# microbatch, 6 heads.
VIT_TP = TP_MESH + ["data.batch_size=4", f"train.steps={ENC_STEPS}"]
BERT_TP = TP_MESH + ["data.batch_size=8", "data.pad_min_len=32",
                     f"train.steps={ENC_STEPS}"]
# (e) ResNet-50 as shipped (SGD, bf16) at 32 x 224², fsdp2 x tp2 (the
# convs' output channels over fsdp, the head's classes over tp); dp2 x
# fsdp2 runs in (f)'s fp32 pair (a bf16 run there too took 8.6 s).
RESNET_MESHES = {"dp2_fsdp2": ["mesh.dp=2", "mesh.fsdp=2"],
                 "fsdp2_tp2": ["mesh.dp=1", "mesh.fsdp=2", "mesh.tp=2"]}
RESNET_TP = ["data.batch_size=32", f"train.steps={ENC_STEPS}"]
# (f) fp32 at tp2 x fsdp2 (SP) on phase 20's kernel routes, and ResNet-50
# at dp2 x fsdp2 on phase 16's parity config.
VIT_TP_PARITY = ENCODER_PARITY + TP_MESH + [
    "model.kwargs.attn_impl=flash", "optim.name=adamw_fused",
    "train.remat=full"]
BERT_TP_PARITY = ENCODER_PARITY + TP_MESH + [
    "model.kwargs.attn_impl=flash", "optim.name=adamw_fused",
    "data.pad_min_len=32", "train.grad_accum=2"]
RESNET_FSDP_PARITY = RESNET_PARITY + RESNET_MESHES["dp2_fsdp2"]
# (f)'s AdamW moments after step 2 (the clipped raw gradients) against
# phase 20's cut to each rank's blocks, leaf by leaf (``stats_diff``): fp32
# sums in another order differ by up to ~1e-4 of a leaf's norm (ViT-L's
# 24 blocks); a tp or fsdp sum doubled or left out moves a moment by 0.5
# of it or more. The params are not held so: AdamW's first steps move
# each element of a leaf by about lr whatever its gradient's size, so a
# leaf that starts at zero (a bias) carries its smallest gradients'
# rounding into its params whole.
LEAF_STATS_TOL = 1e-3


def shard_jobs(tmp):
    """Phase 39's jobs, run in phase 34's four spawned ranks: (a) gpt2_pp
    at pp2 x tp2 with an evaluation and a save at step 2; (b) its fp32
    twin with a save at step 2 (each rank's digests); (c) ViT-L/16 and (d)
    BERT-base as shipped at tp2 x fsdp2 with SP; (e) ResNet-50 as shipped
    at fsdp2 x tp2; (f) the fp32 ViT-L, BERT and ResNet-50 (dp2 x fsdp2)
    runs (ViT-L's and BERT's with :func:`leaf_stats` of every rank's AdamW
    moments). Returns (the jobs, the two checkpoint directories)."""
    cka = os.path.join(tmp, "pp_tp_ckpt")
    ckb = os.path.join(tmp, "pp_tp_fp32_ckpt")
    keep = {"params": False}
    stats = {"params": False, "stats": True}
    return [
        (GPT2_PP_TP, cka, ENC_STEPS, GPT2_PP, {"eval": True, **keep}),
        (GPT2_PP_TP_PARITY, ckb, ENC_STEPS, GPT2_PP, {"hashes": True}),
        (VIT_TP, None, 0, VIT, keep),
        (BERT_TP, None, 0, BERT, keep),
        (RESNET_TP + RESNET_MESHES["fsdp2_tp2"], None, 0, RESNET, keep),
        (VIT_TP_PARITY, None, 0, VIT, stats),
        (BERT_TP_PARITY, None, 0, BERT, stats),
        (RESNET_FSDP_PARITY, None, 0, RESNET),
    ], (cka, ckb)


def _equal_losses(name, ranks):
    ls = [r["losses"] for r in ranks]
    if any(x != ls[0] for x in ls) or not all(map(math.isfinite, ls[0])):
        raise AssertionError(f"{name}: rank losses {ls}")
    return ls[0]


def _rank_bytes(r):
    sh = r["shards"]
    return {"param_bytes": sh["param_bytes"],
            "moment_bytes": r["opt_state_bytes"],
            "whole_param_bytes": sh["whole_param_bytes"],
            "param_share": sh["param_bytes"] / sh["whole_param_bytes"],
            "sharded_fraction": {a: sh["sharded_fraction"][a]
                                 for a in ("tp", "fsdp")},
            "peak_mem_gb": r["peak_mem_gb"],
            "transport_s_by_step": r["transport_s_by_step"]}


def _flash_job(name, ranks, layers, fwd_per, accum, shape):
    """A flash job's launch counts and shapes on every rank: per step
    flash_fwd layers x fwd_per x accum, flash_dq and flash_dkv layers x
    accum, fused_adamw twice (its two groups over the rank's blocks), each
    flash kernel at ``shape``."""
    want = {"flash_fwd": layers * fwd_per * accum * ENC_STEPS,
            "flash_dq": layers * accum * ENC_STEPS,
            "flash_dkv": layers * accum * ENC_STEPS,
            "fused_adamw": 2 * ENC_STEPS,
            "ring_step": 0, "ring_dq": 0, "ring_dkv": 0}
    for i, r in enumerate(ranks):
        shapes = sorted({tuple(x) for v in r["flash_shapes"].values()
                         for x in v})
        if r["launches"] != want or shapes != [shape]:
            raise AssertionError(f"{name} rank {i}: launches {r['launches']}"
                                 f" != {want}, shapes {shapes} != {shape}")
    return want


def shard_parity(torch, cli, models, load_config, apply_overrides, enc_ref,
                 resnet_ref, results, cks):
    """Phase 39: the results of :func:`shard_jobs`.

    (a) gpt2_pp at pp2 x tp2: losses finite and equal on the 4 ranks, an
    evaluation, the step-2 save on disk; each rank M + 2(S - 1) = 10 ticks
    a step (20 over the 2 steps), M + 1 = 9 in the evaluation, no hand
    kernel, its leaves cut over tp; per rank its param and moment bytes
    against the whole model's (its stage's blocks and its block of the
    table's tp slice, JAX's ``vocab_pp``), and its transport seconds.
    (b) fp32: losses within 1e-4 relative of a pp=1 twin here (the same 2
    stages, the plain AdamW) and falling; the save restored here at pp=1
    and cut to each rank's rows and tp blocks equals that rank's params
    bit for bit (sha256). (c) ViT-L/16: every rank's flash kernels at [4
    images x 8 heads, 256, 64] (limit 197), 24 x 2 (remat) flash_fwd a
    step, 24 flash_dq and flash_dkv, 2 fused_adamw. (d) BERT-base: [1 row
    x 6 heads, 128, 64] with per-row limits, 12 x 4 of each a step. (e)
    ResNet-50 at fsdp2 x tp2: losses finite and equal, no hand kernel.
    (f) fp32 ViT-L and BERT within 1e-4 relative of phase 20's one
    process, and every rank's AdamW moments within ``LEAF_STATS_TOL`` of
    phase 20's cut to its blocks, leaf by leaf; ResNet-50 at dp2 x fsdp2
    within 1e-4 of phase 16's one process, its running statistics within
    ``BN_STATS_TOL``. Returns (the record, the launches on these
    paths)."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    (pp_a, pp_b, vit, bert, resnet), (cka, ckb) = results[:-3], cks
    vit32, bert32, resnet32 = results[-3:]
    res = {}
    # (a)
    losses = _equal_losses("gpt2_pp pp2 x tp2", pp_a)
    S, M = 2, 8
    if (len(losses) != ENC_STEPS or not pp_a[0]["evals"]
            or sorted(os.listdir(cka)) != [str(ENC_STEPS)]):
        raise AssertionError(f"gpt2_pp pp2 x tp2: losses {losses}, evals "
                             f"{pp_a[0]['evals']}, saves "
                             f"{sorted(os.listdir(cka))}")
    per_rank = []
    for i, r in enumerate(pp_a):
        t = r["pipeline"]
        if (t["train_ticks"] != ENC_STEPS * (M + 2 * (S - 1))
                or t["eval_ticks"] != M + S - 1):
            raise AssertionError(f"gpt2_pp pp2 x tp2 rank {i}: ticks {t}")
        if (any(r["launches"].values())
                or not r["shards"]["sharded_fraction"]["tp"] > 0):
            raise AssertionError(
                f"gpt2_pp pp2 x tp2 rank {i}: launches {r['launches']}, "
                f"sharded fraction {r['shards']['sharded_fraction']}")
        per_rank.append({"rank": i, "coords": {a: r["coords"][a]
                                               for a in ("pp", "tp")},
                         "ticks_per_step": t["train_ticks"] // ENC_STEPS,
                         "eval_ticks": t["eval_ticks"],
                         "pipeline_transport_s": t["train_transport_s"],
                         "step_s": r["step_s"], **_rank_bytes(r)})
    res["gpt2_pp_pp2_tp2"] = {"losses": losses,
                              "eval_loss": pp_a[0]["evals"][0]["eval_loss"],
                              "checkpoint_saves": pp_a[0]["timings"],
                              "per_rank": per_rank}
    # (b)
    got = _equal_losses("gpt2_pp fp32 pp2 x tp2", pp_b)
    twin, trainer, state = pp_twin(
        torch, cli, load_config, apply_overrides, GPT2_PP,
        GPT2_PP_PARITY + ["model.kwargs.num_stages=2",
                          f"train.steps={ENC_STEPS}"])
    with CheckpointManager(ckb) as mgr:
        state, _ = mgr.restore(state, step=ENC_STEPS)
    restored = {k: p.detach().cpu() for k, p in state.params.items()}
    del trainer, state
    torch.cuda.empty_cache()
    cfg = apply_overrides(load_config(GPT2_PP),
                          GPT2_PP_TP_PARITY + ["mesh.pp=2"])
    mismatched = []
    for rank, r in enumerate(pp_b):
        mesh = Mesh({"pp": 2, "tp": 2}, rank=rank)
        model = models.get_model(cfg.model.name, **cfg.model.kwargs,
                                 mesh=mesh, device="meta")
        cut = model.shards.take(model.stage_rows.take(restored))
        for k, h in r["hashes"].items():
            if param_digest(cut[k]) != h:
                mismatched.append((rank, k))
    rel = rel_diff(got, twin)
    fused = 0
    for r in pp_b:
        if r["launches"]["fused_adamw"] != ENC_STEPS * r["groups"]:
            raise AssertionError(f"gpt2_pp fp32 pp2 x tp2: launches "
                                 f"{r['launches']}")
        fused += r["launches"]["fused_adamw"]
    res["gpt2_pp_pp2_tp2_fp32"] = {
        "losses": got, "pp1": twin, "max_rel_diff": rel,
        "restore_at_pp1_mismatched_leaves": len(mismatched),
        "leaves_checked": sum(len(r["hashes"]) for r in pp_b)}
    if mismatched:
        raise AssertionError(f"pp2 x tp2 restore at pp=1: {mismatched[:4]}")
    if not rel <= 1e-4 or not got[-1] < got[0]:
        raise AssertionError(f"gpt2_pp fp32 pp2 x tp2: {got} vs {twin}")
    # (c), (d)
    vit_layers = model_shape(models, load_config, apply_overrides, VIT)[0]
    bert_layers = model_shape(models, load_config, apply_overrides, BERT)[0]
    launched = {k: 0 for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    launched["fused_adamw"] = fused
    for name, ranks, layers, fwd_per, accum, shape in (
            ("vit", vit, vit_layers, 2, 1, (2 * 8, 256, 64)),
            ("bert", bert, bert_layers, 1, 4, (1 * 6, 128, 64)),
            ("vit fp32", vit32, vit_layers, 2, 1, (2 * 8, 256, 64)),
            ("bert fp32", bert32, bert_layers, 1, 2, (1 * 6, 128, 64))):
        _equal_losses(name, ranks)
        want = _flash_job(name, ranks, layers, fwd_per, accum, shape)
        for k in launched:
            launched[k] += want[k] * len(ranks)
        if " " not in name:
            res[f"{name}_tp2_fsdp2_sp"] = {
                "losses": ranks[0]["losses"], "flash_shape": list(shape),
                "launches_per_rank": want,
                "step_s": ranks[0]["step_s"],
                "per_rank": [_rank_bytes(r) for r in ranks]}
    # (e), and (f)'s ResNet-50 run at dp2 x fsdp2
    for key, ranks in (("fsdp2_tp2", resnet), ("dp2_fsdp2_fp32", resnet32)):
        _equal_losses(f"resnet50 {key}", ranks)
        if any(any(r["launches"].values()) for r in ranks):
            raise AssertionError(f"resnet50 {key} launched hand kernels")
        res[f"resnet50_{key}"] = {"losses": ranks[0]["losses"],
                                  "step_s": ranks[0]["step_s"],
                                  "per_rank": [_rank_bytes(r)
                                               for r in ranks]}
    # (f)
    pairs = {}
    for name, ranks, want in (
            ("vit", vit32, enc_ref["vit_kernels_vs_vit_plain"]["losses"][0]),
            ("bert", bert32,
             enc_ref["bert_kernels_vs_bert_plain"]["losses"][0]),
            ("resnet50", resnet32, resnet_ref[0])):
        got = ranks[0]["losses"]
        pairs[name] = {"losses": got, "one_process": want,
                       "max_rel_diff": rel_diff(got, want)}
    for name, ranks in (("vit", vit32), ("bert", bert32)):
        cuts = enc_ref["kept"][f"{name}_kernels"]
        diffs = {tree: sorted(
            (d, leaf, rank) for rank, (r, cut) in enumerate(zip(ranks, cuts))
            for d, leaf in stats_diff(r["stats"][tree], cut[tree]))[::-1]
            for tree in ("mu", "nu")}
        pairs[name]["leaf_stats_diff"] = {
            tree: {"max": v[0][0], "worst": v[:3]}
            for tree, v in diffs.items()}
        pairs[name]["leaves_checked"] = len(diffs["mu"])
    ra, sa = resnet32[0]["model_state"], resnet_ref[1]
    sdiff = max(((ra[k] - sa[k]).abs().max() / sa[k].abs().max()).item()
                for k in sa)
    pairs["resnet50"]["bn_stats_diff"] = sdiff
    res["fp32_against_one_process"] = pairs
    print(f"shard parity: {json.dumps(res)} (four ranks share the one card "
          "over gloo: the step times are a path, not a speed)", flush=True)
    for name, p in pairs.items():
        if not p["max_rel_diff"] <= 1e-4:
            raise AssertionError(f"{name} fp32 sharded vs one process: "
                                 f"{p}")
        if any(not v["max"] <= LEAF_STATS_TOL
               for v in p.get("leaf_stats_diff", {}).values()):
            raise AssertionError(f"{name} fp32 sharded: moments off the "
                                 f"one process's {p}")
        if not p["losses"][-1] < p["losses"][0]:
            raise AssertionError(f"{name} fp32 sharded: loss did not fall "
                                 f"{p['losses']}")
    if not sdiff <= BN_STATS_TOL:
        raise AssertionError(f"resnet50 dp2 x fsdp2: running statistics off "
                             f"by {sdiff}")
    return res, launched



# ---------------------------------------------------------------------------
# 40. context parallelism on a rank's heads
# ---------------------------------------------------------------------------

HEADS_CP_STEPS = 2
TP_CP = ["mesh.dp=1", "mesh.tp=2", "mesh.cp=2"]
# (a) gpt2_owt as shipped (bf16, adamw_fused) on ulysses_flash at dp1 x tp2
# x cp2, 4 x 1024: a rank's flash kernels run on its 3 heads of 12 over
# the whole 1024 tokens; an evaluation and a save at step 2.
ULYSSES_GPT2 = TP_CP + ["model.kwargs.attn_impl=ulysses_flash",
                        "data.batch_size=4", f"train.steps={HEADS_CP_STEPS}",
                        "train.eval_batches=1"]
# (b) the same on ring_pallas with sequence parallelism: a rank's ring
# kernels on its 6 heads over its 512-token cp block, 4 x 1024.
RING_GPT2 = TP_CP + ["model.kwargs.attn_impl=ring_pallas",
                     "train.sequence_parallel=true", "data.batch_size=4",
                     f"train.steps={HEADS_CP_STEPS}"]
# (c) Llama-300M as shipped on ulysses_flash at tp2 x cp2, 2 x 2048: K and
# V repeated to a tp rank's 8 query heads, 4 a rank after the flip.
ULYSSES_LLAMA = TP_CP + ["model.kwargs.attn_impl=ulysses_flash",
                         "data.batch_size=2", f"train.steps={HEADS_CP_STEPS}"]
# (d) fp32 GPT-2 on phase 8's overrides (4 x 1024, adamw_fused), its first
# 2 steps, against phase 8's one process.
HEADS_CP_PARITY = {
    "tp2_cp2_ulysses_flash": TP_CP + ["model.kwargs.attn_impl=ulysses_flash"],
    "fsdp2_cp2_ring_pallas": ["mesh.dp=1", "mesh.fsdp=2", "mesh.cp=2",
                              "model.kwargs.attn_impl=ring_pallas"],
}


def heads_cp_jobs(tmp, parity):
    """Phase 40's jobs, run in phase 34's four spawned ranks: (a), (b),
    (c) and the two fp32 runs of (d). Returns (the jobs, (a)'s checkpoint
    directory)."""
    ck = os.path.join(tmp, "ulysses_ckpt")
    steps = [f"train.steps={HEADS_CP_STEPS}"]
    return [
        (ULYSSES_GPT2, ck, HEADS_CP_STEPS, CONFIG,
         {"hashes": True, "eval": True}),
        (RING_GPT2, None, 0, CONFIG, {"params": False}),
        (ULYSSES_LLAMA, None, 0, LLAMA, {"params": False}),
        *[(parity["overrides"] + mesh + steps, None, 0, CONFIG,
           {"params": False}) for mesh in HEADS_CP_PARITY.values()],
    ], ck


def _heads_cp_launches(name, ranks, kernel, layers, fwd, bwd, shape=None):
    """Every rank's launches on a cp path: ``kernel`` 'flash' (``fwd``
    flash_fwd, ``bwd`` flash_dq and flash_dkv, every one at ``shape``, no
    ring kernel) or 'ring' (cp rank c: ``(c + 1) * layers`` of each ring
    kernel a step, no flash kernel); fused_adamw twice a step."""
    s = HEADS_CP_STEPS
    for i, r in enumerate(ranks):
        if kernel == "flash":
            want = {"flash_fwd": fwd, "flash_dq": bwd, "flash_dkv": bwd,
                    "ring_step": 0, "ring_dq": 0, "ring_dkv": 0}
        else:
            n = (r["coords"]["cp"] + 1) * layers * s
            want = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                    "ring_step": n, "ring_dq": n, "ring_dkv": n}
        want["fused_adamw"] = 2 * s
        shapes = sorted({tuple(x) for v in r["flash_shapes"].values()
                         for x in v})
        if r["launches"] != want or (shape and shapes != [shape]):
            raise AssertionError(f"{name} rank {i}: launches {r['launches']}"
                                 f" != {want}, flash shapes {shapes}")


def _a2a_share(r):
    """A rank's all-to-all seconds in its last step over that step's."""
    return r["all_to_all_s_by_step"][-1] / r["step_s"][-1]


def heads_cp_parity(torch, cli, models, load_config, apply_overrides, parity,
                    results, ck):
    """Phase 40: the results of :func:`heads_cp_jobs`. (a) gpt2_owt on
    ulysses_flash at tp2 x cp2: losses finite and equal on the ranks, the
    flash kernels 12 launches a layer pass at [4 x 3 heads, 1024, 64] on
    every rank (12 a step forward and backward, 12 in the evaluation), an
    evaluation, and the step-2 save restored here in one process and cut
    to each rank's blocks equal to that rank's params bit for bit; (b) on
    ring_pallas with SP: no flash kernel, cp rank 0 12 ring launches of
    each kernel a step, cp rank 1 24; (c) Llama-300M on ulysses_flash: each
    flash kernel 12 a step at [2 x 4 heads, 2048, 64]; (d) fp32 at tp2 x
    cp2 on ulysses_flash and fsdp2 x cp2 on ring_pallas: losses within
    1e-4 relative of phase 8's first 2 and falling. Every job's all-to-all
    seconds beside its step seconds (four ranks share the card over gloo:
    a path, not a speed). Returns (the record, the launches on these
    paths)."""
    from distributeddeeplearning_tpu_torch.checkpoint import (
        CheckpointManager,
    )
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    uly, ring, llama, *fp32 = results
    names = ["gpt2_ulysses_flash_tp2_cp2", "gpt2_ring_pallas_sp_tp2_cp2",
             "llama_ulysses_flash_tp2_cp2",
             *[f"gpt2_fp32_{k}" for k in HEADS_CP_PARITY]]
    for name, ranks in zip(names, results):
        _equal_losses(name, ranks)
    layers = model_shape(models, load_config, apply_overrides, CONFIG)[0]
    llayers = model_shape(models, load_config, apply_overrides, LLAMA)[0]
    s = HEADS_CP_STEPS
    _heads_cp_launches(names[0], uly, "flash", layers, layers * (s + 1),
                       layers * s, (4 * 3, 1024, 64))
    _heads_cp_launches(names[1], ring, "ring", layers, 0, 0)
    _heads_cp_launches(names[2], llama, "flash", llayers, llayers * s,
                       llayers * s, (2 * 4, 2048, 64))
    _heads_cp_launches(names[3], fp32[0], "flash", layers, layers * s,
                       layers * s, (4 * 3, 1024, 64))
    _heads_cp_launches(names[4], fp32[1], "ring", layers, 0, 0)
    if not uly[0]["evals"]:
        raise AssertionError(f"{names[0]}: no evaluation")
    # (a)'s save restored in one process, cut to each rank's blocks.
    cfg = apply_overrides(load_config(CONFIG), ULYSSES_GPT2)
    one = apply_overrides(cfg, ["mesh.tp=1", "mesh.cp=1",
                                "model.kwargs.attn_impl=flash"])
    _, trainer, _ = cli.build_all(one, "cuda")
    state = trainer.init(one.train.seed)
    with CheckpointManager(ck) as mgr:
        state, _ = mgr.restore(state, step=s)
    restored = {k: p.detach().cpu() for k, p in state.params.items()}
    del trainer, state
    torch.cuda.empty_cache()
    mismatched = []
    for rank, r in enumerate(uly):
        mesh = Mesh({"tp": 2, "cp": 2}, rank=rank)
        if mesh.coords != r["coords"]:
            raise AssertionError(f"rank {rank}: coords {r['coords']}")
        layout = models.get_model(cfg.model.name, **cfg.model.kwargs,
                                  mesh=mesh, device="meta").shards
        for k, h in r["hashes"].items():
            if param_digest(layout.take_leaf(k, restored[k])) != h:
                mismatched.append((rank, k))
    want = parity["losses_kernels"][:s]
    pairs = {k: {"losses": ranks[0]["losses"], "one_process": want,
                 "max_rel_diff": rel_diff(ranks[0]["losses"], want)}
             for k, ranks in zip(HEADS_CP_PARITY, fp32)}
    res = {name: {"losses": ranks[0]["losses"],
                  "step_s": ranks[0]["step_s"],
                  "transport_s_by_step": ranks[0]["transport_s_by_step"],
                  "all_to_all_share_last_step": [
                      round(_a2a_share(r), 4) for r in ranks],
                  "peak_mem_gb": [r["peak_mem_gb"] for r in ranks],
                  "launches": [r["launches"] for r in ranks],
                  "seconds": ranks[0]["seconds"]}
           for name, ranks in zip(names, results)}
    res["restore_in_one_process_mismatched_leaves"] = len(mismatched)
    res["fp32_against_one_process"] = pairs
    print(f"heads cp parity: {json.dumps(res)} (four ranks share the one "
          "card over gloo: the step times are a path, not a speed)",
          flush=True)
    if mismatched:
        raise AssertionError(f"ulysses restore in one process: "
                             f"{mismatched[:4]} differ")
    for k, p in pairs.items():
        if not p["max_rel_diff"] <= 1e-4 or not p["losses"][-1] < p[
                "losses"][0]:
            raise AssertionError(f"gpt2 fp32 {k} vs one process: {p}")
    launched = {k: sum(r["launches"][k] for job in results for r in job)
                for k in results[0][0]["launches"]}
    return res, launched


# ---------------------------------------------------------------------------
# 41. the compositions: ViT under cp, dropout, remat 'dots' and bf16_full
#     over a rank's blocks, the pipelined tables over pp alone
# ---------------------------------------------------------------------------

COMP_STEPS = 2
# (a) ViT-L/16 at 240²: 15 x 15 patches and the CLS token, 226 tokens, 113
# a cp rank (no multiple of the kernels' 64-row tile); at 224² its 197
# tokens raise the reference's seq % cp error. fp32 on phase 20's
# overrides (4 images, one batch, 2 steps) on the kernel route (flash or
# ring_pallas, adamw_fused, remat full): at dp2 x cp2 on ring_pallas (2
# images x 16 heads over a 113-token block a rank) and at tp2 x cp2 on
# ulysses_flash (4 images x 4 heads over all 226 tokens a rank).
VIT_CP = ["model.kwargs.image_size=240", "data.image_size=240"]
VIT_CP_TOKENS = 226
VIT_CP_PARITY = ENCODER_PARITY + VIT_CP + ["optim.name=adamw_fused",
                                           "train.remat=full"]
VIT_CP_MESHES = {
    "ring_pallas_dp2_cp2": ["mesh.dp=2", "mesh.cp=2",
                            "model.kwargs.attn_impl=ring_pallas"],
    "ulysses_flash_tp2_cp2": TP_CP + ["model.kwargs.attn_impl=ulysses_flash"],
}
# ... and as shipped (bf16, remat full, adamw_fused) at dp2 x cp2 on
# ring_pallas, 4 images (2 x 16 heads a rank, bf16 ring kernels over 113
# tokens), 2 steps.
VIT_CP_BF16 = VIT_CP + ["mesh.dp=2", "mesh.cp=2",
                        "model.kwargs.attn_impl=ring_pallas",
                        "data.batch_size=4", f"train.steps={COMP_STEPS}"]
# (b) fp32 GPT-2 with dropout 0.1 on phase 8's overrides (4 x 1024, one
# batch, adamw_fused; ZeRO-1 off, so each rank's moments are its blocks),
# 2 steps: on ulysses (the plain core behind the all-to-alls) at tp2 x
# cp2, and on xla with remat 'dots' at dp2 x fsdp2 (1 row a rank).
DROPOUT = ["model.kwargs.dropout_rate=0.1", "train.zero1=false",
           f"train.steps={COMP_STEPS}"]
DROPOUT_MESHES = {
    "ulysses_tp2_cp2": TP_CP + ["model.kwargs.attn_impl=ulysses"],
    "xla_dots_dp2_fsdp2": ["mesh.dp=2", "mesh.fsdp=2",
                           "model.kwargs.attn_impl=xla", "train.remat=dots"],
}
# (c) GPT-2 124M under bf16_full (bf16 compute, bf16 moments rounded with
# each element's bits of the whole leaf) at tp2 x fsdp2, 4 x 1024 of one
# batch at a constant lr, 2 steps, against the same in one process.
BF16_FULL_COMP = BF16_FULL + ["data.batch_size=4", "data.n_distinct=1",
                              "optim.schedule=constant",
                              "optim.warmup_steps=0",
                              f"train.steps={COMP_STEPS}"]
BF16_FULL_MESH = ["mesh.dp=1", "mesh.tp=2", "mesh.fsdp=2"]
# bf16 compute in another summation order (the tp and fsdp sums) moves a
# loss by a few bf16 roundings of the logits at most: 1e-3 relative.
BF16_FULL_COMP_TOL = 1e-3


def composition_jobs(tmp, parity):
    """Phase 41's jobs, run in phase 34's four spawned ranks: (a) the fp32
    ViT-L runs (each rank's :func:`leaf_stats` of its AdamW moments) and
    the bf16 one; (b) the fp32 GPT-2 runs with dropout (leaf stats); (c)
    bf16_full at tp2 x fsdp2. Returns (the jobs, None)."""
    stats = {"params": False, "stats": True}
    keep = {"params": False}
    return [
        *[(VIT_CP_PARITY + mesh, None, 0, VIT, stats)
          for mesh in VIT_CP_MESHES.values()],
        (VIT_CP_BF16, None, 0, VIT, keep),
        *[(parity["overrides"] + DROPOUT + mesh, None, 0, CONFIG, stats)
          for mesh in DROPOUT_MESHES.values()],
        (BF16_FULL_COMP + BF16_FULL_MESH, None, 0, CONFIG, keep),
    ], None


def _mesh_shape(overrides) -> dict:
    """The axis sizes a list of overrides sets (``mesh.<axis>=<n>``)."""
    return {o.split("=")[0][len("mesh."):]: int(o.split("=")[1])
            for o in overrides if o.startswith("mesh.")}


def cut_stats(torch, load_config, apply_overrides, config, overrides,
              meshes):
    """A ``keep`` of :func:`parity_runs`: for each mesh of ``meshes``
    (name -> overrides) and each of its four ranks, :func:`leaf_stats` of
    the one process's AdamW moments cut to that rank's blocks (whole where
    the mesh cuts no leaf): what the rank holds if its step is right."""
    from distributeddeeplearning_tpu_torch import models
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    def keep(state):
        out = {}
        for name, mesh in meshes.items():
            cfg = apply_overrides(load_config(config),
                                  list(overrides) + list(mesh))
            shape = _mesh_shape(mesh)
            out[name] = []
            for rank in range(math.prod(shape.values())):
                meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                                        mesh=Mesh(shape, rank=rank),
                                        device="meta")
                cut = (meta.shards.take if meta.shards is not None
                       else lambda t: t)
                out[name].append({
                    m: leaf_stats(torch, cut(getattr(state.opt_state, m)))
                    for m in ("mu", "nu")})
        return out
    return keep


def _moments_against(name, ranks, want):
    """Every rank's moments' :func:`leaf_stats` against the one process's
    cut to its blocks: the largest relative difference and its leaf."""
    worst = (0.0, "")
    for rank, (r, w) in enumerate(zip(ranks, want)):
        for m in ("mu", "nu"):
            d = stats_diff(r["stats"][m], w[m])
            if d and d[0][0] > worst[0]:
                worst = (d[0][0], f"rank {rank} {m} {d[0][1]}")
    if not worst[0] <= LEAF_STATS_TOL:
        raise AssertionError(f"{name}: moments off one process's by "
                             f"{worst}")
    return worst


def _kernel_launches(name, ranks, kernels, none):
    """Each of ``kernels`` launched on every rank, none of ``none``, and
    every rank the same counts (the cp cores: every block visited by every
    rank, non-causal)."""
    for i, r in enumerate(ranks):
        got = r["launches"]
        if (not all(got[k] > 0 for k in kernels) or any(got[k] for k in none)
                or {k: got[k] for k in kernels} != {
                    k: ranks[0]["launches"][k] for k in kernels}):
            raise AssertionError(f"{name} rank {i}: launches {got}")


def composition_parity(torch, cli, models, load_config, apply_overrides,
                       parity, pp_ranks, results, _):
    """Phase 41: the results of :func:`composition_jobs` and phase 34's
    gpt2_pp run. (a) fp32 ViT-L/16 at 240² (226 tokens) at dp2 x cp2 on
    ring_pallas and at tp2 x cp2 on ulysses_flash: losses equal on the
    ranks, within 1e-4 relative of one process here (flash, adamw_fused,
    remat full) and falling; every rank's AdamW moments within
    ``LEAF_STATS_TOL`` of the one process's cut to its blocks, leaf by leaf
    (the zero head hides the encoder's gradient from the first loss, and
    the CLS token's cotangent reaches every rank's blocks through cp rank
    0 alone); the ring kernels (non-causal, 113-row blocks) or the flash
    kernels (4 heads over 226 tokens padded to 256) launched on every
    rank; the bf16 run as shipped on ring_pallas: losses finite and equal,
    the ring kernels on every rank. (b) fp32 GPT-2 with dropout 0.1 at tp2
    x cp2 on ulysses and at dp2 x fsdp2 on xla with remat 'dots': losses
    (moved by the masks from phase 8's) within 1e-4 relative of one
    process on xla from the same seed (each
    rank's masks its blocks of the one-rank masks) and every rank's
    moments within ``LEAF_STATS_TOL`` of its cut. (c) bf16_full at tp2 x
    fsdp2: losses within ``BF16_FULL_COMP_TOL`` of one process, bf16
    moments (a rank's moment bytes equal to its fp32 master bytes), no
    fused_adamw launch. (d) phase 34's gpt2_pp at pp=4: each rank holds a
    quarter of the tied table's rows (JAX's ``vocab_pp`` at pp alone) and
    of their two fp32 moments; its param and moment bytes before (the
    table whole) and after. Returns (the record, the launches on
    these paths)."""
    from distributeddeeplearning_tpu_torch.mesh import Mesh

    vit32 = results[:2]
    vit16 = results[2]
    drop32 = results[3:5]
    full = results[5]
    res = {}
    # (a)
    want_losses, _, _, kept = route_run(
        torch, cli, load_config, apply_overrides, VIT,
        VIT_CP_PARITY + ["model.kwargs.attn_impl=flash"],
        cut_stats(torch, load_config, apply_overrides, VIT, VIT_CP_PARITY,
                  VIT_CP_MESHES))
    layers = model_shape(models, load_config, apply_overrides, VIT)[0]
    for (name, mesh), ranks in zip(VIT_CP_MESHES.items(), vit32):
        losses = _equal_losses(f"vit {name}", ranks)
        rel = rel_diff(losses, want_losses)
        worst = _moments_against(f"vit {name}", ranks, kept[name])
        ring = name.startswith("ring")
        rk, fk = ("ring_step", "ring_dq", "ring_dkv"), ("flash_fwd",
                                                        "flash_dq",
                                                        "flash_dkv")
        _kernel_launches(f"vit {name}", ranks, (rk if ring else fk)
                         + ("fused_adamw",), fk if ring else rk)
        shapes = sorted({tuple(x) for v in ranks[0]["flash_shapes"].values()
                         for x in v})
        res[f"vit_fp32_{name}"] = {
            "losses": losses, "one_process": want_losses,
            "max_rel_diff": rel, "moments_max_rel_diff": worst,
            "launches": ranks[0]["launches"], "flash_shapes": shapes,
            "step_s": ranks[0]["step_s"],
            "transport_s_by_step": ranks[0]["transport_s_by_step"],
            "peak_mem_gb": [r["peak_mem_gb"] for r in ranks]}
        if not rel <= 1e-4 or not losses[-1] < losses[0]:
            raise AssertionError(f"vit fp32 {name}: {res[f'vit_fp32_{name}']}")
        if not ring and shapes != [(4 * 4, 256, 64)]:
            raise AssertionError(f"vit {name}: flash shapes {shapes}")
    losses = _equal_losses("vit bf16 dp2 x cp2", vit16)
    _kernel_launches("vit bf16 dp2 x cp2", vit16,
                     ("ring_step", "ring_dq", "ring_dkv", "fused_adamw"),
                     ("flash_fwd", "flash_dq", "flash_dkv"))
    res["vit_bf16_ring_pallas_dp2_cp2"] = {
        "losses": losses, "launches": vit16[0]["launches"],
        "layers": layers, "step_s": vit16[0]["step_s"],
        "transport_s_by_step": vit16[0]["transport_s_by_step"],
        "peak_mem_gb": [r["peak_mem_gb"] for r in vit16]}
    # (b)
    drop_base = parity["overrides"] + DROPOUT
    want_losses, _, _, kept = route_run(
        torch, cli, load_config, apply_overrides, CONFIG,
        drop_base + ["model.kwargs.attn_impl=xla", "optim.name=adamw"],
        cut_stats(torch, load_config, apply_overrides, CONFIG, drop_base,
                  DROPOUT_MESHES))
    plain = parity["losses_kernels"][0]
    if not abs(want_losses[0] - plain) > 1e-4 * plain:
        # The masks move the loss by more than the parity gate below.
        raise AssertionError(f"gpt2 dropout: one process's loss "
                             f"{want_losses} is no dropout's ({plain})")
    for (name, _), ranks in zip(DROPOUT_MESHES.items(), drop32):
        losses = _equal_losses(f"gpt2 dropout {name}", ranks)
        rel = rel_diff(losses, want_losses)
        worst = _moments_against(f"gpt2 dropout {name}", ranks, kept[name])
        res[f"gpt2_dropout_{name}"] = {
            "losses": losses, "one_process": want_losses,
            "max_rel_diff": rel, "moments_max_rel_diff": worst,
            "launches": ranks[0]["launches"], "step_s": ranks[0]["step_s"],
            "transport_s_by_step": ranks[0]["transport_s_by_step"],
            "peak_mem_gb": [r["peak_mem_gb"] for r in ranks]}
        if not rel <= 1e-4:  # each step draws new masks: no fall needed
            raise AssertionError(f"gpt2 dropout {name}: "
                                 f"{res[f'gpt2_dropout_{name}']}")
    # (c)
    losses = _equal_losses("gpt2 bf16_full tp2 x fsdp2", full)
    one, _, _, _ = route_run(torch, cli, load_config, apply_overrides,
                             CONFIG, BF16_FULL_COMP)
    rel = rel_diff(losses, one)
    for i, r in enumerate(full):
        if (r["launches"]["fused_adamw"] or not r["launches"]["flash_fwd"]
                or r["opt_state_bytes"] != r["shards"]["param_bytes"]):
            raise AssertionError(
                f"gpt2 bf16_full tp2 x fsdp2 rank {i}: launches "
                f"{r['launches']}, moment bytes {r['opt_state_bytes']} "
                f"against fp32 master bytes {r['shards']['param_bytes']}")
    res["gpt2_bf16_full_tp2_fsdp2"] = {
        "losses": losses, "one_process": one, "max_rel_diff": rel,
        "per_rank": [_rank_bytes(r) for r in full],
        "step_s": full[0]["step_s"]}
    if not rel <= BF16_FULL_COMP_TOL:
        raise AssertionError(f"gpt2 bf16_full tp2 x fsdp2: {rel} > "
                             f"{BF16_FULL_COMP_TOL}")
    # (d)
    _, _, end = cli_result(pp_ranks)
    cfg = load_config(GPT2_PP)
    table = "wte.embedding"
    per_rank = []
    for i, r in enumerate(end["ranks"]):
        meta = models.get_model(cfg.model.name, **cfg.model.kwargs,
                                mesh=Mesh({"pp": PP_RANKS}, rank=i),
                                device="meta")
        whole = meta.shards.whole[table]
        block = meta.shards.local[table]
        after = 4 * sum(p.numel() for p in meta.parameters())
        before = after + 4 * (math.prod(whole) - math.prod(block))
        row = {"rank": i, "table_block": list(block),
               "table_whole": list(whole),
               "param_bytes_before": before, "param_bytes": after,
               "moment_bytes_before": 2 * before,
               "moment_bytes": r["opt_state_bytes"]}
        per_rank.append(row)
        if (block[0] != -(-whole[0] // PP_RANKS)
                or r["shards"]["param_bytes"] != after
                or r["opt_state_bytes"] != 2 * after):
            raise AssertionError(f"gpt2_pp pp=4 rank {i}: {row}, recorded "
                                 f"{r['shards']}")
    res["gpt2_pp_pp4_tables"] = per_rank
    print(f"compositions: {json.dumps(res)} (four ranks share the one card "
          "over gloo: the step times are a path, not a speed)", flush=True)
    launched = {k: sum(r["launches"][k] for job in results for r in job)
                for k in results[0][0]["launches"]}
    return res, launched


# ---------------------------------------------------------------------------
# 42. the explicit data-parallel sync
# ---------------------------------------------------------------------------

# (a) cli launch: gpt2_owt as shipped (bf16, flash, adamw_fused, ZeRO-1) at
# dp=4 in two slices of two, the int8 ring with error feedback in buckets.
DP_SYNC_BUCKET_MB = 25.0
DP_SYNC_STEPS = 2
DP_SYNC_LAUNCH = ["mesh.dp=4", "mesh.dcn_dp=2", "train.grad_comm=int8",
                  f"train.grad_bucket_mb={DP_SYNC_BUCKET_MB}",
                  "data.batch_size=4", f"train.steps={DP_SYNC_STEPS}",
                  "train.log_every=1"]
# (b) phase 8's fp32 overrides with the sharded update's optimizer (the
# reference's fences refuse weight decay, the clip and adamw_fused there).
DP_SYNC_OPT = ["optim.name=adamw", "optim.weight_decay=0.0",
               "optim.grad_clip=0.0", f"train.steps={DP_SYNC_STEPS}"]
DP_SYNC_MESHES = {
    "hier_sharded": ["mesh.dp=4", "mesh.dcn_dp=2",
                     "train.update_sharding=sharded"],
    "flat_bucketed": ["mesh.dp=4", f"train.grad_bucket_mb={DP_SYNC_BUCKET_MB}"],
    "int8_hier": ["mesh.dp=4", "mesh.dcn_dp=2", "train.grad_comm=int8",
                  f"train.grad_bucket_mb={DP_SYNC_BUCKET_MB}"],
}
# int8 with error feedback against the fp32 one process: the losses of 2
# steps within this relative band (the reference's own test allows 5e-3
# absolute, about 5e-4 relative at these losses, over 6 steps at dp=8).
INT8_LOSS_BAND = 2e-3


def dp_sync_jobs(tmp, parity):
    """Phase 42(b)'s jobs, run in phase 34's four spawned ranks: fp32 GPT-2
    on phase 8's 4 x 1024 under the hierarchical sharded update, the flat
    bucketed sync, and int8 over the hierarchy. Returns (the jobs, None)."""
    keep = {"params": False}
    return [(parity["overrides"] + DP_SYNC_OPT + mesh, None, 0, CONFIG, keep)
            for mesh in DP_SYNC_MESHES.values()], None


def dp_sync_launch(torch):
    """Phase 42(a): ``cli launch --num-processes 4`` on the card (the four
    ranks share it over gloo): ``configs/gpt2_owt.py`` as shipped with
    :data:`DP_SYNC_LAUNCH`. Every rank's losses finite and equal, its
    error-feedback residual non-zero, the flash kernels and fused AdamW
    launched 12 x steps and 2 x steps (ZeRO-1's two groups); the wire
    bytes of ``benchmark.sync_fields`` printed. Returns (the record, the
    launches summed over the ranks)."""
    argv = [sys.executable, "-m", "distributeddeeplearning_tpu_torch.cli",
            "launch", "--num-processes", "4", "--sync-steps", "--config",
            CONFIG]
    for o in DP_SYNC_LAUNCH:
        argv += ["--override", o]
    t0 = time.perf_counter()
    res = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"cli launch exited {res.returncode}:\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    recs = [json.loads(line.split("] ", 1)[1]) for line in
            res.stdout.splitlines() if line.startswith("[p0] {")]
    end = next(r for r in recs if r.get("event") == "train_end")
    ranks = end["ranks"]
    if len(ranks) != 4 or end["backend"] != "gloo":
        raise AssertionError(f"cli launch: {len(ranks)} ranks over "
                             f"{end['backend']}")
    losses = [r["losses"] for r in ranks]
    if not (len(losses[0]) == DP_SYNC_STEPS
            and all(math.isfinite(x) for x in losses[0])
            and all(x == losses[0] for x in losses)):
        raise AssertionError(f"cli launch: losses {losses}")
    norms = [r["grad_residual_norm"] for r in ranks]
    if not all(n > 0 for n in norms):
        raise AssertionError(f"cli launch: residual norms {norms}")
    layers = 12
    want = {"flash_fwd": layers * DP_SYNC_STEPS,
            "flash_dq": layers * DP_SYNC_STEPS,
            "flash_dkv": layers * DP_SYNC_STEPS,
            "fused_adamw": 2 * DP_SYNC_STEPS}
    for r, rank in enumerate(ranks):
        got = {k: rank["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"cli launch rank {r}: launches {got}, "
                                 f"expected {want}")
    sync = end["sync"]
    print(f"cli launch (4 ranks, dcn_dp=2, int8, buckets of "
          f"{DP_SYNC_BUCKET_MB} MiB): {seconds:.1f} s; losses {losses[0]} "
          f"on every rank; residual norms {norms}; step s {end['step_s']}; "
          f"{sync['grad_buckets']} buckets, wire bytes a bucket "
          f"{sync['grad_bucket_wire_bytes']}, by phase "
          f"{sync['hier_phase_wire_bytes']}, cross-slice "
          f"{sync['dcn_wire_bytes']}, flat-ring model "
          f"{sync['grad_sync_bytes_per_step']}; peak GB "
          f"{[round(r['peak_mem_gb'], 2) for r in ranks]}", flush=True)
    record = {"seconds": seconds, "losses": losses[0], "residual_norms":
              norms, "step_s": end["step_s"], "sync": sync}
    launched = {k: sum(r["launches"].get(k, 0) for r in ranks) for k in want}
    return record, launched


def dp_sync_parity(torch, cli, load_config, apply_overrides, parity,
                   results, _):
    """Phase 42(b): the results of :func:`dp_sync_jobs` against one process
    here on the same overrides (phase 8's fp32 route with
    :data:`DP_SYNC_OPT`): the fp32 hierarchical sharded update and the
    flat bucketed sync within 1e-4 relative (phase 8's limit), int8 over
    the hierarchy within :data:`INT8_LOSS_BAND`; losses equal on the
    ranks and falling; the flash kernels on every rank. Returns (the
    record, the launches on these paths)."""
    losses, _, launched_one, _ = route_run(
        torch, cli, load_config, apply_overrides, CONFIG,
        parity["overrides"] + DP_SYNC_OPT)
    record, launched = {"one_process": losses}, {}
    for (name, _), ranks in zip(DP_SYNC_MESHES.items(), results):
        got = ranks[0]["losses"]
        if any(r["losses"] != got for r in ranks):
            raise AssertionError(f"{name}: losses differ over the ranks "
                                 f"{[r['losses'] for r in ranks]}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, losses))
        limit = INT8_LOSS_BAND if name.startswith("int8") else 1e-4
        if not (rel <= limit and got[-1] < got[0]):
            raise AssertionError(f"{name}: losses {got} against one "
                                 f"process {losses}: rel {rel} > {limit}")
        for r in ranks:
            if not all(r["launches"][k] > 0 for k in
                       ("flash_fwd", "flash_dq", "flash_dkv")):
                raise AssertionError(f"{name}: launches {r['launches']}")
        for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
            launched[k] = launched.get(k, 0) + sum(
                r["launches"].get(k, 0) for r in ranks)
        step2 = ranks[0]["step_s"][-1]
        share = ranks[0]["transport_s_by_step"][-1] / step2
        record[name] = {"losses": got, "rel": rel, "step2_s": step2,
                        "transport_share": share}
        print(f"{name}: losses {got}, one process {losses}, max rel "
              f"{rel:.3g} (limit {limit}); step 2 {step2:.3f} s, "
              f"{100 * share:.0f}% transport; peak GB "
              f"{[round(r['peak_mem_gb'], 2) for r in ranks]}", flush=True)
    return record, launched


# ---------------------------------------------------------------------------
# 44-45. supervised training and the chaos harnesses
# ---------------------------------------------------------------------------

# Phase 44: tools/torch_chaos_run.py's matrix through cli supervise on
# configs/gpt2_owt.py at 124M width (bf16, flash, adamw_fused as shipped),
# the health guard on, 8 steps, a save every 2. The batch is cut to 8 x
# 1024 (phase 34's cut): the children share the card with phase 34's
# group. The hang timeout must exceed the longest wait between two
# heartbeats of a healthy child: its start (import, CUDA, the 124M draw)
# or its cold first step (~9 s, ROADMAP A15.r). Spawn to a child's first
# record took 28-40 s on an H100 beside phase 34's group, so 60 s.
CHAOS_OVERRIDES = ("data.batch_size=8",)
CHAOS_STEPS = 8
CHAOS_HANG_TIMEOUT_S = 60
# Three lanes of runs, one after another in each ("preempt" gets a
# SIGTERM after step 3's record, then "relaunch" resumes it). An
# undisturbed child was bit-equal to the in-process run on an H100, so
# the recoveries are held to it bit for bit.
CHAOS_LANES = (("hang:7",), ("corrupt:6", "nan:5"), ("preempt",))
# Phase 45: tools/torch_serve_chaos.py's matrix on GPT-2 124M's width
# (vocab 256, max_len 160), the paged kernel as the read path; the pool
# allocated large enough for the 9 blocks the workers are cut to.
SERVE_CHAOS_ARGS = ("--size", "124m", "--hbm-budget-mb", "64")


def load_tool(name):
    """A module of ``tools/`` by file name."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keep_last(ck_dir, step):
    """Delete every save of ``ck_dir`` but ``step``'s (disk)."""
    for name in os.listdir(ck_dir) if os.path.isdir(ck_dir) else []:
        if name != str(step) and (name.isdigit() or name.endswith(
                ".corrupt")):
            shutil.rmtree(os.path.join(ck_dir, name), ignore_errors=True)


def start_chaos_train(tmp, nice=True):
    """Phase 44's supervised runs, each lane of ``CHAOS_LANES`` on a thread
    of its own (each supervisor a subprocess that touches no device; its
    child trains on the card). Returns the threads and the dict they fill
    with each run's result (``tools/torch_chaos_run.run_one``) by name."""
    import signal
    import threading

    tool = load_tool("torch_chaos_run")
    args = tool.parser().parse_args([
        "--config", CONFIG, "--steps", str(CHAOS_STEPS),
        "--hang-timeout", str(CHAOS_HANG_TIMEOUT_S), "--timeout", "420",
        "--out", os.path.join(tmp, "status.json"),
        *[x for o in CHAOS_OVERRIDES for x in ("--override", o)]])
    prefix = (["nice", "-n", "10"] if nice and shutil.which("nice") else [])
    out = {}

    def run(name):
        key = name
        workdir = os.path.join(tmp, key.replace(":", "_"))
        os.makedirs(workdir, exist_ok=True)
        extra, hook = [], None
        if name == "corrupt:6":
            extra = ["--telemetry", os.path.join(workdir, "telemetry")]
        if name == "preempt":
            sent = {}

            def hook(proc, rec):
                if rec.get("step") == 3 and "loss" in rec and not sent:
                    sent["t"] = time.monotonic()
                    proc.send_signal(signal.SIGTERM)

        t0 = time.monotonic()
        fault = "" if name == "preempt" else name
        res = tool.run_one(args, fault, workdir, on_record=hook,
                           extra=extra, prefix=prefix)
        res["workdir"] = workdir
        if name == "preempt":
            res["sigterm_s"] = round(sent.get("t", t0) - t0, 3)
            out[name] = res
            res = tool.run_one(args, "", workdir, prefix=prefix)
            res["workdir"] = workdir
            key = "relaunch"
        _keep_last(os.path.join(workdir, "ckpt"), CHAOS_STEPS)
        out[key] = res

    def lane(names):
        for name in names:
            try:
                run(name)
            except Exception as exc:  # reported by check_chaos_train
                out[name] = {"error": repr(exc)}

    threads = [threading.Thread(target=lane, args=(names,), daemon=True)
               for names in CHAOS_LANES]
    for t in threads:
        t.start()
    return threads, out


def _first_loss_after(timeline, t):
    return next(ts for ts, rec in timeline if ts >= t and "loss" in rec)


def _at(timeline, event, nth=0):
    return [ts for ts, rec in timeline if rec.get("event") == event][nth]


def chaos_reference(torch, cli, tmp):
    """The undisturbed run of phase 44's overrides, in this process: its
    flash and fused_adamw launches counted as phase 7 counts them, its
    step-8 save's params and moments in host memory."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused

    ck = os.path.join(tmp, "reference")
    argv = ["train", "--config", CONFIG, "--device", "cuda"]
    for o in (*CHAOS_OVERRIDES, f"train.steps={CHAOS_STEPS}",
              "train.log_every=1", "train.save_every=2",
              f"train.checkpoint_dir={ck}", "health.enabled=True"):
        argv += ["--override", o]
    fa.reset_launches()
    fused.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launched = {**fa.LAUNCHES, **fused.LAUNCHES}
    want = {**{k: 12 * CHAOS_STEPS for k in fa.LAUNCHES},
            "fused_adamw": 2 * CHAOS_STEPS}
    losses = [r["loss"] for r in map(json.loads, (
        x for x in buf.getvalue().splitlines() if x.startswith("{")))
        if "loss" in r]
    if rc != 0 or launched != want or len(losses) != CHAOS_STEPS:
        raise AssertionError(f"phase 44 reference: rc {rc}, launches "
                             f"{launched} (want {want}), losses {losses}")
    state = torch.load(os.path.join(ck, str(CHAOS_STEPS), "state.pt"),
                       map_location="cpu", weights_only=True)
    shutil.rmtree(ck, ignore_errors=True)
    print(f"chaos reference: losses {losses}; launches {launched}",
          flush=True)
    return {t: state[t] for t in ("params", "mu", "nu")}, launched


def _state_diff(torch, ref, workdir):
    """(bit-equal, the largest |difference|) of a run's step-8 save's
    params and moments against ``ref``."""
    state = torch.load(os.path.join(workdir, "ckpt", str(CHAOS_STEPS),
                                    "state.pt"), map_location="cpu",
                       weights_only=True)
    equal, worst = True, 0.0
    for tree, leaves in ref.items():
        if set(state[tree]) != set(leaves):
            raise AssertionError(f"{workdir}: {tree} leaves differ")
        for k, v in leaves.items():
            if not torch.equal(state[tree][k], v):
                equal = False
                worst = max(worst, float((state[tree][k].double()
                                          - v.double()).abs().max()))
    return equal, worst


def check_chaos_train(torch, out, ref):
    """Phase 44: every run exited 0 and reached step 8 (the preempted one
    21, its relaunch 0 at step 8); nan:5 skipped one step in place with
    every loss finite and no restart; hang:7 was killed and restarted;
    corrupt:6 fell back to an earlier save, restarted and disarmed the
    fault, and its telemetry holds one goodput record an attempt, the
    backoff and a fault_corrupt flight record; the SIGTERM saved at the
    step it was preempted at, and the relaunch resumed there. The hang,
    corrupt and preempt recoveries' step-8 params and moments equal the
    in-process reference's bit for bit. Returns the record."""
    for name in ("nan:5", "hang:7", "corrupt:6", "preempt", "relaunch"):
        r = out.get(name)
        if r is None or "error" in r:
            raise AssertionError(f"phase 44 {name}: {r}")
    rec = {}
    for name, r in out.items():
        want = 21 if name == "preempt" else 0
        if r["exit_code"] != want or (want == 0 and r["final_step"]
                                      != CHAOS_STEPS):
            raise AssertionError(
                f"phase 44 {name}: exit {r['exit_code']} (want {want}), "
                f"step {r['final_step']}\n{r['stderr_tail']}")
        tl = r["timeline"]
        marks = [ts for ts, x in tl if "loss" in x
                 or x.get("event") == "supervisor_spawn"]
        rec[name] = {"wall_s": r["wall_s"], "restarts": r["restarts"],
                     "max_gap_s": max(b - a for a, b in zip(marks,
                                                            marks[1:]))}
    recs = {n: [x for _, x in r["timeline"]] for n, r in out.items()}
    events = {n: [x["event"] for x in v if "event" in x]
              for n, v in recs.items()}
    nan = [x for x in recs["nan:5"] if "loss" in x]
    if (out["nan:5"]["restarts"] or [x["skipped"] for x in nan]
            != [0.0] * 5 + [1.0] + [0.0] * 2
            or not all(math.isfinite(x["loss"]) for x in nan)):
        raise AssertionError(f"phase 44 nan:5: {nan}")
    ev = events["hang:7"]
    if not (ev.index("fault_hang") < ev.index("supervisor_hang_kill")
            < ev.index("supervisor_restart")) or "fault_disarmed" not in ev:
        raise AssertionError(f"phase 44 hang:7: {ev}")
    ev = events["corrupt:6"]
    if (not {"fault_corrupt", "supervisor_restart", "fault_disarmed"}
            <= set(ev) or "falling back" not in out["corrupt:6"][
                "stderr_tail"]):
        raise AssertionError(f"phase 44 corrupt:6: {ev}\n"
                             f"{out['corrupt:6']['stderr_tail']}")
    tdir = os.path.join(out["corrupt:6"]["workdir"], "telemetry")
    with open(os.path.join(tdir, "goodput_p0.jsonl")) as f:
        ledger = [json.loads(x) for x in f]
    summary = [x for x in recs["corrupt:6"]
               if x.get("event") == "goodput_summary"]
    if ([(x["record"], x["attempt"]) for x in ledger]
            != [("attempt", 0), ("backoff", 1), ("attempt", 1)]
            or not os.path.exists(os.path.join(
                tdir, "flight_fault_corrupt_p0_attempt0.json"))
            or len(summary) != 1):
        raise AssertionError(f"phase 44 telemetry: {ledger}, {summary}")
    print(f"chaos goodput_summary: {json.dumps(summary[0])}", flush=True)
    saves = [x for x in recs["preempt"] if x.get("event") == "preempt_save"]
    exits = [x for x in recs["preempt"]
             if x.get("event") == "preempted_exit"]
    if len(saves) != 1 or len(exits) != 1 or not saves[0]["saved"]:
        raise AssertionError(f"phase 44 preempt: {events['preempt']}")
    n = saves[0]["step"]
    resumed = [line for _, line in out["relaunch"]["text"]
               if line.startswith("resumed from step")]
    if resumed != [f"resumed from step {n}"]:
        raise AssertionError(f"phase 44 relaunch: {resumed} (preempted "
                             f"at {n})")
    # Seconds from each run's own timeline.
    tl = {name: r["timeline"] for name, r in out.items()}
    for name, fault in (("hang:7", "fault_hang"),
                        ("corrupt:6", "fault_corrupt")):
        t_fault = _at(tl[name], fault)
        t_spawn = _at(tl[name], "supervisor_spawn", 1)
        first = _first_loss_after(tl[name], t_spawn)
        rec[name].update(recovery_s=round(first - t_fault, 3),
                         cold_start_s=round(first - t_spawn, 3))
    rec["hang:7"]["detect_s"] = round(_at(tl["hang:7"],
                                          "supervisor_hang_kill")
                                      - _at(tl["hang:7"], "fault_hang"), 3)
    rec["preempt"].update(step=n, save_s=round(
        _at(tl["preempt"], "preempt_save") - out["preempt"]["sigterm_s"],
        3))
    rec["relaunch"]["cold_start_s"] = round(
        _first_loss_after(tl["relaunch"], 0.0)
        - _at(tl["relaunch"], "supervisor_spawn"), 3)
    # The kernel gate: the recoveries against the in-process reference.
    for name in ("hang:7", "corrupt:6", "relaunch"):
        eq, worst = _state_diff(torch, ref, out[name]["workdir"])
        if not eq:
            raise AssertionError(f"phase 44 {name}: step-8 state differs "
                                 f"from the reference by {worst}")
        rec[name]["bit_equal"] = eq
    for name, r in rec.items():
        print(f"chaos {name}: {json.dumps(r)}", flush=True)
    return rec


def start_serve_chaos(tmp, nice=True):
    """Phase 45: ``tools/torch_serve_chaos.py`` on a thread, a subprocess
    whose router touches no device; its workers and oracle run on the
    card, at ``nice 10`` with ``nice``. The router keeps its priority: a
    starved router credits its own silence back to every worker and never
    outs a stalled one. Returns the thread and the dict it fills."""
    import threading

    out = {}
    path = os.path.join(tmp, "serve_chaos.json")

    def run():
        low = (["--nice", "10"] if nice and shutil.which("nice") else [])
        t0 = time.perf_counter()
        try:
            p = subprocess.run(
                [sys.executable, os.path.join(ROOT, "tools",
                                              "torch_serve_chaos.py"),
                 *SERVE_CHAOS_ARGS, *low, "--out", path],
                cwd=ROOT, capture_output=True, text=True, timeout=900)
            out.update(rc=p.returncode, stdout=p.stdout, stderr=p.stderr)
        except subprocess.TimeoutExpired as exc:
            out.update(rc=124, stdout=exc.stdout or "",
                       stderr=exc.stderr or "")
        out["seconds"] = time.perf_counter() - t0
        if os.path.exists(path):
            with open(path) as f:
                out["status"] = json.load(f)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def check_serve_chaos(out, layers):
    """Phase 45: the matrix exited 0 and its status holds every pin of the
    reference (``check_status``) and every run's checks, each worker's
    paged launches equal to its decode calls x layers (``launches_exact``,
    with the kernel route on the card). Returns the record and the
    workers' launches."""
    status = out.get("status")
    if out.get("rc") != 0 or not status or not status["ok"]:
        failed = [{k: r.get(k) for k in ("run", "checks", "supervisor",
                                         "events", "worker_stderr")}
                  for r in (status or {}).get("runs", []) if not r["ok"]]
        raise AssertionError(
            f"phase 45: exit {out.get('rc')}\n{out.get('stdout', '')[-3000:]}"
            f"\n{out.get('stderr', '')[-3000:]}\n{json.dumps(failed)[-8000:]}")
    total = {"paged_decode": 0, "paged_decode_q8": 0}
    rec = {"seconds": out["seconds"], "oracle_s": status["oracle_s"]}
    for r in status["runs"]:
        bad = [k for k, v in r["checks"].items() if not v]
        reports = r["worker_launches"]
        if bad or any(w["layers"] != layers or not w["device"].startswith(
                "cuda") for w in reports):
            raise AssertionError(f"phase 45 {r['run']}: {bad} {reports}")
        for w in reports:
            for k, v in w["launches"].items():
                total[k] += v
        rec[r["run"]] = {
            "recovery_s": [x["recovery_s"] for x in r["restart_records"]],
            "served": r["served"], "retried": r["retried"],
            "rerouted": r["rerouted"], "boot_s": r["boot_s"],
            "wall_s": r["wall_s"],
            "spill_rewarm_chains": [x["spill_rewarm_chains"]
                                    for x in r["restart_records"]],
            "rewarm_hit_tokens_host": r["rewarm_hit_tokens_host"],
            "launches": [w["launches"]["paged_decode"] for w in reports],
        }
        print(f"serve chaos {r['run']}: {json.dumps(rec[r['run']])}",
              flush=True)
    return rec, total


def debug_flags(torch, cli, pa):
    """Phase 44's debug flags in this process: ``cli train`` with
    ``train.debug_nans`` and ``nan:2`` raises FloatingPointError at step
    2; under ``debug.bounds_checks`` one paged_decode step with a row's
    table entry at num_blocks leaves that row NaN and every other row as
    the step without it, and the card reports no error. Returns the
    paged kernel's launches."""
    from distributeddeeplearning_tpu_torch import debug
    from distributeddeeplearning_tpu_torch.models.transformer import (
        paged_decode_attention,
    )

    argv = ["train", "--config", CONFIG, "--device", "cuda"]
    for o in ("data.batch_size=4", "train.steps=4", "train.log_every=1",
              "train.debug_nans=true", "train.fault_injection=nan:2"):
        argv += ["--override", o]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)
    except FloatingPointError as exc:
        if "(at step 2)" not in str(exc):
            raise AssertionError(f"debug_nans raised {exc}") from exc
        print(f"debug_nans: {exc}", flush=True)
    else:
        raise AssertionError("debug_nans: no FloatingPointError at step 2")
    g = torch.Generator().manual_seed(3)
    B, H, D, nb, bs, pages = 8, 12, 64, 96, 16, 8
    table = torch.randperm(nb - 1, generator=g)[:B * pages].add(1).reshape(
        B, pages).int()
    lens = torch.randint(1, pages * bs - 1, (B,), generator=g).int()
    q, k, v = (torch.randn(B, 1, H, D, generator=g, dtype=torch.float32)
               .to(torch.bfloat16).cuda() for _ in range(3))
    pools = {n: torch.randn(nb, bs, H, D, generator=g).to(
        torch.bfloat16).cuda() for n in ("pool_key", "pool_value")}
    pa.reset_launches()
    outs = []
    for bad in (False, True):
        t = table.clone()
        if bad:
            t[3, pages - 1] = nb
        with debug.bounds_checks(True):
            outs.append(paged_decode_attention(
                q, k, v, dtype=torch.bfloat16,
                pools={n: p.clone() for n, p in pools.items()},
                page_table=t.cuda(), seq_lens=lens.cuda(), kernel="pallas"))
    torch.cuda.synchronize()  # a read outside the pool would fail here
    clean, poisoned = (o.float().cpu() for o in outs)
    rows = [i for i in range(B) if i != 3]
    if (not torch.isnan(poisoned[3]).all()
            or not torch.equal(poisoned[rows], clean[rows])
            or torch.isnan(clean).any()):
        raise AssertionError("debug_checks: the tripwire's rows differ")
    print(f"debug_checks: row 3 NaN, rows {rows} equal; launches "
          f"{dict(pa.LAUNCHES)}", flush=True)
    return dict(pa.LAUNCHES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernels-vs-plain phase")
    ap.add_argument("--fleets", action="store_true",
                    help="after the build, run phase 43's three fleets "
                    "alone on the card (no other phase beside them) "
                    "against phase 4's two in-process references")
    ap.add_argument("--chaos", action="store_true",
                    help="after the build, run phases 44 and 45 (the "
                    "supervised training and serving chaos matrices) "
                    "alone on the card")
    args = ap.parse_args(argv)
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from distributeddeeplearning_tpu_torch import cli, models
    from distributeddeeplearning_tpu_torch.config import (
        ServingConfig,
        apply_overrides,
        load_config,
    )
    from distributeddeeplearning_tpu_torch.ops import _build
    from distributeddeeplearning_tpu_torch.ops import paged_attention as pa
    from distributeddeeplearning_tpu_torch.serving import (
        Request,
        ServingEngine,
    )

    # fp32 matmuls in full fp32 (the parity phases compare at fp32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    names = ["paged_attention", "flash_attention", "fused_adamw",
             "ring_attention"]
    _build.build(names)  # one nvcc per source, all started together
    print(f"build_s {time.perf_counter() - t0:.2f}")
    for name in names:
        for line in _build.BUILD_LOGS[name].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {name}: {line.strip()}")

    check_tensor_core_build(_build)
    check_paged_build(_build)

    if args.fleets:
        phase("43 the serving fleet alone")
        scfg = apply_overrides(load_config(CONFIG), OVERRIDES)
        layers = models.get_model(scfg.model.name, **scfg.model.kwargs,
                                  device="meta").num_layers
        refs = {"off": cli_serve(cli, "off")["tokens"],
                "split": cli_serve(cli, "int8", extra=SPLIT_OVERRIDES,
                                   prompts=SPLIT_PROMPTS)["tokens"]}
        fleet_thread, fleet_out = start_fleets(nice=False)
        fleet_thread.join(timeout=600)
        if fleet_thread.is_alive():
            raise AssertionError("the fleets did not finish in 600 s")
        check_fleets(fleet_out, refs, layers)
        return 0  # a partial run prints no result line

    if args.chaos:
        scfg = apply_overrides(load_config(CONFIG), OVERRIDES)
        layers = models.get_model(scfg.model.name, **scfg.model.kwargs,
                                  device="meta").num_layers
        chaos_tmp = tempfile.TemporaryDirectory()
        phase("44 supervised training alone (then 45's matrix beside it)")
        chaos_threads, chaos_out = start_chaos_train(chaos_tmp.name,
                                                     nice=False)
        serve_thread, serve_out = start_serve_chaos(chaos_tmp.name,
                                                    nice=False)
        ref, _ = chaos_reference(torch, cli, chaos_tmp.name)
        debug_flags(torch, cli, pa)
        for t in (*chaos_threads, serve_thread):
            t.join(timeout=900)
            if t.is_alive():
                raise AssertionError("the chaos runs did not finish in "
                                     "900 s")
        check_chaos_train(torch, chaos_out, ref)
        phase("45 serving chaos alone")
        check_serve_chaos(serve_out, layers)
        chaos_tmp.cleanup()
        return 0  # a partial run prints no result line

    phase("3 kernels vs plain")
    kres = check_kernels(torch, pa)

    cfg = load_config(CONFIG)
    if args.quick:
        phase("6 training kernels vs plain")
        check_training_kernels(torch, models, cfg)
        phase("9 ring kernels vs plain")
        check_ring_kernels(torch)
        return 0  # a build-and-check run prints no result line

    phase("4 serve through the entry point")
    scfg = apply_overrides(cfg, OVERRIDES)
    layers = models.get_model(scfg.model.name, **scfg.model.kwargs,
                              device="meta").num_layers
    tel_dir = tempfile.TemporaryDirectory()  # the telemetry bundle's
    pa.reset_launches()  # the main path's count starts here
    served = cli_serve(cli, "off")
    calls_off = served["stats"]["calls"]["decode"]
    calls_q8 = cli_serve(cli, "int8")["stats"]["calls"]["decode"]
    calls_off += cli_serve_features(cli, tel_dir.name)
    # The role-split fleet's reference (phase 43): one unified engine.
    t0 = time.perf_counter()
    split = cli_serve(cli, "int8", extra=SPLIT_OVERRIDES,
                      prompts=SPLIT_PROMPTS)
    print(f"fleet check seconds: role-split reference "
          f"{time.perf_counter() - t0:.1f}", flush=True)
    calls_q8 += split["stats"]["calls"]["decode"]
    fleet_refs = {"off": served["tokens"], "split": split["tokens"]}
    launches = dict(pa.LAUNCHES)
    tel_dir.cleanup()
    want = {"paged_decode": calls_off * layers,
            "paged_decode_q8": calls_q8 * layers}
    print(f"launches {launches} expected {want}", flush=True)
    if launches != want or not all(launches.values()):
        raise AssertionError(
            f"kernel launches {launches} != decode calls x {layers} layers "
            f"{want}"
        )

    phase("5 serve at full width")
    serve_full_width(torch, pa, cli, ServingEngine, ServingConfig,
                     Request, load_config, apply_overrides)
    features = serving_features(torch, pa, cli, ServingEngine, ServingConfig,
                                Request, load_config, apply_overrides)

    phase("6 training kernels vs plain")
    kres.update(check_training_kernels(torch, models, cfg))

    phase("7 train through the entry point")
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_adamw as fused

    fa.reset_launches()  # the training path's counts start here
    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, text = cli_train(torch, cli, TRAIN_STEPS)
    train_launches = {**fa.LAUNCHES, **fused.LAUNCHES}
    want = {**{k: layers * TRAIN_STEPS for k in fa.LAUNCHES},
            "fused_adamw": 2 * TRAIN_STEPS}
    tokens = cfg.data.batch_size * cfg.data.seq_len
    print("\n".join(text))
    print(f"losses {losses}")
    print(f"launches {train_launches} expected {want}")
    print(f"train: {json.dumps({'tokens_per_s': tokens / statistics.mean(step_s), 'p50_step_ms': statistics.median(step_s) * 1e3, 'step_ms': [x * 1e3 for x in step_s], 'peak_mem_gb': torch.cuda.max_memory_allocated() / 1e9})}", flush=True)
    if train_launches != want:
        raise AssertionError(f"train launches {train_launches} != {want}")
    launches.update(train_launches)

    phase("8 fp32 parity pair at 124M width")
    parity = parity_pair(torch, cli, load_config, apply_overrides)

    phase("9 ring kernels vs plain")
    kres.update(check_ring_kernels(torch))

    phase("10 context-parallel train through the entry point (cli train "
          "on 2 spawned ranks, then the jobs of phases 11-13)")
    # The ranks are fresh processes: their counts start at 0 with the run.
    torch.cuda.empty_cache()
    zero_ck = tempfile.TemporaryDirectory()  # the pair's saves, for 13
    ck13 = os.path.join(zero_ck.name, "ckpt")
    ck12 = os.path.join(zero_ck.name, "ck12")
    logs12 = os.path.join(zero_ck.name, "logs12")
    cp_cli, cp_fit, zero_ranks, zero_cli = pair_group(
        torch, parity, ck13, ck12, logs12)
    _, end, per_rank = cli_train_cp(torch, layers, cp_cli)
    step_s = end["step_s"][1:]  # the first step warms the libraries up
    print(f"cp train: {json.dumps({'backend': end['backend'], 'ranks_on_one_card': 2, 'tokens_per_s': CP_BATCH * cfg.data.seq_len / statistics.mean(step_s), 'p50_step_ms': statistics.median(step_s) * 1e3, 'step_ms': [x * 1e3 for x in step_s], 'peak_mem_gb': [r['peak_mem_gb'] for r in end['ranks']]})}"
          " (both ranks share the one card over gloo: not a "
          "context-parallel speed)", flush=True)
    for k in ("ring_step", "ring_dq", "ring_dkv"):
        launches[k] = sum(r[k] for r in per_rank)

    launches["fused_adamw"] += sum(r["fused_adamw"] for r in per_rank)

    phase("11 fp32 parity at 124M width, cp=2 against one rank (a job of "
          "phase 10's ranks)")
    cp_parity(torch, parity, cp_fit)

    phase("12 ZeRO-1 train through the entry point (cli train on phase 10's "
          "ranks, dp=2)")
    n_params = sum(p.numel() for p in models.get_model(
        cfg.model.name, **cfg.model.kwargs, device="meta").parameters())
    _, zero_launches = cli_train_zero1(torch, layers, n_params, ck12,
                                       zero_cli, logs12)
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
        launches[k] += sum(r[k] for r in zero_launches)

    phase("13 fp32 parity at 124M width, ZeRO-1 dp=2 against one rank, "
          "and its resume (its fresh pair is phase 16's)")
    jobs13 = zero1_jobs(parity, ck13, ck12)

    phase("14 ResNet-50 train through the entry point")
    rcfg = load_config(RESNET)
    resnet_train(torch, cli, rcfg.data.batch_size)

    phase("15 cli benchmark on ResNet-50")
    bench = config_benchmark(cli, RESNET)

    phase("16 ResNet-50 dp=2 (cli train on 2 spawned ranks sharing the "
          "card over gloo), then phase 13's checks")
    _, fresh, resnet_ref = resnet_dp2(torch, cli, load_config,
                                      apply_overrides, jobs13)
    resumed12 = zero1_parity(torch, parity, zero_ranks, fresh)
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
        launches[k] += sum(r[k] for r in resumed12)
    zero_ck.cleanup()

    phase("17 ViT-L/16 train through the entry point (remat full, then "
          "none)")
    _, counts = vit_train(torch, cli, models, load_config, apply_overrides)

    phase("18 cli benchmark on ViT-L/16 and BERT-base")
    encoder_bench = flash_benchmarks(torch, cli, models, load_config,
                                     apply_overrides,
                                     (("vit", VIT), ("bert", BERT)))

    phase("19 BERT-base MLM train through the entry point")
    _, more = bert_train(torch, cli, models, load_config, apply_overrides)
    for launched in counts + more:
        for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
            launches[k] += launched[k]

    phase("20 fp32 parity at full width: ViT-L/16 and BERT-base")
    enc_ref = encoder_parity(torch, cli, load_config, apply_overrides)

    phase("21 Llama-300M train through the entry point")
    _, llama_launched = llama_train(torch, cli, models, load_config,
                                    apply_overrides)
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
        launches[k] += llama_launched[k]

    phase("22 cli benchmark on Llama-300M")
    llama_bench = flash_benchmarks(torch, cli, models, load_config,
                                   apply_overrides, (("llama", LLAMA),))

    phase("23 fp32 parity at full width: Llama-300M")
    llama_ref = llama_parity(torch, cli, load_config, apply_overrides)

    phase("24 Llama-300M serving at full width, then cli serve")
    torch.cuda.empty_cache()
    pa.reset_launches()  # each run checks its own count: calls x layers
    serve_full_width(torch, pa, cli, ServingEngine, ServingConfig, Request,
                     load_config, apply_overrides, config=LLAMA, prefix=True)
    full = dict(pa.LAUNCHES)
    llama_layers = model_shape(models, load_config, apply_overrides,
                               LLAMA)[0]
    pa.reset_launches()  # cli serve's counts start here
    calls = {q: cli_serve(cli, q, LLAMA)["stats"]["calls"]["decode"]
             for q in ("off", "int8")}
    served = dict(pa.LAUNCHES)
    want = {"paged_decode": calls["off"] * llama_layers,
            "paged_decode_q8": calls["int8"] * llama_layers}
    print(f"launches {served} expected {want}", flush=True)
    if served != want:
        raise AssertionError(f"llama cli serve launches {served} != {want}")
    for k in served:
        launches[k] += full[k] + served[k]

    phase("25 llama_moe 8x300m train through the entry point")
    _, moe_launched = moe_train(torch, cli, models, load_config,
                                apply_overrides, "llama_moe", LLAMA_MOE)
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
        launches[k] += moe_launched[k]

    phase("26 cli benchmark on llama_moe 8x300m")
    moe_bench = moe_benchmark(torch, cli, models, load_config,
                              apply_overrides)

    phase("27 gpt2_moe train through the entry point")
    _, moe_launched = moe_train(torch, cli, models, load_config,
                                apply_overrides, "gpt2_moe", GPT2_MOE)
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
        launches[k] += moe_launched[k]

    phase("28 fp32 parity at full width: llama_moe 8x300m with drops")
    moe_parity(torch, cli, load_config, apply_overrides)

    phase("29 token files: prepare_data, then gpt2_owt_file train and resume")
    for _, launched in token_file_train(torch, cli, models, load_config,
                                        apply_overrides).values():
        for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
            launches[k] += launched[k]

    # Phases 30-33 each return (result, launches on the main path).
    phase("30 bf16_full train through the entry point")
    late = [bf16_full_train(torch, cli, models, load_config,
                            apply_overrides)[1]]
    phase("31 health guard: nan:3 skipped exactly, then a rollback")
    late.append(health_guard(torch, cli, models, load_config,
                             apply_overrides)[1])
    phase("32 cli generate at full width from a trained checkpoint")
    gen_rec, launched = generate_full_width(torch, cli, models, load_config,
                                            apply_overrides)
    late.append(launched)
    phase("33 generation parity on the card, fp32: oracle and engine")
    late.append(generation_parity(torch, cli, load_config, apply_overrides,
                                  pa, ServingEngine, ServingConfig,
                                  Request)[1])
    for launched in late:
        for k, v in launched.items():
            launches[k] += v

    phase("34 one spawn of 4 ranks on the card over gloo: cli train on "
          "gpt2_pp (pp=4), then phase 36's cli train and the jobs of "
          "phases 35 and 37-42")
    tmp4 = tempfile.TemporaryDirectory()  # the group's saves
    # Phase 43's worker-process fleets and phases 44-45's supervised
    # training and serving chaos run beside the group, whose ranks leave
    # the card mostly idle (host-staged gloo).
    fleet_thread, fleet_out = start_fleets()
    chaos_tmp = tempfile.TemporaryDirectory()
    chaos_threads, chaos_out = start_chaos_train(chaos_tmp.name)
    serve_thread, serve_out = start_serve_chaos(chaos_tmp.name)
    group = four_rank_group(torch, parity, tmp4.name)
    pp_cli_train(torch, *group["pp_cli"])
    phase("35 pipelined jobs: bert_pp as shipped, fp32 gpt2_pp and bert_pp "
          "against pp=1, restore at pp=1")
    _, launched = pp_parity(torch, cli, load_config, apply_overrides,
                            *group["pp"])
    launches["fused_adamw"] += launched
    phase("36 tp2 x fsdp2 with sequence parallelism through the entry "
          "point (cli train on the 4 ranks, gpt2_owt)")
    _, per_rank = tp_cli_train(torch, models, load_config, apply_overrides,
                               *group["tp_cli"])
    for r in per_rank:
        for k in ("flash_fwd", "flash_dq", "flash_dkv", "fused_adamw"):
            launches[k] += r[k]
    phase("37 fp32 parity at tp2 x fsdp2 (GPT-2) and dp2 x tp2 (Llama-300M) "
          "against one process, restore in one process")
    _, launched = tp_parity(torch, cli, models, load_config, apply_overrides,
                            parity, llama_ref, *group["tp"])
    for k, v in launched.items():
        launches[k] += v
    phase("38 expert parallelism: gpt2_moe at dp2 x ep2 and llama_moe at "
          "ep2 x tp2 as shipped, fp32 gpt2_moe at dp2 x ep2 and ep2 x cp2 "
          "against one process, restore at ep=1")
    _, launched = ep_parity(torch, cli, models, load_config, apply_overrides,
                            *group["ep"])
    for k, v in launched.items():
        launches[k] += v
    phase("39 pp2 x tp2 (gpt2_pp as shipped and fp32 against pp=1, restore "
          "at pp=1), tp2 x fsdp2 with SP (ViT-L/16, BERT-base), ResNet-50 "
          "over fsdp and tp, fp32 against one process")
    _, launched = shard_parity(torch, cli, models, load_config,
                               apply_overrides, enc_ref, resnet_ref,
                               *group["shard"])
    for k, v in launched.items():
        launches[k] += v
    phase("40 context parallelism on a rank's heads: gpt2_owt on "
          "ulysses_flash (tp2 x cp2) and ring_pallas (tp2 x cp2, SP), "
          "Llama-300M on ulysses_flash, fp32 against one process")
    _, launched = heads_cp_parity(torch, cli, models, load_config,
                                  apply_overrides, parity,
                                  *group["heads_cp"])
    for k, v in launched.items():
        launches[k] += v
    phase("41 the compositions: ViT-L/16 at 226 tokens under cp "
          "(ring_pallas, ulysses_flash), fp32 GPT-2 with dropout at tp2 x "
          "cp2 and dp2 x fsdp2 with remat dots, bf16_full at tp2 x fsdp2, "
          "against one process; gpt2_pp's tables over pp alone")
    _, launched = composition_parity(torch, cli, models, load_config,
                                     apply_overrides, parity,
                                     group["pp_cli"][0],
                                     *group["compositions"])
    for k, v in launched.items():
        launches[k] += v
    phase("42 the explicit data-parallel sync: cli launch of 4 ranks at "
          "dcn_dp=2 with the int8 ring (gpt2_owt), then fp32 hierarchical "
          "sharded and flat bucketed, and int8, against one process")
    _, launched = dp_sync_parity(torch, cli, load_config, apply_overrides,
                                 parity, *group["dp_sync"])
    tmp4.cleanup()
    for k, v in launched.items():
        launches[k] += v
    _, launched = dp_sync_launch(torch)
    for k, v in launched.items():
        launches[k] += v
    phase("43 the serving fleet: cli serve --fleet 2 (fp pool), the "
          "role-split fleet (int8 pool, KV frames over sockets) and "
          "worker_crash on worker 0, run beside phase 34's group")
    fleet_thread.join(timeout=600)
    if fleet_thread.is_alive():
        raise AssertionError("the fleets did not finish within 600 s of "
                             "phase 42's end")
    fleet_rec, launched = check_fleets(fleet_out, fleet_refs, layers)
    for k, v in launched.items():
        launches[k] += v
    phase("44 supervised training: cli supervise under nan:5, hang:7, "
          "corrupt:6 (with telemetry) and a SIGTERM, against an "
          "undisturbed run in this process; the debug flags")
    t0 = time.perf_counter()
    ref, launched = chaos_reference(torch, cli, chaos_tmp.name)
    for k, v in launched.items():
        launches[k] += v
    debug_flags(torch, cli, pa)
    print(f"chaos check seconds: reference and debug flags "
          f"{time.perf_counter() - t0:.1f}", flush=True)
    for t in chaos_threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("the supervised runs did not finish "
                                 "within 600 s of phase 43's end")
    chaos_rec = check_chaos_train(torch, chaos_out, ref)
    del ref
    phase("45 serving chaos: worker_crash, worker_hang, conn_drop, "
          "heartbeat_stall and the exhaustion run over 2 workers")
    serve_thread.join(timeout=600)
    if serve_thread.is_alive():
        raise AssertionError("the serving chaos did not finish within "
                             "600 s of phase 44's end")
    serve_chaos_rec, launched = check_serve_chaos(serve_out, layers)
    for k, v in launched.items():
        launches[k] += v
    chaos_tmp.cleanup()
    print(f"chip_smoke: 45 phases in {time.perf_counter() - _T0:.1f} s",
          flush=True)

    # Each kernel's numbers come from its case at the main path's types.
    main_case = {"paged_decode": "bf16", "paged_decode_q8": "int8_bf16q",
                 "flash_fwd": "flash_fwd", "flash_dq": "flash_dq",
                 "flash_dkv": "flash_dkv", "fused_adamw": "fused_adamw",
                 "ring_step": "ring_step", "ring_dq": "ring_dq",
                 "ring_dkv": "ring_dkv"}
    kernels = []
    for kernel, name in main_case.items():
        r = kres[name]
        kernels.append({
            "name": kernel, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": launches[kernel],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"benchmark": bench}))
    for rec in (*encoder_bench.values(), *llama_bench.values(),
                *moe_bench.values()):
        print(json.dumps({"benchmark": rec}))
    print(json.dumps({"generate": {k: v for k, v in gen_rec.items()
                                   if k != "results"}}))
    print(json.dumps({"serving_features": features}))
    print(json.dumps({"fleet": fleet_rec}))
    print(json.dumps({"chaos": {"train": chaos_rec,
                                "serve": serve_chaos_rec}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
