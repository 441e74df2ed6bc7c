#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pq3d_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero, nothing is skipped):

1. device   -- requires CUDA; prints the card's name and power limit;
2. build    -- builds csrc/zrun_conv.cu, csrc/windowed_conv.cu and
               csrc/hungarian.cu with nvcc (sm_90a) from this checkout, one
               nvcc each, all started together, and prints the build
               seconds and each kernel's registers and spills per
               instantiation (ptxas -v);
3. kernel   -- the z-run 3^3 conv kernel (B1) against its plain PyTorch
               version at the routed shapes of the serving slice (maps from
               the port's pipeline on a full-size synthetic batch): error,
               median time over 20 launches (CUDA events), the wrapper's
               host time per call, plain time, bound, the share of the
               N x 27 slots that hold a
               reference beside the share of (tile, tap) pairs the kernel
               stages (128-row tiles) and multiplies (64-row halves), and
               TFLOP/s over both;
4. serve    -- the slice end to end: the full-width stage-1 model
               (instseg_sceneverse + pallas_conv: true, random weights from
               a seed) behind InstSegServer(batch_size=4) answers 8 scenes of
               60-80k points; checks every answer and that B1 ran exactly
               routed-convs x forwards times (and the windowed conv never);
5. check    -- the served forward against the same model with every conv on
               its plain version, on one batch;
5b. serve_layouts -- the same model at one set of random weights, level
               caps 65536 / 40960 / 16384 / 4096 / 2048 (the JAX
               package's serving bench's, which hold these scenes at every
               level), behind InstSegServer(batch_size=4) in four setups:
               rect (host maps), dev_maps (maps and the z-run plans of
               levels 1-3 built on the card from biased voxel coords, so
               B1 reads per-scene card-built plans), flat_zt (the flat pack with the z-run
               gather conv on levels 1-3) and rect on a spawn pool of
               min(4, cpu_count - 1) workers; each serves 4 warm scenes
               and phase 4's 8 and prints scenes/s, p50/p99, the stage
               seconds, host-to-device bytes a batch, peak memory, the
               map build's device ms (dev_maps, CUDA events) and B1's
               routed convs per forward and launches; then one forward of
               one batch per layout on the device clock.  Gates: every
               request resolves; B1's launches equal routed convs x
               forwards per setup, B2's are 0; on one batch the maps and z-run plans
               built on the card equal the host's key by key, exactly; dev_maps'
               served logits equal rect's within 1e-5 relative, in every
               decoder round up to a flipped attend bit (as phase 15's
               below); the flat
               forward all-plain equals the rectangular all-plain one
               within 1e-4 (segment features on each scene; class and mask
               logits in every round up to a flipped attend bit); the flat
               forward with B1 against its own
               all-plain forward within phase 5's 2e-2; the pool's
               batches equal in-process process_scene with the same
               seeds;
6. winconv  -- the windowed conv kernel (B2), which no model calls, on the
               served batch's coordinates rebuilt level by level and put in
               Morton order per scene: per level the host seconds of
               morton_order, build_window_map (tile 256, window 512) and
               fold_exceptions, the out-of-window share of the references,
               the extra slab rows a tile (X, padded, and the most and mean
               a tile needs) and the share of (16-row, tap) pairs the
               kernel multiplies; at every routed (level, Cin, Cout) and at
               one 5^3 case (K = 125, L0, 32 -> 32) the kernel against its
               plain version, the plain version over JAX's plan and the
               gather conv (within 1e-3), the wrapper's and the launch's
               median ms over 20 calls, the plain version's over 5, the
               bound, the shared memory a block takes and B1's ms from
               phase 3 beside B2's; the launches must equal the calls;
7. kernel_bwd -- B1's backward (dx: the same kernel on the masked dy with W
               flipped and transposed; dW: the plain re-gather) through its
               autograd Function against the plain backward, at the routed
               shapes of a full-size training batch: error, the dx kernel's
               median ms over 20 launches, its host time per call, plain
               ms, bound, the slot and (tile, tap) shares as in phase 3,
               and the dW re-gather's ms beside its bound;
8. train    -- stage-1 training end to end: pq3d_tpu_torch.run builds the
               trainer (instseg_sceneverse + pallas_conv: true, batch 4 of
               synthetic 70k-point scenes, AdamW); 1 warm step, 5 timed
               steps (loss, grad norm, host-pipeline s, device ms per step;
               steps/s, scenes/s, peak memory; per step the level rows,
               B1's forward and dx launches, each of which must sum to the
               routed convs of every step's own batch, the assignment
               kernel's launches, which must be one a step (the set loss
               matches on the card), and the z-run gather conv's calls),
               then 5 steps on one batch, whose loss (train mode, dropout
               off, read before and after them) must fall;
8b. assign -- the set loss's assignment kernel (csrc/hungarian.cu, one
               warp a (round, scene) lane; the counterpart of the JAX
               package's lax.while_loop solver, no Pallas kernel) at full
               width, 52 lanes of 120 x 120 (13 rounds x 4 scenes), on
               (i) the costs the set loss builds from phase 8's batch
               (its forward in eval mode), (ii) random costs with 20
               padded rows a lane at PAD_COST and (iii) the same with
               every query column tied (a round of identical queries);
               gates: the set loss on (i) runs under
               torch.cuda.set_sync_debug_mode("error") (no host sync) with
               one launch, col4row and each lane's Dijkstra steps equal to
               the plain version's (on a CPU copy) on every row of every
               lane, every lane a permutation, the real rows' cost within
               1e-5 relative of scipy's on the real rows alone (or, beside
               padded rows, 1 f32 ulp of PAD_COST a real row:
               ASSIGN_ULPS), the launches equal to the calls; prints the kernel's median ms
               over 20 CUDA-event pairs, the wrapper's host us a call, the
               parent's path (the copy to the host, one scipy call a lane,
               the assignment back) in ms, the plain version's ms, the
               bound (bytes) and the steps a lane (max, mean);
9. train_check -- one train step (dropout off) with B1 against the same
               step all-plain (loss) and with every backward on its plain
               version (routed-conv weight gradients), and each routed conv
               replayed at the step's own x and dy against its plain
               backward, all within 2e-2;
9b. flat_train -- phases 8 and 9 again for the published training layout:
               the trainer that pq3d_tpu_torch.run builds with
               data.instseg_options.flat_pack=true and ztriple_conv=true
               (the flat pack, B1 on the flat totals it routes, the z-run
               gather conv with its backward on levels 1-3), the same
               scenes, seed and batch; phase 8's figures printed beside
               its own; gates: phase 8's (B1's launches against the routed
               convs at each step's flat totals, the loss on one batch
               falls, the assignment kernel once a step) and phase 9's,
               the z-run gather conv forward and backward in every step,
               and one step all-plain in f32
               (TF32, dropout and the self-mask off, direct criterion) on
               one batch collated in both layouts: the flat loss within
               1e-4 relative of the rectangular one, and the gradients,
               normalised by their largest entry, within 1e-4;
9c. dev_train -- stage-1 training with the maps built on the card
               (the JAX package's model builds them inside its train step
               too): phase 8's trainer, scenes, seed and batch in dev_maps
               (maps and the z-run plans of levels 1-3 built on the card
               at phase 5b's level caps) and dev_flat_zt (the flat maps
               and plans at a lock derived from the training scenes, margin
               1.5), 2 timed steps each: loss, grad norm, steps/s, device
               ms a step, peak memory, the map build's device ms; gates:
               B1's forward and dx launches equal the routed convs of
               every step at the built maps' rows, the assignment kernel
               once a step, phase 9's train_check (2e-2), and on one batch
               all-plain in f32 (TF32, dropout and the self-mask off,
               direct criterion) the step on maps built on the card
               against the step on the host's maps of the same scenes
               (rect and flat_zt): loss within 1e-4 relative, gradients
               normalised by their largest entry within 1e-4; dev_gather
               and dev_flat_swin take one step each with a finite loss and
               finite gradients;
10. unified -- stage-2 serving end to end: the full-width
               unified_tasks_sceneverse model (PointNet++ on 80 objects x
               1024 points, the CLIP-large text tower, the mixed query
               decoder, the grounding head, T5-small greedy decode of 50
               tokens; random weights from a seed) behind
               UnifiedServer(batch_size=8) answers 32 requests that cycle
               through SyntheticRefer, SyntheticQA and SyntheticCaption
               (scenes of 50,000 points, 32 instances; TXT and LOC
               prompts): scenes/s, p50/p99, the server's stage seconds,
               peak memory, the device-clock ms (CUDA-event spans around
               each module, median of 3 forwards of one batch) of
               PointNet++, the CLIP tower, the query decoder and the
               decode; gates: every request
               resolves, ground_obj is a valid object with a finite score,
               tokens are EOS-frozen (also on one batch decoded with the
               EOS logit raised until some row emits it early, since
               random weights do not), on one batch the card's
               ground_logits and teacher-forced generation logits agree
               with the same model on the CPU (f32, TF32 off) within 1e-4
               relative while the same batch with TF32 on (the control,
               printed) does not, and the greedy tokens are equal or
               differ first where the CPU's top-2 logit margin is below
               1e-4; B1 and B2 are on no stage-2 path (their launches
               here are printed);
11. unified_train -- stage-2 training end to end: the trainer that
               pq3d_tpu_torch.run builds (build_multitask_trainer) for
               unified_tasks_sceneverse at its widths and batch (128) on
               SyntheticRefer, SyntheticQA and SyntheticCaption (scenes of
               50,000 points, 32 instances; warmup set to 0); one epoch of
               6 steps (1 warm, 5 timed) with the loaders in process
               (num_workers=0), then one with one spawn pool of
               min(8, cpu_count - 1) workers: per step the loss parts, the
               gradient norm, the host pipeline's seconds and the device
               ms of forward, loss, backward and optimizer (CUDA events);
               steps/s, items/s, peak memory; gates: finite losses, the
               generation head's AdamW groups at 1e-5 beside 1e-4, B1 and
               B2 launched 0 times, one batch's loss (every dropout and
               memory dropout off) falls over 5 steps on it; one step at
               batch 4 on the card against a deep copy on the CPU (f32,
               TF32 off: loss parts within 1e-5, gradient norm 1e-4, all
               gradients together within 1e-3 in L2, every updated
               parameter within 2.1 x the rate; the updates' L2 printed)
               and a TF32 control that must exceed a gate; then
               every val set evaluated (132 items each,
               the last batch wrap-padded to 128), every item scored once;
12. recipe -- the JAX package's two-stage recipe (tools/dress_rehearsal.py)
               on files in the SceneVerse layout: write_replica writes 8 + 2
               scans at real-scan statistics (150,000 points, 28 objects
               plus wall, floor and ceiling, 8 annotations a task a scan;
               seconds, bytes, voxels, segments and instances a scan);
               through pq3d_tpu_torch.run: stage 1 (instseg_sceneverse,
               pallas_conv: true, offline segment features) for one epoch
               at batch 4 with the official-protocol eval at full
               resolution, its resume for a second epoch, the GT-query
               variant (instseg_sceneverse_gt) for 2 steps, and stage 2
               (unified_tasks_sceneverse at its widths, batch 8, the seven
               SceneVerse datasets with predicted objects) warm-started from
               stage 1's checkpoint for one epoch with every dataset's
               evaluator; per run the seconds, steps/s, host-pipeline
               seconds a batch, peak memory and B1's launches, which must
               equal the routed convs of every forward (forward) and of
               every train forward (dx), and the assignment kernel's,
               which must be one a set loss (every stage-1 train step and
               eval forward), 0 under the GT variant's direct criterion
               and on stage 2; gates: finite metrics, no metric
               lost across the resume, every GT batch with its offline
               mask, a finite direct loss, train_check (phase 9) on a GT
               batch, the warm start loading RECIPE_WARM_START_LOADED
               tensors, finite metrics of all seven datasets; B1 against its
               plain version at the routed shapes of 4 replica scans, with
               its ms a forward beside phase 3's;
13. ddp    -- data parallelism through the launcher, in two launches whose
               ranks run their runs one after another: ``python -m
               pq3d_tpu_torch.launch --nproc-per-node 2 --backend gloo
               --devices cuda:0,cuda:0`` (two ranks on the one card: nccl
               refuses that) runs stage 1 (DDP_STAGE1: phase 8's trainer,
               full width, 70k-point scenes, a global batch of 4), phase
               20's stage 1 under FSDP, stage 2 (DDP_STAGE2:
               unified_tasks_sceneverse at its widths and batch of 128, 64
               a rank) and phase 20's stage 2 under tensor parallelism;
               one nccl rank runs stages 1 and 2; 2 steps a run
               (STAGE_STEPS; the epochs have 4 and 3), stage 2 with the
               synthetic tokenizer named in the config (the YAML's HF
               names fall back to it on a host without their files).
               Every stage-1 run reads a user config by path
               (``--config-name`` relative to the ranks' working
               directory; the launcher makes it absolute): the packaged
               instseg_sceneverse.yaml written to a file with its name an
               embedded interpolation and its eval batch 4
               (USER_CONFIG_EDITS).  While the launches run, this process
               makes phase 19's exports (host work).  Each launch prints
               rank 0's wall split (the launcher's start, the rank's
               interpreter, imports, group init, the entry's imports, the
               runs, the exit), each run its own (config, model build,
               datasets and loaders, the first batch, step 1, the timed
               steps, the end).  A run ends after its steps as a
               preemption ends it, with its checkpoint saved.  In each rank
               (``ddp_rank``) step 1 runs all-plain in f32 with dropout
               and the self-mask off, and the later steps are the main
               path: B1's counts are set to 0 after step 1 and read after
               the last.  Gates: both ranks end with equal weight
               checksums (and the checkpoint's), step 1's logged global
               loss of the two ranks within DDP_GATE of the one rank's, B1
               launched forward and dx in each stage-1 rank as often as
               its rows route (and never on stage 2), rank 0's B1 against
               its plain version at its last batch's routed shapes, the
               assignment kernel once a step in each stage-1 rank and never
               on stage 2, every
               rank's resolved config and the run's config.json equal to
               the packaged config with USER_CONFIG_OVERRIDES (the file
               read, its interpolation resolved);
               printed: steps/s of 2 ranks against 1, peak memory per
               rank, the synced batch norms' all-reduces a step and their
               share of it.  Then ReplicatedServer with two stage-1
               replicas on cuda:0 against one InstSegServer on 8 scenes
               (phase 5b's caps, exact FPS): every answer, both replicas
               busy, each scene's final logits within REPLICA_GATE with
               the decoder's self-mask off (with it on, segment pooling's
               atomic sums flip attend bits: printed, not gated);
14. unified_variants -- the rest of stage 2 at the widths of
               unified_tasks_sceneverse (random weights from a seed), B1
               and B2 counted from 0 over (a) and (b) and gated at 0.
               In (c), first, the model of
               model.obj_loc.pairwise_rel_type=vertical_bottom: one forward
               of a batch of 8 against the same model and weights with
               center: ground, teacher-forced and token outputs
               bit-equal (the model passes no box sizes, as JAX's).
               (a) The model with heads [ground, generation, qa] (8864
               answers) behind UnifiedServer(batch_size=8), 8 warm and 32
               timed requests of phase 10's kind, in the JAX package's
               bench.py setups: f32 (padded, one phase), bf16
               (cast_model_bf16 + cast=cast_batch_bf16), two_bf16
               (two_phase + the cast) and flat_bf16 (flat_obj + the cast):
               scenes/s, p50/p99, stage seconds, peak memory, one batch's
               forward and decode ms on the device clock, and the flat
               layout's F against B x O; gates: every request resolves,
               answer_scores finite and (8, 8864) on one batch of each
               setup, in f32 on one batch flat against padded within 1e-5
               (ground, teacher-forced generation and answer logits) with
               equal tokens, two-phase tokens equal to one-phase tokens in
               f32 and in bf16, bf16 against f32 within
               tests/test_bf16_modes.py's gate (0.1 of the scale, top-1
               equal where the margin exceeds 0.03 of it).  (b) The same
               model with qa_num_answers 3 (SyntheticQA's vocabulary) and
               flat_obj trained through build_multitask_trainer on
               SyntheticQA and SyntheticRefer at batch 32: 1 warm + 3 timed
               steps (loss parts, F, host and step seconds, peak memory),
               answer_loss finite, one step at batch 4 of SyntheticQA
               items against the CPU within phase 11's gates (and its TF32
               control), ScanQAEval's acc@1 / acc@10 finite.  (c) One
               batch of 8 on the card against the CPU (f32, TF32 off,
               1e-4): the gate structure with the attention text
               projection and IMAGE prompts (768 wide, rows 0, 3, 6), and
               BERTLanguageEncoder; the CLIP-large text encoder at
               compute_dtype bfloat16 against float32 within
               test_bf16_modes' tower tolerance (max 0.05, mean 0.005);
               PointnetSAModuleVotes (rbf pooling, unique counts) on two
               1024-point clouds: indices and counts equal, features within
               1e-4;
15. swin_layouts -- the Swin3D backbone, the flat device maps and the
               stage-1 bf16 serving cast: the full-width swin model
               (instseg_sceneverse's widths with PCDMask3DSwin3DEncoder:
               channels 48/96/192/384, depths 2/2/6/2, window 4; random
               weights from a seed) behind InstSegServer(batch_size=4) in
               flat_swin (host flat maps and window packs), dev_flat_swin
               (the flat maps and packs built on the card at a lock that
               device_flat_lock derives from the largest scene x 4, margin
               1.3) and flat_swin_bf16 (cast_model_bf16 + cast_batch_bf16),
               and phase 5b's Res16UNet in dev_flat_zt (flat maps and z-run
               plans built on the card, B1 routed) and flat_zt_bf16; each
               serves phase 5b's 4 warm scenes, then 8 timed ones (2
               batches, all queued at once, so p50/p99 include the queue)
               and prints scenes/s, p50/p99, the stage seconds,
               host-to-device bytes a batch, the flat map build's device
               ms, peak memory and B1's launches, then one forward of one
               batch per setup on the device clock, split into backbone,
               window attention (summed over blocks) and the rest.  Gates:
               on one batch the flat maps built on the card equal
               collate_flat's key by key, exactly, for swin (hierarchy and
               the 8 window packs) and for the dense-block stem with the
               z-run plans; dev_flat_swin's served logits equal flat_swin's
               within 1e-5 and dev_flat_zt's forward flat_zt's; four served
               scenes' full-width swin forward on the card equals the
               CPU's (segment features, class and mask logits; TF32 off)
               within 1e-3 with the sparse convs in f32 compute, and within
               4 x 2^-8 as served, with bf16 conv operands; these logits
               are compared in every decoder round, each scene up to the
               first attend bit (sigmoid of a mask logit >= 0.5, the next
               round's self-mask) that differs between the two sides, where the
               forwards part by more than rounding (the flips and the final
               round's reading printed); flat_swin_bf16 against flat_swin
               and flat_zt_bf16 against flat_zt on one batch, four
               forwards, in the same rounds, since the cast's rounding
               flips attend bits too: class logits within
               tests/test_bf16_modes.py's gate (0.1 of the scale, top-1
               equal where the margin exceeds 0.03 of it), mask logits
               within 0.2 (their level-0 segment mean is summed in bf16, in
               another order each run; see SWIN_GATES), the final round,
               every served batch's final round and weight seeds 1 and 2
               printed; B1 launches routed convs x forwards in dev_flat_zt and flat_zt_bf16 and 0 times in the
               swin setups, B2 0 times;
               ``python -m pq3d_tpu_torch.run --config-name
               instseg_swin3d_synthetic`` trains 3 steps and evaluates on
               the card with finite losses and metrics, and one step of its
               trainer matches the CPU through gate_train_check (every conv
               plain in f32, self-mask off; the TF32 control exceeds a
               gate);
16. conv_options -- the voxel encoder's remaining conv options at the
               slice's widths (instseg_sceneverse + pallas_conv: true,
               random weights from a seed), phase 5b's scenes and caps:
               InstSegServer(batch_size=4) serves 4 warm and 8 timed
               scenes in rect, rect_int8 (grad_mode native + int8_gather),
               rect_sorted (sorted_gather), flat_compact (the flat pack with
               compact_conv) and flat_compact_int8, printing scenes/s,
               p50/p99, the stage seconds, peak memory and one forward of
               one batch on the device clock; B1 launches the routed convs
               of every forward in the rect setups and never in the compact
               ones (JAX switches its kernel off for compact plans).  Gates
               on one batch, every decoder round up to a flipped attend bit:
               rect_sorted's U-Net features bit-equal to rect's (and rect's
               to a repeat of itself) and its logits within 1e-5;
               flat_compact within 5e-3 of the scale of rect's; each int8
               setup within 5e-2 of its f32 twin; the card's rect_int8
               forward of one scene within 2e-2 of the CPU's (TF32 off).
               InstSegEval(use_dbscan=True) splits one served batch's
               masks at full resolution (host seconds).  Training through
               the trainer run.py builds (70k-point scenes, batch 4):
               level_cap_ladder [3/4 of the caps, the caps] with 3 steps on
               a batch of smaller scenes (the lower rung) and 3 on phase
               5b's (the upper; both without augmentation, which would move
               a batch across rungs), B1 forward and dx at each; the flat
               pack with compact_conv under scatter_free, 3 steps through
               sparse_conv_compact_sym and no B1; grad_mode native with
               remat_policy full (profile: true, profile_wait 1,
               profile_active 1: its trace must hold CUDA kernels) and with
               none on the same 3 batches, full's peak memory below none's;
17. gather_stem -- the 125-tap gather stem (the JAX pipeline's default)
               at the slice's widths, phase 5b's scenes and caps:
               InstSegServer(batch_size=4) serves 4 warm and 8 timed
               scenes in rect_gather (nbr5_0 built by the host) and
               dev_gather (nbr5_0 and every other map built on the card),
               printing scenes/s, p50/p99, the stage seconds,
               host-to-device bytes a batch, peak memory and B1's
               launches (the routed convs of every forward); one forward
               of one batch per setup (5 runs) and conv0 alone (gathered,
               and the dense-block stem on the same scenes; 9 runs) on the
               device clock, median, least and most, and one traced call
               of each forward and of conv0, its device busy ms against
               the host clock.  Gates: on one batch the maps built on the
               card equal the host's bit for bit (nbr5_0 included);
               dev_gather's served logits within 1e-5 of rect_gather's
               and rect_gather's within 2e-5 of the dense-block rect's on
               the same weights
               and scenes with every conv plain in f32, each in every
               decoder round up to a flipped attend bit.  Training through
               the trainer run.py builds with stem_mode gather: 3 steps
               (device ms, peak memory, B1 forward and dx), then one step
               all-plain f32 against the dense-block stem's on the same
               batch within 1e-4 (loss and gradients);
18. reference_warm_start -- a reference-named state_dict of a full-width
               stage-1 model (ME U-Net kernels and BN statistics,
               feat_proj_list, the unified encoder with in_proj fused, the
               mask head, every other key under DDP's module. prefix;
               tools/torch_reference_names.py) saved as pytorch_model.bin,
               then python -m pq3d_tpu_torch.run --config-name
               instseg_sceneverse pretrain_ckpt_path=<dir> (in this
               process) takes 2 steps on the card.  Gates: the import's
               report loads every leaf, with nothing mismatched or unused;
               every warm-started tensor on the card equals its source bit
               for bit; the first loss is finite; B1 runs forward and dx;
               the assignment kernel launches once a step;
19. export -- (run right after phase 13, whose launches its exports run
               beside) pq3d_tpu_torch.export (torch.export artifacts; B1
               is the operator pq3d::zrun_conv): (i) the slice's full-width
               stage-1 model (phase 5b's caps, random weights from a seed,
               rect) is exported on the CPU, on the batch of 4 of phase
               5b's first timed scenes, by a second process that sees no
               card and takes two host threads (``chip_smoke.py
               --export-stage1 PATH``, run while this one exports stage 2),
               written to a temporary file and loaded with device="cuda";
               gates: the graph holds one pq3d.zrun_conv node
               per routed conv, the loaded program launches B1 that often a
               forward over 1 + 3 forwards and B2 never, its logits equal
               the eager card forward's within 1e-5 in every round up to a
               flipped attend bit; (ii) unified_tasks_sceneverse at its
               widths exported on the card on a batch of 8 of phase 10's
               requests and run as exported, in memory (stage 1 carries
               the save and load round trip): tokens equal to eager's,
               ground_logits within 1e-5; then the same model with
               early_exit=True (its decode one torch.while_loop) exported
               the same way: the graph holds the loop, its tokens equal the
               eager early-exit decode's and the fixed-length program's;
               it prints the eager early-exit call's seconds (the loop's
               capture included) and one forward's ms exported early-exit
               against exported fixed-length (CUDA events, median of 3);
               each prints the export seconds,
               graph nodes, stage 1's artifact MiB and load (and move)
               seconds and one forward's ms exported against eager (CUDA
               events, median of 3); (iii) VoxelLevelEncoder (hidden 768) on (i)'s batch with
               B1 against all-plain within 2e-2, B1 launched once per routed
               conv; every timing runs after the CPU process has ended;
20. mesh    -- (run after phase 19; it reads phase 13's records) the
               data x fsdp x tp mesh (parallel/mesh.py, parallel/tp.py)
               on 2 gloo ranks on cuda:0, in phase 13's 2-rank launch
               (whose allocator has expandable segments, MESH_ALLOC_CONF),
               reusing phase 13's numbers: (i) phase 13's stage-1 run with
               parallel.fsdp=2, 2 steps (step 1 all-plain in f32, dropout
               and self-mask off); gates: step 1's global loss within
               DDP_GATE of phase 13's one nccl rank, B1 forward and dx once
               per routed conv in each rank in step 2 and B2 never, the
               assignment kernel once in each rank in step 2, B1 against
               its plain version at rank 0's last routed shapes,
               the gathered weights' checksums equal on both ranks and in
               the checkpoint; prints each rank's parameter bytes on the
               card beside the full model's, steps/s beside phase 13's
               2-rank DDP and the peak a rank; (ii) phase 13's stage-2 run
               with parallel.tp=2, 2 steps; gates: step 1's loss within
               DDP_GATE of phase 13's one rank, the tp peers' replicated
               weights' checksums equal, B1 and the assignment kernel
               never; prints the tensor-
               parallel collectives a step and their share of it; (iii)
               InstSegServer(mesh=["cuda:0", "cuda:0"], batch_size=4) on
               phase 5b's 8 timed scenes against one server, the
               decoder's self-mask off in both (all-plain: final logits
               within REPLICA_GATE; as built: within MESH_BUILT_GATE, B1
               launched once per routed conv of each part's forward, each
               part routing by its own rows, and B1 against its plain
               version at one part's routed shapes), and UnifiedServer
               with the same mesh on 8 of phase 10's requests (tokens
               equal to one server's); prints scenes/s;
The phases run in the order 1-8, 8b, 9-13, 19, 20, 14-18, each ending
with a ``timing: phase N`` line.  Then two summary lines (B1 against B2
in this run; the assignment kernel against the parent's host path, and
its launches by path), one JSON line with every hand kernel's numbers,
and the result line.

    python3 chip_smoke.py --profile PATH

adds torch.profiler traces of one served forward (after phase 5), of one
forward per layout (phase 5b), of one train step after phase 9 and one
after phase 9b, of one unified batch (forward and decode, phase 10) and
of one unified train step (phase 11): device busy time against the host
clock, the idle share and the device time by kernel (the top rows
printed, the whole tables written to PATH and to PATH with ``_rect``,
``_dev_maps``, ``_flat_zt``, ``_train``, ``_flat_train``, ``_unified``
and ``_unified_train`` before its extension).
"""
import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published peaks (dense bf16 tensor-core rate, device-memory rate)
PEAKS = {"H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}


def fail(msg):
    """Print ``msg`` on both streams (a caller that keeps only the end of
    one still reads why) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def peaks_for(name):
    for key, val in PEAKS.items():
        if key in name:
            return val
    fail(f"no published peak rates for {name!r}")


def cuda_time(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    times = cuda_times(fn, reps)
    return times[len(times) // 2]


def cuda_times(fn, reps):
    """Milliseconds of each of ``reps`` runs of ``fn`` (CUDA events),
    sorted."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)


def host_time(fn, reps):
    """Host milliseconds per call of ``fn`` over ``reps`` calls back to
    back, the device left to run behind them: what a call costs the host
    (its checks, casts, launches), not the device."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def settle(srv, scenes):
    """Wait (bounded) until the server's worker has booked ``scenes``: it
    resolves the futures first and updates its stats just after."""
    deadline = time.time() + 30
    while srv.stats.scenes < scenes and time.time() < deadline:
        time.sleep(0.01)
    if srv.stats.scenes < scenes:
        fail(f"server booked {srv.stats.scenes} of {scenes} scenes")


def level_rows(batch):
    """Flat rows per hierarchy level of a collated (numpy or torch) batch."""
    return [math.prod(batch["maps"][f"valid_{l}"].shape) for l in range(5)]


def batch_rows(model, batch):
    """Flat rows per level of the maps that ``model``'s forward of
    ``batch`` runs on: the batch's host maps, or the static shapes of the
    maps it builds on the card (the flat lock's totals, or the level caps
    times the batch)."""
    ve = model.voxel_enc
    if ve.device_flat_caps is not None:
        caps = dict(ve.device_flat_caps)
        return [caps[f"tot_{l}"] for l in range(5)]
    if ve.device_maps is not None:
        return [batch["vox_coords"].shape[0] * c for c in ve.device_maps]
    return level_rows(batch)


def make_scenes(n, seed):
    import numpy as np
    from pq3d_tpu_torch.data import synthetic
    rng = np.random.default_rng(seed)
    scenes = [synthetic.make_scene(rng, n_points=60_000 + 5000 * (i % 5),
                                   n_instances=24, n_segments=400)
              for i in range(n)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 199)
    return scenes


def profile_run(fn, label, path=None, top=12):
    """Trace one call of ``fn`` (after a warm one): device busy ms (the
    union of kernel intervals) against the host clock, and device ms by
    kernel (the ``top`` rows printed, the whole table written to ``path``
    when given).  Returns (host ms, device busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        fail("the profiler recorded no device time")
    busy_us, end = 0.0, -math.inf
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time
    by_name = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    print(f"profile: {label} {wall_ms:.1f} ms (host clock), device busy "
          f"{busy_us / 1e3:.1f} ms ({len(spans)} kernels), idle share "
          f"{1 - busy_us / 1e3 / wall_ms:.3f}", flush=True)
    for name, us in by_name[:top]:
        print(f"profile:   {us / 1e3:8.3f} ms  {name[:100]}", flush=True)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for name, us in by_name:
                f.write(f"{us / 1e3:.4f}\t{name}\n")
            f.write(prof.key_averages().table(sort_by="device_time_total",
                                              row_limit=60))
    return wall_ms, busy_us / 1e3


def rel_err(got, ref):
    """max|got - ref| / max|ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-12)).item()


def zrun_plan_bytes(n, with_valid):
    """Bytes of the z-run plan (zbase int32, zcode int8) and the mask."""
    return n * 9 * 4 + n * 27 + (n if with_valid else 0)


def tap_shares(zrun_conv, zc):
    """(slots, staged, multiplied): the share of the N x 27 slots that
    hold a reference, and of the (tile, tap) pairs B1 stages (its 128-row
    tiles) and multiplies (each warpgroup's 64 rows), from the plan."""
    slots = (zc != -2).sum().item() / (zc.shape[0] * 27)
    staged = zrun_conv.tile_tap_mask(zc, zrun_conv.TILE).float().mean().item()
    mult = zrun_conv.tile_tap_mask(zc, zrun_conv.MMA_ROWS).float().mean()
    return slots, staged, mult.item()


def ptxas_summary(log, kernel, scale=1):
    """'Cout: registers / spill bytes' of each instantiation of ``kernel``
    in the ptxas -v log of its build (the template argument times
    ``scale`` is the Cout it takes)."""
    import re
    out, cout = [], None
    for line in log.splitlines():
        m = re.search(kernel + r"ILi(\d+)E(?:Lb(\d)E)?", line)
        if m and "Compiling entry" in line:
            cout = int(m.group(1)) * scale
            if m.group(2) is not None:      # the assignment kernel's STAGED
                cout = f"{cout} {'staged' if m.group(2) == '1' else 'global'}"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cout is not None:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cout is not None:
            out.append(f"{cout}: {m.group(1)} reg / {spill} B spill")
            cout = None
    return out


def conv_bound(n, cin, cout, pairs, plan_bytes, flops_peak, bw_peak,
               taps=27):
    """(bound ms, what bounds it, flops, bytes) of one sparse conv: the
    valid references' bf16 products over the tensor-core peak against
    reading x (f32), W (bf16) and the plan once and writing y (f32)."""
    flops = 2.0 * pairs * cin * cout
    nbytes = (n * cin * 4 + taps * cin * cout * 2 + plan_bytes
              + n * cout * 4)
    return bound_of(flops, nbytes, flops_peak, bw_peak) + (flops, nbytes)


def bound_of(flops, nbytes, flops_peak, bw_peak):
    """(the larger of the two times in ms, which of them it is)."""
    t_ops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes")


# the published training layout (instseg_sceneverse.yaml's comment): the
# flat pack with the z-run gather conv
FLAT_ZT = ("data.instseg_options.flat_pack=true",
           "data.instseg_options.ztriple_conv=true")


def smoke_trainer(exp_dir, *layout):
    """The stage-1 trainer as ``python -m pq3d_tpu_torch.run`` builds it:
    the slice config at full width, batch 4 (the YAML's), AdamW, on
    SyntheticInstSeg scenes of 70k points, 24 instances, 400 segments;
    ``layout`` adds overrides (``FLAT_ZT``)."""
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.config import load_config
    cfg = load_config("instseg_sceneverse", [
        "model.voxel_encoder.args.pallas_conv=true",
        "data.train=[SyntheticInstSeg]", "data.val=[SyntheticInstSeg]",
        "data.synthetic.num_train=20", "data.synthetic.num_val=4",
        "data.synthetic.n_points=70000", "data.synthetic.n_instances=24",
        "data.synthetic.n_segments=400", "log_every=1", "device=cuda",
        f"exp_dir={exp_dir}", *layout])
    return run.build_instseg_trainer(cfg)


@contextlib.contextmanager
def dropout_off(model):
    """Every dropout of ``model`` at rate 0 inside the block, memory
    dropout (the query decoder's) included."""
    import torch
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    rates = [m.p for m in drops]
    layers = [m for m in model.modules() if hasattr(m, "memory_dropout")]
    mem_rates = [m.memory_dropout for m in layers]
    for m in drops:
        m.p = 0.0
    for m in layers:
        m.memory_dropout = 0.0
    try:
        yield
    finally:
        for m, p in zip(drops, rates):
            m.p = p
        for m, p in zip(layers, mem_rates):
            m.memory_dropout = p


@contextlib.contextmanager
def all_plain(model):
    """Every conv of ``model`` plain in f32 (TF32 off), its dropout, memory
    dropout and decoder self-mask off inside the block: the setting in
    which two runs that sum the same numbers in another order agree to
    float rounding (phase 9b's)."""
    import torch
    from pq3d_tpu_torch.ops import sparse
    backbone = getattr(getattr(model, "voxel_encoder", None), "backbone",
                       None)
    encoder = model.unified_encoder
    routed = hasattr(backbone, "pallas_conv")    # the swin U-Net has none
    saved = (sparse._round, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, encoder.use_self_mask,
             backbone.pallas_conv if routed else None)
    sparse._round = lambda t, dtype: t.float()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    encoder.use_self_mask = False
    if routed:
        backbone.pallas_conv = False
    try:
        with dropout_off(model):
            yield
    finally:
        (sparse._round, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, encoder.use_self_mask) = saved[:4]
        if routed:
            backbone.pallas_conv = saved[4]


def batch_loss(trainer, b):
    """The loss of the device batch ``b`` in train mode (BatchNorm on the
    batch's own statistics) with dropout off, no gradient, no update."""
    import torch
    with dropout_off(trainer.model), torch.no_grad():
        trainer.model.train()
        total, _ = trainer.loss_fn(trainer.model(b), b)
    return total.item()


PLAN_KEYS = ("win_lo", "nbr_local", "exc_in_k", "exc_row_tile",
             "exc_src_tile")         # build_window_map's plan, as JAX's


# the JAX package's full-size serving caps (tools/bench_serve.py): unlike
# the YAML's they hold the synthetic scenes at every level, which maps built
# on the card need (their shapes are the caps; collate refuses a scene
# that outgrows one)
LAYOUT_CAPS = [65536, 40960, 16384, 4096, 2048]
LAYOUT_GATE = {"dev_maps": 1e-5, "flat_plain": 1e-4}


def tree_nbytes(tree):
    """Bytes of the numpy arrays in a (nested) batch dict."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.nbytes


def level_counts(scene, voxel_size):
    """True voxels per hierarchy level of one raw scene (voxelize, then
    halve the coordinates level by level)."""
    import numpy as np
    from pq3d_tpu_torch.ops import voxelize
    coords = voxelize.quantize(scene["points"].astype(np.float32),
                               voxel_size)[0]
    out = [len(coords)]
    for _ in range(4):
        coords = np.unique(coords >> 1, axis=0)
        out.append(len(coords))
    return out


def per_scene_rel(got, ref, valid=None):
    """max over scenes of max|got - ref| / max|ref| within each scene
    (``valid`` masks the compared entries)."""
    worst = 0.0
    for i in range(ref.shape[0]):
        g, r = got[i].float(), ref[i].float()
        if valid is not None:
            g, r = g[valid[i]], r[valid[i]]
        worst = max(worst, rel_err(g, r))
    return worst


SERVE_EXTRA = {"mv": 768, "pc": 768}   # phase 4's offline segment features
# serve_instseg's straggler wait: every request is queued at once, so a
# batch fills at once; a long wait keeps a stalled submitting thread from
# splitting the first batch (runs that are compared batch by batch must
# batch alike)
SERVE_HOLD_S = 5.0


def serve_instseg(phase, label, model, pipe, warm, scenes, card, build,
                  ve=None, cast=None, num_workers=0, rounds=False):
    """``warm``, then ``scenes`` timed, through InstSegServer(batch_size=4)
    with phase 4's extra features, the voxel encoder settings ``ve`` (the
    model's own by default) and ``cast``.  Every answer is checked; B1
    must launch the routed convs of each forward (warm and timed) and B2
    never.  Prints and returns scenes/s, p50/p99, the stage seconds,
    host-to-device bytes a batch, peak memory and the median device ms
    (CUDA events) of the map builder ``build`` = (module, name) a batch,
    with each batch's final (class, mask) logits and segment mask, with
    ``rounds`` every decoder round's (class, mask) logits, and, on a pool,
    each preprocessing call's scenes, first seed and batch."""
    import numpy as np
    import torch
    from pq3d_tpu_torch import serve as serve_mod
    from pq3d_tpu_torch.ops import windowed_conv, zrun_conv
    from pq3d_tpu_torch.serve import InstSegServer

    class Recording(InstSegServer):
        def __init__(self, *a, **k):
            self.logits, self.pre = [], []
            super().__init__(*a, **k)

        def _forward(self, batch):
            cls_l, mask_l = super()._forward(batch)
            self.logits.append((cls_l, mask_l, batch["seg_pad_masks"]))
            return cls_l, mask_l

        def _preprocess(self, scenes):
            self.pre.append((list(scenes), self._pool_seed))
            return super()._preprocess(scenes)

    backbone = model.voxel_encoder.backbone
    own_ve = model.voxel_enc
    ve = ve or own_ve
    expected, h2d, builds, np_batches, kept = [], [], [], [], []

    def count(mod, args):
        b = args[0]
        if ve.device_flat_caps:
            rows = [dict(ve.device_flat_caps)[f"tot_{l}"] for l in range(5)]
        elif ve.device_maps:
            rows = [b["vox_coords"].shape[0] * c for c in ve.device_maps]
        else:
            rows = level_rows(b)
        compact = "cmp0_in" in (b.get("maps") or {})
        expected.append(len(backbone.routed_convs(rows, compact=compact))
                        if hasattr(backbone, "routed_convs") else 0)

    def wrap_put(orig):
        def put(np_batch, device):
            h2d.append(tree_nbytes(np_batch))
            if num_workers:
                np_batches.append(np_batch)
            return orig(np_batch, device)
        return put

    def wrap_build(orig):
        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(*a, **k)
            e1.record()
            builds.append((e0, e1))
            return out
        return timed

    model.voxel_enc = ve
    hooks = [model.register_forward_pre_hook(count)]
    if rounds:
        hooks.append(model.register_forward_hook(
            lambda mod, args, out: kept.append(
                (out["predictions_class"], out["predictions_mask"]))))
    srv = Recording(model, pipe, batch_size=4, num_classes=200, topk=100,
                    max_delay_s=SERVE_HOLD_S, extra_features=SERVE_EXTRA,
                    device="cuda", num_workers=num_workers, cast=cast)
    try:
        with patched(serve_mod, "to_device", wrap_put), \
                patched(build[0], build[1], wrap_build):
            zrun_conv.reset_counts()
            windowed_conv.reset_counts()
            for f in [srv.submit(s) for s in warm]:
                f.result(timeout=900)
            settle(srv, len(warm))
            if zrun_conv.launches != sum(expected) or windowed_conv.launches:
                fail(f"{phase}: {label}: warm-up ran zrun_conv "
                     f"{zrun_conv.launches} times (routing expects "
                     f"{expected}), windowed_conv {windowed_conv.launches}")
            srv.stats = type(srv.stats)()
            for log in (expected, h2d, builds, np_batches, kept,
                        srv.logits, srv.pre):
                log.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zrun_conv.reset_counts()          # this path starts here
            windowed_conv.reset_counts()
            t0 = time.time()
            results = [f.result(timeout=900)
                       for f in [srv.submit(s) for s in scenes]]
            wall = time.time() - t0
            settle(srv, len(scenes))
            b1, b2 = zrun_conv.launches, windowed_conv.launches  # ends here
            torch.cuda.synchronize()
    finally:
        srv.close()
        for h in hooks:
            h.remove()
        model.voxel_enc = own_ve
    st = srv.stats.summary()
    for s, preds in zip(scenes, results):
        if not isinstance(preds, list):
            fail(f"{phase}: {label}: a request did not resolve")
        for p in preds:
            if p["mask"].shape != (len(s["points"]),) \
                    or not np.isfinite(p["score"]) \
                    or not 0 <= p["class"] < 200:
                fail(f"{phase}: {label}: an instance has a wrong mask "
                     "shape, score or class")
    sizes = [len(p[0]) for p in srv.pre]
    if sizes != [4] * (len(scenes) // 4):
        fail(f"{phase}: {label}: the timed scenes were served in batches of "
             f"{sizes}, not of 4")
    if st["scenes"] != len(scenes) or len(expected) != st["steps"] \
            or b1 != sum(expected) or b2:
        fail(f"{phase}: {label}: zrun_conv launches {b1} != routed convs "
             f"per forward {expected}, or windowed_conv launched {b2} "
             f"times (scenes {st['scenes']})")
    build_ms = [a.elapsed_time(z) for a, z in builds]
    rec = {"layout": label, "workers": num_workers, "scenes": len(scenes),
           "scenes_per_sec": st["scenes_per_sec"], "wall_s": wall,
           "p50_ms": st["p50_latency_s"] * 1e3,
           "p99_ms": st["p99_latency_s"] * 1e3, "stage_s": st["stage_s"],
           "h2d_bytes_per_batch": float(np.mean(h2d)),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "map_build_ms": float(np.median(build_ms)) if build_ms else None,
           "routed_per_forward": list(expected), "launches": b1,
           "b2_launches": b2,
           "logits": [(c.float().cpu(), m.float().cpu(), v.cpu())
                      for c, m, v in srv.logits],
           "rounds": [rounds_of(cr, mr) for cr, mr in kept],
           "pre": list(srv.pre), "np_batches": list(np_batches)}
    stages = " ".join(f"{k}={v:.3f}s" for k, v in sorted(
        st["stage_s"].items()))
    maps_txt = (f" | map build {rec['map_build_ms']:.3f} ms a batch (CUDA "
                f"events, median of {len(build_ms)})" if build_ms else "")
    pool = f" ({num_workers} workers)" if num_workers else ""
    print(f"{phase}: {label}{pool} | {len(scenes)} scenes, "
          f"{st['scenes_per_sec']:.3f} scenes/s (wall {wall:.2f} s) p50 "
          f"{rec['p50_ms']:.1f} ms p99 {rec['p99_ms']:.1f} ms | {stages} | "
          f"host-to-device {rec['h2d_bytes_per_batch'] / 2**20:.2f} MiB a "
          f"batch | max_memory_allocated {rec['peak_gib']:.2f} GiB"
          f"{maps_txt} | zrun_conv launches {b1} = routed convs per forward "
          f"{expected}, windowed_conv {b2} ({card})", flush=True)
    return rec


def served_logits(rec):
    """A serve_instseg record's final (class, mask) logits, scene by scene
    in submission order."""
    import torch
    return (torch.cat([c for c, _, _ in rec["logits"]]),
            torch.cat([m for _, m, _ in rec["logits"]]))


def serve_layouts_phase(card, dev, zrun_conv, profile=None):
    """Phase ``serve_layouts``: the full-width stage-1 model, one set of
    random weights, behind InstSegServer(batch_size=4) in the rectangular
    layout with host maps (``rect``), with maps built on the card
    (``dev_maps``), the flat pack with the z-run gather conv (``flat_zt``)
    and ``rect`` on a spawn pool of min(4, cpu_count - 1) workers; 4 warm
    and the serve phase's 8 timed scenes each.  Returns the phase's
    numbers; fails on any gate (see the module docstring)."""
    import dataclasses
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import (collate_processed,
                                                      make_batch,
                                                      pipeline_config,
                                                      process_scene)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.ops import device_maps, kernel_maps
    from pq3d_tpu_torch.serve import to_device

    over = [f"data.instseg_options.level_caps={LAYOUT_CAPS}"]
    cfgs = {lay: serving_config(lay, over)
            for lay in ("rect", "dev_maps", "flat_zt")}
    pipes = {lay: pipeline_config(c["data"]["instseg_options"])
             for lay, c in cfgs.items()}
    model = build_model(cfgs["rect"], device="cuda", seed=0)
    backbone = model.voxel_encoder.backbone
    host_ve = model.voxel_enc
    # the voxel encoder's settings that build_model reads from the
    # dev_maps config: the same model and weights, maps and z-run plans
    # built on the card
    dev_args = cfgs["dev_maps"]["model"]["voxel_encoder"]["args"]
    dev_ve = dataclasses.replace(
        host_ve, device_maps=tuple(dev_args["device_maps"]),
        device_ztriple=dev_args["device_ztriple"])
    warm = make_scenes(4, seed=2)
    scenes = make_scenes(8, seed=3)
    most = np.max([level_counts(s, pipes["rect"].voxel_size)
                   for s in warm + scenes], 0).tolist()
    print(f"serve_layouts: level caps {LAYOUT_CAPS} (tools/bench_serve.py), "
          f"most voxels in one scene per level {most}", flush=True)
    if any(m > c for m, c in zip(most, LAYOUT_CAPS)):
        fail("a scene outgrows the layouts' level caps")
    extra = SERVE_EXTRA
    workers = max(1, min(4, (os.cpu_count() or 2) - 1))

    maps = (device_maps, "build_batch_maps")

    def run(label, lay, ve, num_workers=0, rounds=False):
        return serve_instseg("serve_layouts", label, model, pipes[lay], warm,
                             scenes, card, maps, ve=ve,
                             num_workers=num_workers, rounds=rounds)
    runs = {"rect": run("rect", "rect", host_ve, rounds=True),
            "dev_maps": run("dev_maps", "dev_maps", dev_ve, rounds=True),
            "flat_zt": run("flat_zt", "flat_zt", host_ve),
            "rect_pool": run("rect_pool", "rect", host_ve, workers)}

    # gate: the served logits with maps built on the card against the host
    # maps' (same maps, same kernels), batch by batch, every round up to an
    # attend bit that flips (rounds_rel)
    dm_rel, flips = 0.0, []
    for (hr, (_, _, v)), dr in zip(
            zip(runs["rect"]["rounds"], runs["rect"]["logits"]),
            runs["dev_maps"]["rounds"]):
        rel, first = rounds_rel(hr, dr, v)
        dm_rel = max(dm_rel, rel)
        flips += [r for r in first if r < len(hr[2])]
    print(f"serve_layouts: dev_maps served logits vs rect, every round up "
          f"to a flipped attend bit: rel {dm_rel:.2e} (gate "
          f"{LAYOUT_GATE['dev_maps']:.0e}); scenes with a flipped bit "
          f"{len(flips)}", flush=True)
    if not dm_rel <= LAYOUT_GATE["dev_maps"]:
        fail("dev_maps' served logits differ from rect's")

    # gate: the pool's batches against process_scene in process with the
    # same seeds, collated the same way
    pool = runs["rect_pool"]
    for (pscenes, seed0), got in zip(pool["pre"], pool["np_batches"]):
        procs = [process_scene(s, pipes["rect"],
                               np.random.default_rng(
                                   np.random.SeedSequence(seed0 + i)))
                 for i, s in enumerate(pscenes)]
        procs += [procs[-1]] * (4 - len(procs))
        want = collate_processed(procs, pipes["rect"])
        want.pop("_meta")
        for key, val in want.items():
            pairs = (val.items() if isinstance(val, dict)
                     else [(None, val)])
            for kk, v in pairs:
                g = got[key] if kk is None else got[key][kk]
                if g.dtype != v.dtype or g.shape != v.shape \
                        or not np.array_equal(g, v):
                    fail(f"rect_pool: batch array {key} {kk or ''} differs "
                         f"from in-process process_scene")
    print(f"serve_layouts: the pool's {len(pool['pre'])} batches equal "
          f"in-process process_scene with the same seeds", flush=True)

    # gate: on one batch, the maps and z-run plans built on the card equal
    # the host's (its plans from kernel_maps.build_ztriple_plan, as the
    # ztriple_conv collate ships them)
    b4 = scenes[:4]
    rb = make_batch([dict(s) for s in b4], pipes["rect"],
                    np.random.default_rng(0))
    db = make_batch([dict(s) for s in b4], pipes["dev_maps"],
                    np.random.default_rng(0))
    fb = make_batch([dict(s) for s in b4], pipes["flat_zt"],
                    np.random.default_rng(0))
    dt = to_device({k: v for k, v in db.items() if k != "_meta"}, dev)

    def build_maps():
        return device_maps.build_batch_maps(
            dt["vox_coords"], dt["n_voxels"], dt["voxel_feats"],
            LAYOUT_CAPS, ztriple=dev_ve.device_ztriple)
    built = build_maps()
    host_maps = dict(rb["maps"])
    if dev_ve.device_ztriple:
        for lvl in device_maps.ZTRIPLE_LEVELS:
            nbr = host_maps[f"nbr3_{lvl}"]
            base, code = kernel_maps.build_ztriple_plan(
                nbr.reshape(-1, 27), n_pad=nbr.shape[1])
            host_maps[f"zt{lvl}_base"] = base.reshape(nbr.shape[:2] + (9,))
            host_maps[f"zt{lvl}_code"] = code.reshape(
                nbr.shape[:2] + (9, 3))
    for key, want in host_maps.items():
        got = built[key].cpu().numpy()
        if got.dtype != want.dtype or got.shape != want.shape \
                or not np.array_equal(got, want):
            fail(f"the map {key} built on the card differs from the host's")
    build_ms = cuda_time(build_maps, 5)
    print(f"serve_layouts: the {len(host_maps)} maps built on the card "
          f"equal the host's key by key | build {build_ms:.3f} ms "
          f"(median of 5, CUDA events) | host-to-device "
          f"{tree_nbytes({k: v for k, v in db.items() if k != '_meta'}) / 2**20:.2f} "
          f"MiB against {tree_nbytes({k: v for k, v in rb.items() if k != '_meta'}) / 2**20:.2f} "
          f"MiB with host maps", flush=True)
    del built, dt

    # gates: the flat forward all-plain against the rectangular all-plain
    # one on each real scene, and the flat forward with B1 against its own
    # all-plain forward (phase 5's gate)
    enc = {}
    h1 = model.voxel_encoder.register_forward_hook(
        lambda mod, args, out: enc.__setitem__("scales", out))
    h2 = backbone.register_forward_hook(
        lambda mod, args, out: enc.__setitem__("maps", [out[0]] + out[1]))

    def on_card(np_batch):
        b = to_device({k: v for k, v in np_batch.items() if k != "_meta"},
                      dev)
        for name, dim in extra.items():
            b[f"{name}_seg_fts"] = torch.zeros(4, pipes["rect"].max_segments,
                                               dim, device=dev)
            b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
        return b

    def forward(b, use_kernel, ve=host_ve):
        backbone.pallas_conv = use_kernel
        model.voxel_enc = ve
        try:
            with torch.inference_mode():
                out = model(b)
        finally:
            backbone.pallas_conv = True
            model.voxel_enc = host_ve
        return {"scales": enc["scales"], "maps": enc["maps"],
                "cls": [c.float() for c in out["predictions_class"]],
                "mask": [m.float() for m in out["predictions_mask"]]}
    rb_d, db_d, fb_d = on_card(rb), on_card(db), on_card(fb)
    try:
        rect_plain = forward(rb_d, False)
        flat_plain = forward(fb_d, False)
        before = zrun_conv.launches
        flat_b1 = forward(fb_d, True)
        flat_launches = zrun_conv.launches - before
        # one forward of the checked batch per layout on the device clock
        fwd_ms = {lay: cuda_time(lambda: forward(b, True, ve), 3)
                  for lay, b, ve in (("rect", rb_d, host_ve),
                                     ("dev_maps", db_d, dev_ve),
                                     ("flat_zt", fb_d, host_ve))}
        if profile:
            stem, ext = os.path.splitext(profile)
            for lay, b, ve in (("rect", rb_d, host_ve),
                               ("dev_maps", db_d, dev_ve),
                               ("flat_zt", fb_d, host_ve)):
                profile_run(lambda: forward(b, True, ve), f"{lay} forward",
                            f"{stem}_{lay}{ext}")
    finally:
        h1.remove()
        h2.remove()
    print(f"serve_layouts: one forward of the checked batch (CUDA events, "
          f"median of 3, kernel on; dev_maps with its map build): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in fwd_ms.items()),
          flush=True)
    flat_rows = level_rows(fb)
    if flat_launches != len(backbone.routed_convs(flat_rows)):
        fail(f"the flat forward launched zrun_conv {flat_launches} times")
    seg_valid = torch.from_numpy(rb["seg_pad_masks"]).to(dev)
    scale_rel = max(per_scene_rel(f, r, seg_valid) for f, r in
                    zip(flat_plain["scales"], rect_plain["scales"]))
    # the logits of every decoder round up to a flipped attend bit, as
    # every other gate between two forwards reads them
    logit_rel, first = rounds_rel(
        rounds_of(rect_plain["cls"], rect_plain["mask"]),
        rounds_of(flat_plain["cls"], flat_plain["mask"]), seg_valid)
    print(f"serve_layouts: flat all-plain vs rect all-plain: segment "
          f"features rel {scale_rel:.2e} per scene, class and mask logits "
          f"of every round up to a flipped attend bit rel {logit_rel:.2e} "
          f"(gate {LAYOUT_GATE['flat_plain']:.0e}), first flipped round by "
          f"scene {first}", flush=True)
    if not max(scale_rel, logit_rel) <= LAYOUT_GATE["flat_plain"]:
        fail("the flat forward disagrees with the rectangular one")
    feat_rel = max(rel_err(a, r) for a, r in zip(
        flat_b1["maps"] + flat_b1["scales"],
        flat_plain["maps"] + flat_plain["scales"]))
    finite = all(torch.isfinite(t).all().item()
                 for t in flat_b1["cls"][-1:] + flat_b1["mask"][-1:])
    print(f"serve_layouts: flat forward with zrun_conv ({flat_launches} "
          f"launches, flat level rows {flat_rows}) vs its all-plain "
          f"forward: features rel {feat_rel:.2e} (gate 2e-2)", flush=True)
    if not (finite and feat_rel <= 2e-2):
        fail("the flat forward with the kernel disagrees with its plain "
             "twin")
    del model, backbone, rect_plain, flat_plain, flat_b1, enc, rb_d, db_d, \
        fb_d
    for rec in runs.values():
        for key in ("logits", "rounds", "pre", "np_batches"):
            rec.pop(key)
    return {"runs": runs, "map_build_ms": build_ms, "forward_ms": fwd_ms}


def morton_maps(level_coords, pad, kernel):
    """The flat (B * pad, K) map of one level with each scene's voxels in
    Morton order (padding rows after them, scene s at rows s * pad ..),
    the valid rows and the host seconds of ``morton_order``."""
    import numpy as np
    from pq3d_tpu_torch.ops import kernel_maps
    parts, valid, morton_s = [], [], 0.0
    for s, c in enumerate(level_coords):
        t0 = time.time()
        order = kernel_maps.morton_order(c)
        morton_s += time.time() - t0
        nbr = kernel_maps.build_neighbor_map(c[order], kernel, n_pad=pad)
        parts.append(np.where(nbr >= 0, nbr + s * pad, -1).astype(np.int32))
        valid.append(np.arange(pad) < len(c))
    return np.concatenate(parts), np.concatenate(valid), morton_s


def winconv_phase(scenes, batch, pipe, shapes, b1_ms, dev, flops_peak,
                  bw_peak):
    """Kernel B2 (the windowed conv) at full width on the served batch's
    coordinates, Morton-ordered: for each level with routed convs, the
    plan at tile 256 / window 512, its fold into the kernel's plan and
    their host seconds; at each routed (level, Cin, Cout) and at one 5^3
    case (K = 125, L0, 32 -> 32) the kernel against its plain version, the
    plain version over JAX's plan and the gather conv (all within 1e-3),
    then the wrapper's and the launch's median ms over 20 calls, the plain
    version's over 5, the bound, the block's shared memory and B1's ms at
    the same shape.  Returns the level and shape records and the launch
    count of the phase."""
    import numpy as np
    import torch
    from pq3d_tpu_torch.ops import kernel_maps, voxelize, windowed_conv
    from pq3d_tpu_torch.ops.sparse import sparse_conv
    tile, window = 256, 512
    levels = sorted({lvl for lvl, _, _ in shapes})
    coords = []
    for i, s in enumerate(scenes):
        c = [voxelize.quantize(s["points"].astype(np.float32),
                               pipe.voxel_size)[0]]
        while len(c) <= max(levels):
            c.append(kernel_maps.downsample_coords(c[-1])[0])
        for lvl in levels:
            if len(c[lvl]) != int(batch["maps"][f"valid_{lvl}"][i].sum()):
                fail(f"scene {i} L{lvl}: rebuilt {len(c[lvl])} voxels, the "
                     f"served batch has "
                     f"{int(batch['maps'][f'valid_{lvl}'][i].sum())}")
        coords.append(c)
    gen = torch.Generator(device="cpu").manual_seed(3)
    windowed_conv.reset_counts()            # B2's path starts here
    calls = 0
    level_recs, recs = [], []
    cases = [(lvl, 3, cin, cout, shapes[(lvl, cin, cout)])
             for lvl, cin, cout in sorted(shapes)] + [(0, 5, 32, 32, 0)]
    plans = {}
    for lvl, kernel, cin, cout, per_fwd in cases:
        if (lvl, kernel) not in plans:
            plans.clear()
            pad = batch["maps"][f"valid_{lvl}"].shape[1]
            nbr, valid, morton_s = morton_maps([c[lvl] for c in coords], pad,
                                               kernel)
            t0 = time.time()
            plan = windowed_conv.build_window_map(nbr, tile, window)
            plan_s = time.time() - t0
            t0 = time.time()
            folded = windowed_conv.fold_exceptions(plan, nbr, tile, window)
            fold_s = time.time() - t0
            refs = int((nbr >= 0).sum())
            extra = (folded["exc_src"] >= 0).sum(1)
            k = nbr.shape[1]
            # the (16-row, tap) pairs some row references: what the
            # kernel's warps multiply
            mult = float((folded["nbr_slab"].reshape(-1, 16, k) >= 0)
                         .any(1).mean())
            lrec = {"level": lvl, "k": k, "n": nbr.shape[0],
                    "morton_s": morton_s, "window_map_s": plan_s,
                    "fold_s": fold_s, "references": refs,
                    "valid_slot_share": refs / nbr.size,
                    "exceptions": plan["n_exceptions"],
                    "out_of_window_share": plan["n_exceptions"] / refs,
                    "x_rows": folded["exc_src"].shape[1],
                    "x_max": int(extra.max()), "x_mean": float(extra.mean()),
                    "mult_share": mult,
                    "plan_bytes": sum(folded[key].nbytes
                                      for key in windowed_conv.FOLDED_KEYS)}
            level_recs.append(lrec)
            print(f"winconv: L{lvl} K={k} N={lrec['n']} Morton order "
                  f"{morton_s:.3f} s, window map {plan_s:.3f} s, fold "
                  f"{fold_s:.3f} s (host) | {plan['n_exceptions']} of {refs} "
                  f"references out of the window "
                  f"({lrec['out_of_window_share']:.4f}); "
                  f"{lrec['valid_slot_share']:.4f} of the N x K slots hold a "
                  f"reference | extra slab rows a tile: X {lrec['x_rows']} "
                  f"(most {lrec['x_max']}, mean {lrec['x_mean']:.1f}) | "
                  f"(16-row, tap) pairs multiplied {mult:.4f}", flush=True)
            plans[(lvl, kernel)] = (
                torch.from_numpy(nbr).to(dev), torch.from_numpy(valid).to(dev),
                {key: torch.from_numpy(plan[key]).to(dev)
                 for key in PLAN_KEYS},
                {key: torch.from_numpy(folded[key]).to(dev)
                 for key in windowed_conv.FOLDED_KEYS}, lrec)
        nbr_d, valid_d, plan_d, fold_d, lrec = plans[(lvl, kernel)]
        n, k = nbr_d.shape
        x = torch.randn(n, cin, generator=gen).to(dev) * valid_d[:, None]
        w = (torch.randn(k, cin, cout, generator=gen)
             * (2.0 / (k * cin)) ** 0.5).to(dev)

        def kernel_call():
            return windowed_conv.windowed_sparse_conv(
                x, w, *fold_d.values(), tile=tile, window=window)
        got = kernel_call()
        calls += 1
        ref = windowed_conv.windowed_sparse_conv_folded_reference(
            x, w, fold_d, tile, window)
        jref = windowed_conv.windowed_sparse_conv_reference(x, w, plan_d,
                                                            tile, window)
        gat = sparse_conv(x, nbr_d, w)
        torch.cuda.synchronize()
        errs = {"kernel_vs_plain": rel_err(got, ref),
                "kernel_vs_jax_plan": rel_err(got, jref),
                "kernel_vs_gather": rel_err(got, gat),
                "plain_vs_gather": rel_err(ref, gat)}
        if not (torch.isfinite(got).all().item()
                and max(errs.values()) <= 1e-3):
            fail(f"windowed_conv disagrees at L{lvl} K={k} {cin}->{cout}: "
                 f"{errs}")
        ms = cuda_time(kernel_call, 20)
        prep = windowed_conv.prepare(x, w, lrec["x_rows"], window)
        kernel_ms = cuda_time(lambda: windowed_conv.launch(
            *prep, *fold_d.values(), cout, tile, window), 20)
        calls += 40
        plain_ms = cuda_time(
            lambda: windowed_conv.windowed_sparse_conv_folded_reference(
                x, w, fold_d, tile, window), 5)
        ck, bufs, smem = windowed_conv.smem_fit(cin, cout, window,
                                                lrec["x_rows"], k)
        bound, by, flops, nbytes = conv_bound(
            n, cin, cout, lrec["references"], lrec["plan_bytes"], flops_peak,
            bw_peak, taps=k)
        b1 = b1_ms.get((lvl, cin, cout)) if k == 27 else None
        dense = 2.0 * n * k * cin * cout
        rec = {"level": lvl, "k": k, "n": n, "cin": cin, "cout": cout,
               "per_forward": per_fwd, "ms": ms, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "dense_flops": dense,
               "mult_share": lrec["mult_share"],
               "mult_flops": lrec["mult_share"] * dense, "bound_ms": bound,
               "bound_by": by, "b1_ms": b1, "flops": flops, "bytes": nbytes,
               "smem_bytes": smem, "ck": ck, "slab_buffers": bufs,
               "max_abs_err": (got - ref).abs().max().item(), **errs}
        recs.append(rec)
        b1_txt = f"B1 zrun_conv {b1:.3f} ms" if b1 is not None else \
            "B1 does not take this shape"
        print(f"winconv: windowed_conv L{lvl} K={k} N={n} {cin}->{cout} "
              f"({per_fwd} per forward) rel_err vs plain "
              f"{errs['kernel_vs_plain']:.2e}, vs JAX's plan "
              f"{errs['kernel_vs_jax_plan']:.2e}, vs gather conv "
              f"{errs['kernel_vs_gather']:.2e} | {ms:.3f} ms (kernel alone "
              f"{kernel_ms:.3f} ms; plain {plain_ms:.3f} ms; bound "
              f"{bound:.4f} ms by {by}; {flops / ms / 1e9:.1f} TFLOP/s on the "
              f"references, kernel {dense / kernel_ms / 1e9:.1f} on all N x K "
              f"slots, {rec['mult_flops'] / kernel_ms / 1e9:.1f} on the "
              f"multiplied pairs) | shared memory {smem} B a block (chunk "
              f"{ck}, {bufs} slab buffer{'s' if bufs > 1 else ''}) | {b1_txt}",
              flush=True)
        del x, w, got, ref, jref, gat, prep
    launches = windowed_conv.launches        # B2's path ends here
    if launches != calls:
        fail(f"windowed_conv launched {launches} times for {calls} calls")
    del plans
    torch.cuda.empty_cache()
    return {"levels": level_recs, "shapes": recs, "launches": launches}


def b1_shapes(zrun_conv, fm, routed, dev, flops_peak, bw_peak, label):
    """B1 against its plain version (f32 and bf16 x, within 1e-2 of
    max|ref|) at each routed (level, Cin, Cout) of one forward over the
    flat maps ``fm``, on random x and W: its median ms over 20 launches,
    the wrapper's host ms per call, the plain version's ms, the bound and
    the slot and (tile, tap) shares.  Returns a record per shape."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(0)
    shapes = {}          # (level, cin, cout) -> routed convs per forward
    for _, lvl, cin, cout in routed:
        shapes[(lvl, cin, cout)] = shapes.get((lvl, cin, cout), 0) + 1
    per_shape = []
    for (lvl, cin, cout), per_fwd in sorted(shapes.items()):
        nbr, valid = fm[f"nbr3_{lvl}"], fm[f"valid_{lvl}"]
        n = nbr.shape[0]
        if not zrun_conv.applicable(n, cin, cout):
            fail(f"shape (N={n}, {cin}->{cout}) does not route")
        zb, zc = zrun_conv.zrun_plan(nbr)
        x = torch.randn(n, cin, generator=gen).to(dev) * valid[:, None]
        w = (torch.randn(27, cin, cout, generator=gen) * 0.05).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = zrun_conv.zrun_conv(xd, w, zb, zc, valid)
            ref = zrun_conv.zrun_conv_reference(xd, w, zb, zc, valid)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs().max().item()
            rel = diff / max(ref.float().abs().max().item(), 1e-12)
            if not (rel <= 1e-2 and torch.isfinite(got).all().item()):
                fail(f"zrun_conv disagrees with its plain version at "
                     f"L{lvl} {cin}->{cout} {dt}: rel {rel:.3e}")
            if dt is torch.float32:      # the main path feeds f32 x
                ms = cuda_time(lambda: zrun_conv.zrun_conv(xd, w, zb, zc,
                                                           valid), 20)
                host_ms = host_time(lambda: zrun_conv.zrun_conv(
                    xd, w, zb, zc, valid), 20)
                plain_ms = cuda_time(lambda: zrun_conv.zrun_conv_reference(
                    xd, w, zb, zc, valid), 5)
                pairs = int((zc != -2).sum().item())
                bound, by, flops, nbytes = conv_bound(
                    n, cin, cout, pairs, zrun_plan_bytes(n, True),
                    flops_peak, bw_peak)
                slots, staged, mult = tap_shares(zrun_conv, zc)
                rec = {"level": lvl, "n": n, "cin": cin, "cout": cout,
                       "per_forward": per_fwd, "ms": ms,
                       "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "flops": flops, "dense27_flops":
                           2.0 * n * 27 * cin * cout, "bytes": nbytes,
                       "slot_share": slots, "tile_tap_share": staged,
                       "mult_share": mult,
                       "mult_flops": mult * 2.0 * n * 27 * cin * cout}
            rec[f"max_abs_err_{'f32' if dt is torch.float32 else 'bf16'}"] \
                = diff
            rec[f"max_rel_err_{'f32' if dt is torch.float32 else 'bf16'}"] \
                = rel
        per_shape.append(rec)
        print(f"{label}: zrun_conv L{lvl} N={n} {cin}->{cout} "
              f"rel_err f32 {rec['max_rel_err_f32']:.2e} "
              f"bf16 {rec['max_rel_err_bf16']:.2e} | {rec['ms']:.3f} ms "
              f"(host {rec['host_ms']:.3f} ms a call, plain "
              f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f}"
              f" ms by {rec['bound_by']}, {rec['flops'] / rec['ms'] / 1e9:.1f}"
              f" TFLOP/s on valid taps, "
              f"{rec['mult_flops'] / rec['ms'] / 1e9:.1f} on multiplied "
              f"tiles) | slots {rec['slot_share']:.4f}, (tile, tap) pairs "
              f"staged {rec['tile_tap_share']:.4f}, multiplied "
              f"{rec['mult_share']:.4f}", flush=True)
        del x, w, zb, zc
    return per_shape


def kernel_bwd_phase(zrun_conv, fm, shapes, dev, flops_peak, bw_peak):
    """The kernel's backward at each routed shape: dx and dW through the
    autograd Function against the plain backward, then the dx kernel's
    median ms over 20 launches, its host time per call, its plain
    version's, its bound (Cin and Cout swapped: dy in, dx out) and the dW
    re-gather's ms."""
    import torch
    from pq3d_tpu_torch.ops import sparse
    gen = torch.Generator(device="cpu").manual_seed(1)
    recs = []
    for (lvl, cin, cout), per_step in sorted(shapes.items()):
        nbr, valid = fm[f"nbr3_{lvl}"], fm[f"valid_{lvl}"]
        n = nbr.shape[0]
        zb, zc = zrun_conv.zrun_plan(nbr)
        x = torch.randn(n, cin, generator=gen).to(dev) * valid[:, None]
        w = (torch.randn(27, cin, cout, generator=gen) * 0.05).to(dev)
        dy = torch.randn(n, cout, generator=gen).to(dev)
        xg = x.clone().requires_grad_(True)
        wg = w.clone().requires_grad_(True)
        before = zrun_conv.phase_launches["bwd"]
        zrun_conv.zrun_conv_sym(xg, wg, zb, zc, valid).backward(dy)
        if zrun_conv.phase_launches["bwd"] != before + 1:
            fail(f"the backward at L{lvl} {cin}->{cout} did not launch the "
                 f"kernel once")
        dx_ref, dw_ref = zrun_conv.zrun_conv_backward_reference(
            x, w, zb, zc, valid, dy)
        torch.cuda.synchronize()
        rel_dx, rel_dw = rel_err(xg.grad, dx_ref), rel_err(wg.grad, dw_ref)
        finite = bool(torch.isfinite(xg.grad).all().item()
                      and torch.isfinite(wg.grad).all().item())
        if not (finite and rel_dx <= 1e-2 and rel_dw <= 1e-2):
            fail(f"zrun_conv backward disagrees with its plain version at "
                 f"L{lvl} {cin}->{cout}: dx rel {rel_dx:.3e}, dW rel "
                 f"{rel_dw:.3e}")
        dym = torch.where(valid[:, None], dy, 0)
        wt = w.flip(0).transpose(1, 2)
        ms = cuda_time(lambda: zrun_conv.zrun_conv(dym, wt, zb, zc,
                                                   phase="bwd"), 20)
        host_ms = host_time(lambda: zrun_conv.zrun_conv(dym, wt, zb, zc,
                                                        phase="bwd"), 20)
        plain_ms = cuda_time(lambda: zrun_conv.zrun_conv_reference(
            dym, wt, zb, zc), 5)
        dw_ms = cuda_time(lambda: sparse.ztriple_weight_grad(x, zb, zc, dym),
                          5)
        pairs = int((zc != -2).sum().item())
        bound, by, flops, nbytes = conv_bound(
            n, cout, cin, pairs, zrun_plan_bytes(n, False), flops_peak,
            bw_peak)
        slots, staged, mult = tap_shares(zrun_conv, zc)
        # dW = sum over taps of x_tap^T @ dy: the same products, reading x
        # (f32), dy (f32) and the plan once and writing dW (f32)
        dw_bound, dw_by = bound_of(
            flops, n * cin * 4 + n * cout * 4 + zrun_plan_bytes(n, False)
            + 27 * cin * cout * 4, flops_peak, bw_peak)
        rec = {"level": lvl, "n": n, "cin": cout, "cout": cin,
               "forward": f"{cin}->{cout}", "per_step": per_step, "ms": ms,
               "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "dw_ms": dw_ms, "dw_bound_ms": dw_bound, "dw_bound_by": dw_by,
               "flops": flops, "bytes": nbytes, "slot_share": slots,
               "tile_tap_share": staged, "mult_share": mult,
               "mult_flops": mult * 2.0 * n * 27 * cin * cout,
               "max_abs_err_dx": (xg.grad - dx_ref).abs().max().item(),
               "max_rel_err_dx": rel_dx, "max_rel_err_dw": rel_dw}
        recs.append(rec)
        print(f"kernel_bwd: zrun_conv dx L{lvl} N={n} {cout}->{cin} "
              f"(forward {cin}->{cout}, {per_step} per step) rel_err dx "
              f"{rel_dx:.2e} dW {rel_dw:.2e} | {ms:.3f} ms (host "
              f"{host_ms:.3f} ms a call, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms by {by}, "
              f"{flops / ms / 1e9:.1f} TFLOP/s on valid taps, "
              f"{rec['mult_flops'] / ms / 1e9:.1f} on multiplied tiles) | "
              f"slots {slots:.4f}, (tile, tap) pairs staged {staged:.4f}, "
              f"multiplied {mult:.4f} | dW re-gather {dw_ms:.3f} ms (bound "
              f"{dw_bound:.4f} ms by {dw_by})", flush=True)
        del x, w, dy, xg, wg, dx_ref, dw_ref, dym, zb, zc
    torch.cuda.empty_cache()
    return recs


@contextlib.contextmanager
def ztriple_calls():
    """Count the z-run gather conv's forwards and backwards (the plain
    PyTorch Function ``sparse_conv_ztriple_sym``) inside the block."""
    from pq3d_tpu_torch.ops import sparse
    counts = {"fwd": 0, "bwd": 0}
    orig = sparse.sparse_conv_ztriple_sym

    def counted(*args, **kwargs):
        y = orig(*args, **kwargs)
        counts["fwd"] += 1
        if y.requires_grad:
            y.register_hook(lambda g: counts.__setitem__(
                "bwd", counts["bwd"] + 1))
        return y
    sparse.sparse_conv_ztriple_sym = counted
    try:
        yield counts
    finally:
        sparse.sparse_conv_ztriple_sym = orig


def train_phase(trainer, zrun_conv, warm, card, label="train", n_steps=5,
                fall=True):
    """1 warm step, then one epoch of ``n_steps`` timed steps through the
    trainer (its prefetching loader included), then, with ``fall``, 5
    steps on the warm batch.  Per step: the flat rows of each level (of
    the maps the card builds, in a device-map layout), B1's forward and
    dx launches, the assignment solver's launches (one a step: the set
    loss matches on the card) and the z-run gather conv's forward and
    backward calls.  Returns the launch counts and the step records."""
    import torch
    from pq3d_tpu_torch.ops import hungarian
    model = trainer.model
    backbone = model.voxel_encoder.backbone
    expected = []        # routed convs of each train forward
    step_rows = []       # the flat rows per level of each train forward

    def count(mod, args):
        step_rows.append(batch_rows(model, args[0]))
        expected.append(len(backbone.routed_convs(step_rows[-1])))
    hook = model.register_forward_pre_hook(count)
    t0 = time.time()
    m = trainer.train_batch(warm)        # builds the optimizer, warms up
    torch.cuda.synchronize()
    print(f"{label}: warm step {time.time() - t0:.1f} s, loss "
          f"{float(m['loss']):.4f}", flush=True)

    inner, loader = trainer._train_step, trainer.train_data
    steps, host_s = [], []

    def timed_step(batch):
        b1 = dict(zrun_conv.phase_launches)
        solver = hungarian.launches
        zt = dict(zcalls)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(batch)
        b.record()
        b.synchronize()
        steps.append({"device_ms": a.elapsed_time(b), "end": time.time(),
                      "loss": float(out["loss"]),
                      "grad_norm": float(out["grad_norm"]),
                      "rows": step_rows[-1], "routed": expected[-1],
                      "b1": {k: zrun_conv.phase_launches[k] - b1[k]
                             for k in b1},
                      "hungarian": hungarian.launches - solver,
                      "ztriple": {k: zcalls[k] - zt[k] for k in zt}})
        return out

    def timed_loader(epoch):
        it = iter(loader(epoch))
        while True:
            t = time.time()
            try:
                b = next(it)
            except StopIteration:
                return
            host_s.append(time.time() - t)
            yield b

    trainer._train_step, trainer.train_data = timed_step, timed_loader
    expected.clear()
    step_rows.clear()
    torch.cuda.reset_peak_memory_stats()
    with ztriple_calls() as zcalls:
        zrun_conv.reset_counts()            # main path starts here
        hungarian.reset_counts()
        t0 = time.time()
        trainer.train_epoch(0)
        wall = time.time() - t0
        counts = dict(zrun_conv.phase_launches)  # main path ends here
        counts["hungarian"] = hungarian.launches
    peak = torch.cuda.max_memory_allocated()
    trainer._train_step, trainer.train_data = inner, loader
    hook.remove()
    for i, (s, h) in enumerate(zip(steps, host_s)):
        print(f"{label}: step {i + 1} loss {s['loss']:.4f} grad_norm "
              f"{s['grad_norm']:.3f} | host pipeline {h:.3f} s | device "
              f"step {s['device_ms']:.1f} ms | level rows {s['rows']} | "
              f"B1 fwd {s['b1']['fwd']} dx {s['b1']['bwd']} (routed "
              f"{s['routed']}) | solver {s['hungarian']} | z-run gather "
              f"conv fwd "
              f"{s['ztriple']['fwd']} bwd {s['ztriple']['bwd']}",
              flush=True)
    if len(steps) != n_steps or len(expected) != n_steps:
        fail(f"the epoch ran {len(steps)} steps, expected {n_steps}")
    if not all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in steps):
        fail("a loss or gradient norm is not finite")
    grads = [p.grad for p in model.parameters() if p.requires_grad]
    if any(g is None for g in grads) or not torch.stack(
            [torch.isfinite(g).all() for g in grads]).all().item():
        fail("a trainable parameter has no gradient or a non-finite one")
    routed = sum(expected)
    scenes = n_steps * trainer.train_data.batch_size
    print(f"{label}: {n_steps} steps in {wall:.2f} s: {n_steps / wall:.3f} "
          f"steps/s, {scenes / wall:.3f} scenes/s (steady, steps 2-"
          f"{n_steps}: {(n_steps - 1) / (steps[-1]['end'] - steps[0]['end']):.3f}"
          f" steps/s) | "
          f"max_memory_allocated {peak / 2**30:.2f} GiB | zrun_conv "
          f"launches fwd {counts['fwd']} bwd {counts['bwd']}, routed convs "
          f"per step {expected}; assignment solver launches "
          f"{counts['hungarian']} ({card})", flush=True)
    if counts["fwd"] != routed or counts["bwd"] != routed:
        fail(f"zrun_conv launches fwd {counts['fwd']} bwd {counts['bwd']} "
             f"!= routed convs {routed} each")
    if counts["hungarian"] != len(steps) or any(
            s["hungarian"] != 1 for s in steps):
        fail(f"the assignment solver launched "
             f"{[s['hungarian'] for s in steps]} times in the steps "
             f"(once a step expected; {counts['hungarian']} in all)")

    rec = {"counts": counts, "routed_per_step": expected, "steps": steps,
           "host_s": host_s, "wall_s": wall, "peak_bytes": peak}
    if not fall:
        return rec
    # the gate reads the batch's loss with dropout off before and after the
    # 5 steps: each step's own loss carries dropout's noise (+-3 around a
    # fall of 6-9 over the 5 steps), enough to decide a first-vs-last test
    wb = trainer._put(warm)
    before = batch_loss(trainer, wb)
    losses = [float(trainer.train_batch(warm)["loss"]) for _ in range(5)]
    after = batch_loss(trainer, wb)
    print(f"{label}: 5 steps on one batch, loss {losses} (dropout on); "
          f"dropout off {before:.4f} before, {after:.4f} after", flush=True)
    if not after < before:
        fail("the loss did not fall over 5 steps on one batch")
    return rec


ASSIGN_GATE = 1e-5      # the real rows' cost against scipy's, relative
# ... or, in a lane that holds PAD_COST rows, ASSIGN_ULPS f32 ulp of
# PAD_COST (2^-10) a real row: once a padded row has augmented, the f32
# duals are near 1e4 and resolve a reduced cost only to that ulp, so among
# queries whose costs nearly tie the solver (JAX's as well: the plain
# version is JAX's arithmetic) may take one dearer by a fraction of it
# (0.0086-0.104 ulp a real row read on an H100; PERF.md)
ASSIGN_ULP = 2.0 ** -10
ASSIGN_ULPS = 1
ASSIGN_PADDED = 20      # padded rows a lane in the random costs (ii)


def host_cpu_model():
    """The host CPU's model name (/proc/cpuinfo's, else lscpu's), with the
    machine and the cores this process sees."""
    import platform
    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if name is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((ln.split(":", 1)[1].strip()
                         for ln in out.splitlines()
                         if ln.startswith("Model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    return (f"{name or 'CPU model not reported'}, {platform.machine()}, "
            f"{len(os.sched_getaffinity(0))} cores")


def assignment_lanes(kind, shape, seed):
    """(L, M, Q) costs of phase 8b's kinds (ii) and (iii): random, with the
    last ASSIGN_PADDED rows of every lane at the set loss's PAD_COST
    (``padded``), or the same with every query column tied, as in a round
    whose queries are all the same (``tied``)."""
    import numpy as np
    from pq3d_tpu_torch.optim.losses import PAD_COST
    rng = np.random.default_rng(seed)
    c = rng.standard_normal(shape).astype(np.float32) * 3
    if kind == "tied":
        c[:] = c[:, :, :1]
    c[:, shape[1] - ASSIGN_PADDED:] = PAD_COST
    return c


def assign_phase(trainer, warm, card, bw_peak, save=None):
    """Phase assign (8b): the assignment kernel at full width on three
    kinds of (round x scene) lanes: (i) the costs the set loss builds for
    phase 8's warm batch (its forward in eval mode; the loss runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    host synchronisation), (ii) random costs with padded rows and (iii)
    the same with every query column tied.  Gates: col4row and the
    Dijkstra steps equal to the plain version's (on a CPU copy) on every
    row of every lane, every lane a permutation, the real rows' cost
    within ASSIGN_GATE of scipy's on the real rows alone (or ASSIGN_ULPS
    ulps of PAD_COST a real row, in a lane with padded rows), the launches equal to the
    calls.  Prints the kernel's median ms over 20 event pairs, the
    wrapper's host us a call, the parent's path (the copy to the host and
    one scipy call a lane), the plain version's ms, the host solver's ms
    (gated equal to the plain version), the bound and the steps.  ``save``: a path where (i)'s costs and valid rows are written
    (``np.savez``)."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment
    from pq3d_tpu_torch.ops import hungarian
    from pq3d_tpu_torch.optim import losses
    model = trainer.model
    b = trainer._put(warm)
    model.eval()
    with torch.no_grad():
        out = model(b)
    model.train()
    seen = []
    orig = hungarian.solve_batch

    def capture(cost, steps=None):
        seen.append(cost)
        return orig(cost, steps)
    hungarian.reset_counts()
    hungarian.solve_batch = capture
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.no_grad():
                total, _ = trainer.loss_fn(out, b)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        hungarian.solve_batch = orig
    loss = float(total)
    if len(seen) != 1 or hungarian.launches != 1 or not math.isfinite(loss):
        fail(f"assign: the set loss made {len(seen)} solver calls, "
             f"{hungarian.launches} launches, loss {loss}")
    real = seen[0]
    n_lanes, m, q = real.shape
    rounds = n_lanes // warm["instance_valid"].shape[0]
    print(f"assign: the set loss of phase 8's batch ran under "
          f"set_sync_debug_mode('error') with no host sync: loss "
          f"{loss:.4f}, one solver launch over {n_lanes} lanes ({rounds} "
          f"rounds x {warm['instance_valid'].shape[0]} scenes) of {m} x "
          f"{q}", flush=True)
    valid = np.tile(np.asarray(warm["instance_valid"]), (rounds, 1))
    if save:
        np.savez(save, cost=real.cpu().numpy(), valid=valid)
    kinds = {"set_loss": (real.contiguous(), valid)}
    for kind, seed in (("padded", 1), ("tied", 2)):
        c = assignment_lanes(kind, (n_lanes, m, q), seed)
        rows = np.zeros((n_lanes, m), bool)
        rows[:, :m - ASSIGN_PADDED] = True
        kinds[kind] = (torch.from_numpy(c).to(real.device), rows)
    calls = [1]                    # the set loss's launch above
    out_rec = {}
    for kind, (cost, rows) in kinds.items():
        steps = torch.zeros(n_lanes, dtype=torch.int32, device=cost.device)

        def run():
            calls[0] += 1
            return hungarian.solve_batch(cost, steps)
        col = run()
        torch.cuda.synchronize()
        host = cost.cpu()
        t0 = time.perf_counter()
        ref, ref_steps = hungarian.solve_batch_reference(host)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got, got_steps = col.cpu(), steps.cpu()
        err = int((got.long() - ref.long()).abs().max())
        if not (torch.equal(got, ref) and torch.equal(got_steps, ref_steps)):
            bad = int((got != ref).any(1).sum())
            fail(f"assign: {kind}: the kernel's col4row differs from the "
                 f"plain version's in {bad} of {n_lanes} lanes, or its "
                 f"steps do")
        # the host solver (csrc/hungarian_cpu.cpp), which a CPU tensor runs
        cpu_steps = torch.zeros(n_lanes, dtype=torch.int32)
        cpu_col = hungarian.solve_batch(host, cpu_steps)
        if not (torch.equal(cpu_col, ref)
                and torch.equal(cpu_steps, ref_steps)):
            fail(f"assign: {kind}: the host solver's col4row or steps "
                 f"differ from the plain version's")
        cpu_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            hungarian.solve_batch(host, cpu_steps)
            cpu_ms.append((time.perf_counter() - t0) * 1e3)
        host_solver_ms = sorted(cpu_ms)[2]
        c_np = host.numpy()
        worst = worst_ulp = 0.0
        for lane in range(n_lanes):
            g = got[lane].numpy()
            if len(set(g.tolist())) != m or g.min() < 0 or g.max() >= q:
                fail(f"assign: {kind}: lane {lane} is no permutation")
            r = np.flatnonzero(rows[lane])
            if not len(r):
                continue
            ours = c_np[lane, r, g[r]].sum(dtype=np.float64)
            ri, ci = linear_sum_assignment(c_np[lane][r])
            ref_cost = c_np[lane][r][ri, ci].sum(dtype=np.float64)
            gap = abs(ours - ref_cost)
            rel = gap / max(abs(ref_cost), 1e-30)
            per_row = gap / (len(r) * ASSIGN_ULP)
            worst, worst_ulp = max(worst, rel), max(worst_ulp, per_row)
            padded = len(r) < m
            if rel > ASSIGN_GATE and not (padded
                                          and per_row <= ASSIGN_ULPS):
                fail(f"assign: {kind}: lane {lane}'s real rows cost "
                     f"{ours!r} against scipy's {ref_cost!r}: {rel:.2e} "
                     f"relative (gate {ASSIGN_GATE:.0e}), {per_row:.3f} "
                     f"ulp of PAD_COST a real row (gate {ASSIGN_ULPS} with "
                     f"padded "
                     f"rows; {len(r)} real rows of {m})")
        ms = cuda_time(run, 20)
        host_us = host_time(run, 20) * 1e3

        def parent():
            # the parent's path: the costs to the host, one scipy call a
            # lane, the assignment back to the card
            c = cost.cpu().numpy()
            return torch.from_numpy(losses.assign(
                c.reshape(rounds, -1, m, q))).to(cost.device)
        lib = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parent()
            torch.cuda.synchronize()
            lib.append((time.perf_counter() - t0) * 1e3)
        library_ms = sorted(lib)[2]
        nbytes = cost.numel() * 4 + n_lanes * m * 4
        bound_ms = nbytes / bw_peak * 1e3
        st = ref_steps.double()
        out_rec[kind] = {
            "lanes": n_lanes, "rows": m, "cols": q,
            "real_rows": int(rows.sum()), "max_abs_err": err,
            "cost_rel": worst, "cost_ulp_a_row": worst_ulp,
            "ms": ms, "host_us": host_us,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "host_solver_ms": host_solver_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
            "steps_max": int(st.max()), "steps_mean": float(st.mean()),
            "staged": hungarian.staged(m, q)}
        print(f"assign: {kind}: {n_lanes} lanes of {m} x {q} "
              f"({int(rows.sum())} real rows): col4row and steps equal to "
              f"the plain version's on every row, real rows' cost "
              f"{worst:.1e} from scipy's, {worst_ulp:.4f} ulp of PAD_COST a "
              f"real row (gates {ASSIGN_GATE:.0e}, or {ASSIGN_ULPS} ulp a "
              f"row beside "
              f"padded rows) | kernel "
              f"{ms:.4f} ms (median of 20), wrapper host {host_us:.1f} "
              f"us a call | parent's path (copy to the host + {n_lanes} "
              f"scipy calls) {library_ms:.3f} ms | plain {plain_ms:.1f} ms "
              f"(CPU) | host solver {host_solver_ms:.2f} ms (median of 5, "
              f"equal to the plain version; {host_cpu_model()}) | bound {bound_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} "
              f"MB, bytes) | Dijkstra steps a lane max {int(st.max())}, "
              f"mean {float(st.mean()):.1f} | costs "
              f"{'staged in shared memory' if out_rec[kind]['staged'] else 'read from global memory'} "
              f"({card})", flush=True)
    if hungarian.launches != calls[0]:
        fail(f"assign: {hungarian.launches} launches for {calls[0]} calls")
    return out_rec


FLAT_RECT_GATE = 1e-4   # the flat step's loss against the rectangular one,
# and every gradient's max|diff| over the largest entry of all gradients


def flat_vs_rect_step(trainer):
    """two_pipe_step of the flat trainer's batch collated rectangular
    (the reference) and flat."""
    import dataclasses
    pipe = trainer.train_data.pipe_cfg
    return two_pipe_step(trainer, dataclasses.replace(
        pipe, flat_pack=False, ztriple_conv=False), pipe)


def two_pipe_step(trainer, ref_pipe, pipe, ves=None):
    """One batch of the trainer's scenes collated by two pipelines (same
    augmentation, same features), one step each from the same weights:
    every conv plain in f32 (TF32 off), dropout and the decoder's
    self-mask off, the direct criterion.  ``ves``: the model's voxel
    encoder settings for each pipeline (host maps against maps built on
    the card), else the model's own for both.  Returns the loss's relative
    difference, the largest gradient difference over the largest
    ``ref_pipe`` gradient entry (the gradients normalised by their
    maximum) and, printed only, the worst max|diff| / max|ref| of a
    tensor whose own largest entry is at least 1e-3 of that maximum; then
    the two losses."""
    import numpy as np
    from pq3d_tpu_torch.data.datasets import _assemble_instseg_batch
    from pq3d_tpu_torch.optim.losses import instseg_direct_loss
    model = trainer.model
    loader = trainer.train_data
    idxs = np.arange(loader.batch_size)
    runs = []
    own_ve = model.voxel_enc
    try:
        with all_plain(model):
            for pipe, ve in zip((ref_pipe, pipe), ves or (own_ve, own_ve)):
                model.voxel_enc = ve
                batch = trainer._put(_assemble_instseg_batch(
                    loader.dataset, pipe, loader.extra_features, idxs,
                    np.random.default_rng(7), True))
                model.train()
                model.zero_grad(set_to_none=True)
                out = model(batch)
                total, _ = instseg_direct_loss(out["predictions_class"],
                                               out["predictions_mask"],
                                               batch)
                total.backward()
                runs.append((total.item(), {
                    n: p.grad.detach().clone() for n, p in
                    model.named_parameters() if p.grad is not None}))
    finally:
        model.voxel_enc = own_ve
        model.zero_grad(set_to_none=True)
    (loss_r, grads_r), (loss_f, grads_f) = runs
    if set(grads_r) != set(grads_f):
        fail("the two layouts' steps reach other parameters")
    largest = max(g.abs().max().item() for g in grads_r.values())
    worst = per_tensor = 0.0
    for n, g in grads_r.items():
        top = g.abs().max().item()
        diff = (grads_f[n] - g).abs().max().item()
        worst = max(worst, diff / largest)
        if top >= 1e-3 * largest:
            per_tensor = max(per_tensor, diff / top)
    return (abs(loss_f - loss_r) / abs(loss_r), worst, per_tensor, loss_r,
            loss_f)


def flat_train_phase(trainer, zrun_conv, rect, card):
    """Phase flat_train: the trainer of ``python -m pq3d_tpu_torch.run
    ... flat_pack=true ztriple_conv=true`` through train_phase (B1's
    launches against the routed convs of each step's own flat totals) and
    train_check_phase, the z-run gather conv in every step forward and
    backward, and the flat step against the rectangular one (all-plain,
    f32, direct criterion).  ``rect`` is phase 8's record."""
    t0 = time.time()
    warm = next(iter(trainer.train_data(99)))
    print(f"flat_train setup: one flat batch of 4 augmented scenes collated "
          f"in {time.time() - t0:.1f} s, flat level rows "
          f"{level_rows(warm)}", flush=True)
    tr = train_phase(trainer, zrun_conv, warm, card, label="flat_train")
    if not all(s["ztriple"]["fwd"] > 0 and s["ztriple"]["bwd"] > 0
               for s in tr["steps"]):
        fail("the z-run gather conv did not run forward and backward in "
             "every flat step")

    def summary(r):
        ms = [s["device_ms"] for s in r["steps"]]
        return (f"{5 / r['wall_s']:.3f} steps/s, {20 / r['wall_s']:.3f} "
                f"scenes/s, device {min(ms):.1f}-{max(ms):.1f} ms a step, "
                f"host {min(r['host_s']):.3f}-{max(r['host_s']):.3f} s a "
                f"batch, peak {r['peak_bytes'] / 2**30:.2f} GiB, B1 fwd "
                f"{r['counts']['fwd']} dx {r['counts']['bwd']}")
    print(f"flat_train: flat + z-run {summary(tr)} | rectangular (phase 8) "
          f"{summary(rect)} ({card})", flush=True)
    tc = train_check_phase(trainer, zrun_conv, warm)
    loss_rel, grad_rel, per_tensor, loss_r, loss_f = flat_vs_rect_step(
        trainer)
    print(f"flat_train: one step all-plain f32, direct criterion: loss "
          f"rect {loss_r:.6f} flat {loss_f:.6f} (rel {loss_rel:.2e}); "
          f"gradients' largest difference over their maximum "
          f"{grad_rel:.2e} (gate for both {FLAT_RECT_GATE:.0e}); not gated: "
          f"worst tensor over its own maximum {per_tensor:.2e}", flush=True)
    if not max(loss_rel, grad_rel) <= FLAT_RECT_GATE:
        fail("the flat train step disagrees with the rectangular one")
    return {**tr, "train_check": tc, "flat_vs_rect_loss_rel": loss_rel,
            "flat_vs_rect_grad_rel": grad_rel,
            "flat_vs_rect_tensor_rel": per_tensor, "warm": warm}


DEV_TRAIN_STEPS = 2     # timed steps a device-map layout (8 scenes)
DEV_TRAIN_MAIN = ("dev_maps", "dev_flat_zt")   # timed, B1 counted
DEV_TRAIN_LOCK_MARGIN = 1.5   # a flat lock's margin over its probe batch
DEV_TRAIN_GATE = FLAT_RECT_GATE   # device against host maps, all-plain


def dev_train_trainer(exp_dir, layout, card):
    """Phase 8's trainer (``smoke_trainer``: the same scenes, seed and
    batch) in the device-map ``layout`` with DEV_TRAIN_STEPS steps an
    epoch: the serving layout's overrides at phase 5b's level caps, and a
    flat layout's lock (``device_flat_lock`` on the training scenes
    through its host-maps twin, margin DEV_TRAIN_LOCK_MARGIN) set as the
    pipeline's ``flat_shape_caps`` and the model's ``device_flat_caps``."""
    from pq3d_tpu_torch.config import LOCK_PROBE, SERVING_LAYOUTS
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.datasets import build_dataset
    from pq3d_tpu_torch.data.instseg_pipeline import (device_flat_lock,
                                                      pipeline_config)
    t0 = time.time()
    over = [f"data.synthetic.num_train={4 * DEV_TRAIN_STEPS}",
            f"data.instseg_options.level_caps={LAYOUT_CAPS}",
            *SERVING_LAYOUTS[layout]]
    if layout in LOCK_PROBE:
        probe = load_config("instseg_sceneverse", [
            "data.train=[SyntheticInstSeg]", "data.synthetic.n_points=70000",
            "data.synthetic.n_instances=24", "data.synthetic.n_segments=400",
            *over[:2], *SERVING_LAYOUTS[LOCK_PROBE[layout]]])
        ds = build_dataset(probe, "train")
        lock = device_flat_lock(
            [ds.get_scene(i) for i in range(len(ds))],
            pipeline_config(probe["data"]["instseg_options"]), 4,
            margin=DEV_TRAIN_LOCK_MARGIN)
        caps = ", ".join(f"{k}: {v}" for k, v in sorted(lock.items()))
        over += [f"data.instseg_options.flat_shape_caps={{{caps}}}",
                 "model.voxel_encoder.args.device_flat_caps="
                 "${data.instseg_options.flat_shape_caps}"]
    trainer = smoke_trainer(os.path.join(exp_dir, layout), *over)
    print(f"dev_train {layout}: trainer built in {time.time() - t0:.1f} s "
          f"({' '.join(SERVING_LAYOUTS[layout])}"
          f"{'; the flat lock from ' + LOCK_PROBE[layout] if layout in LOCK_PROBE else ''}) "
          f"({card})", flush=True)
    return trainer


def dev_train_phase(card, zrun_conv, exp_dir, rect):
    """Phase dev_train (9c): stage-1 training with the maps built on the
    card.  ``dev_maps`` and ``dev_flat_zt`` (phase 8's trainer, scenes,
    seed and batch; DEV_TRAIN_STEPS timed steps each, phase 8's figures
    beside them, the map build's device ms): B1's forward and dx launches
    equal the routed convs of every step at the built maps' rows, the
    assignment kernel once a step, train_check (phase 9's 2e-2), and one
    step all-plain in f32 (two_pipe_step) with the maps built on the card
    against the host's maps of the same scenes (``rect`` and ``flat_zt``):
    loss and normalised gradients within DEV_TRAIN_GATE.  ``dev_gather``
    and ``dev_flat_swin``: one step each, finite loss and gradients.
    ``rect`` is phase 8's record."""
    import dataclasses
    import torch
    from pq3d_tpu_torch.ops import hungarian
    out = {}
    for layout in DEV_TRAIN_MAIN:
        trainer = dev_train_trainer(exp_dir, layout, card)
        model = trainer.model
        t0 = time.time()
        warm = next(iter(trainer.train_data(99)))
        b = trainer._put(warm)
        with torch.no_grad():
            built = model._voxel_maps(b)
            build_ms = cuda_time(lambda: model._voxel_maps(b), 5)
        rows = level_rows({"maps": built})
        if rows != batch_rows(model, b):
            fail(f"dev_train {layout}: the built maps' rows {rows} differ "
                 f"from the caps' {batch_rows(model, b)}")
        del built
        print(f"dev_train {layout}: one batch of 4 augmented scenes "
              f"collated in {time.time() - t0:.1f} s, {len(warm['maps'])} "
              f"host maps shipped, level rows of the maps built on the "
              f"card {rows}, map build {build_ms:.3f} ms (median of 5, CUDA "
              f"events) ({card})", flush=True)
        tr = train_phase(trainer, zrun_conv, warm, card,
                         label=f"dev_train {layout}",
                         n_steps=DEV_TRAIN_STEPS, fall=False)

        def summary(r, n):
            ms = [s["device_ms"] for s in r["steps"]]
            return (f"{n / r['wall_s']:.3f} steps/s, device "
                    f"{min(ms):.1f}-{max(ms):.1f} ms a step, host "
                    f"{min(r['host_s']):.3f}-{max(r['host_s']):.3f} s a "
                    f"batch, peak {r['peak_bytes'] / 2**30:.2f} GiB")
        beside = (f" | rectangular host maps (phase 8) {summary(rect, 5)}"
                  if rect is not None else "")
        print(f"dev_train {layout}: {summary(tr, DEV_TRAIN_STEPS)}{beside} "
              f"({card})", flush=True)
        tc = train_check_phase(trainer, zrun_conv, warm)
        pipe, ve = trainer.train_data.pipe_cfg, model.voxel_enc
        host_pipe = dataclasses.replace(
            pipe, device_maps=False, flat_shape_caps=None,
            ztriple_conv=pipe.flat_pack)
        host_ve = dataclasses.replace(ve, device_maps=None,
                                      device_flat_caps=None)
        loss_rel, grad_rel, per_tensor, loss_h, loss_d = two_pipe_step(
            trainer, host_pipe, pipe, ves=(host_ve, ve))
        twin = "flat_zt" if pipe.flat_pack else "rect"
        print(f"dev_train {layout}: one step all-plain f32, direct "
              f"criterion: loss with host maps ({twin}) {loss_h:.6f}, with "
              f"maps built on the card {loss_d:.6f} (rel {loss_rel:.2e}); "
              f"gradients' largest difference over their maximum "
              f"{grad_rel:.2e} (gate for both {DEV_TRAIN_GATE:.0e}); not "
              f"gated: worst tensor over its own maximum {per_tensor:.2e}",
              flush=True)
        if not max(loss_rel, grad_rel) <= DEV_TRAIN_GATE:
            fail(f"dev_train {layout}: the step on maps built on the card "
                 f"disagrees with the step on the host's maps")
        out[layout] = {**tr, "train_check": tc, "map_build_ms": build_ms,
                       "level_rows": rows, "vs_host_loss_rel": loss_rel,
                       "vs_host_grad_rel": grad_rel,
                       "vs_host_tensor_rel": per_tensor}
        del trainer, model, b, warm
        torch.cuda.empty_cache()

    for layout in ("dev_gather", "dev_flat_swin"):
        trainer = dev_train_trainer(exp_dir, layout, card)
        warm = next(iter(trainer.train_data(99)))
        zrun_conv.reset_counts()
        hungarian.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        m = trainer.train_batch(warm)
        torch.cuda.synchronize()
        step_s = time.time() - t0
        loss = float(m["loss"])
        grads = [p.grad for p in trainer.model.parameters()
                 if p.requires_grad]
        finite = math.isfinite(loss) and all(
            g is not None and torch.isfinite(g).all().item() for g in grads)
        print(f"dev_train {layout}: one step {step_s:.2f} s (the first: "
              f"optimizer built, kernels warmed), loss {loss:.4f}, "
              f"gradients {'finite' if finite else 'NOT FINITE'} on "
              f"{len(grads)} tensors, grad norm {float(m['grad_norm']):.3f} "
              f"| B1 fwd {zrun_conv.phase_launches['fwd']} dx "
              f"{zrun_conv.phase_launches['bwd']}, solver "
              f"{hungarian.launches} ({card})", flush=True)
        if not finite:
            fail(f"dev_train {layout}: a non-finite loss or gradient")
        out[layout] = {"loss": loss, "step_s": step_s,
                       "b1": dict(zrun_conv.phase_launches),
                       "hungarian": hungarian.launches}
        del trainer, warm
        torch.cuda.empty_cache()
    return out


def train_check_phase(trainer, zrun_conv, batch):
    """One train step (dropout off) with the kernel (K) against the same
    step with every conv's backward on its plain version (KP) and with
    every conv on its plain version (P), plus a replay of each routed conv
    at K's own input and output gradient.

    Gates (2e-2): the loss of K against P; the worst routed-weight
    gradient of K against KP; the replay's dx and dW against the plain
    backward.  Printed, not gated: the routed-weight gradients of K
    against P and of K against a second K (the run-to-run floor).  A
    forward whose f32 sums run in another order crosses bf16 rounding and
    ReLU boundaries in the train-mode U-Net, so K against P moves the
    gradients well past what either pass computes differently."""
    import torch
    model = trainer.model
    backbone = model.voxel_encoder.backbone
    b = trainer._put(batch)
    names = [r[0] for r in backbone.routed_convs(batch_rows(model, b))]
    kernel, sym = zrun_conv.zrun_conv, zrun_conv.zrun_conv_sym

    def plain_bwd(x, w, zb, zc, out_valid=None, phase="fwd"):
        if phase == "bwd":
            return zrun_conv.zrun_conv_reference(x, w, zb, zc, out_valid)
        return kernel(x, w, zb, zc, out_valid, phase)

    captured = []

    def capturing_sym(x, w, zb, zc, out_valid=None):
        y = sym(x, w, zb, zc, out_valid)
        rec = {"x": x.detach(), "w": w.detach(), "zb": zb, "zc": zc,
               "v": out_valid}
        captured.append(rec)
        y.register_hook(lambda g: rec.__setitem__("dy", g))
        return y

    def step(mode):
        backbone.pallas_conv = mode != "P"
        if mode == "KP":
            zrun_conv.zrun_conv = plain_bwd
        if mode == "K":
            zrun_conv.zrun_conv_sym = capturing_sym
        try:
            model.train()
            model.zero_grad(set_to_none=True)
            out = model(b)
            total, _ = trainer.loss_fn(out, b)
            total.backward()
        finally:
            zrun_conv.zrun_conv, zrun_conv.zrun_conv_sym = kernel, sym
        return total.item(), {n: backbone.get_submodule(n).kernel.grad
                              .clone() for n in names}

    with dropout_off(model):
        runs = {mode: step(mode) for mode in ("K", "KP", "P", "K2")}
    backbone.pallas_conv = True
    model.zero_grad(set_to_none=True)

    def worst(a, c):
        return max(rel_err(runs[a][1][n], runs[c][1][n]) for n in names)
    loss_k, loss_p = runs["K"][0], runs["P"][0]
    loss_rel = abs(loss_k - loss_p) / max(abs(loss_p), 1e-12)
    bwd_rel, all_plain_rel, floor = worst("K", "KP"), worst("K", "P"), \
        worst("K", "K2")
    replay_dx = replay_dw = 0.0
    for rec in captured:
        x = rec["x"].clone().requires_grad_(True)
        w = rec["w"].clone().requires_grad_(True)
        sym(x, w, rec["zb"], rec["zc"], rec["v"]).backward(rec["dy"])
        dx_ref, dw_ref = zrun_conv.zrun_conv_backward_reference(
            rec["x"], rec["w"], rec["zb"], rec["zc"], rec["v"], rec["dy"])
        replay_dx = max(replay_dx, rel_err(x.grad, dx_ref))
        replay_dw = max(replay_dw, rel_err(w.grad, dw_ref))
    print(f"train_check: loss {loss_k:.6f} with the kernel vs {loss_p:.6f} "
          f"all-plain (rel {loss_rel:.2e}) | worst gradient rel over the "
          f"{len(names)} routed conv weights: kernel vs plain backward "
          f"{bwd_rel:.2e}; replay of the {len(captured)} routed convs at the "
          f"step's own x and dy: dx {replay_dx:.2e}, dW {replay_dw:.2e} | "
          f"not gated: kernel vs all-plain {all_plain_rel:.2e}, kernel vs "
          f"kernel (run-to-run) {floor:.2e}", flush=True)
    if len(captured) != len(names) or not all("dy" in r for r in captured):
        fail("the replay did not capture every routed conv")
    if not max(loss_rel, bwd_rel, replay_dx, replay_dw) <= 2e-2:
        fail("the train step with the kernel disagrees with its plain "
             "version")
    return {"loss_rel": loss_rel, "bwd_rel": bwd_rel,
            "replay_dx_rel": replay_dx, "replay_dw_rel": replay_dw,
            "all_plain_rel": all_plain_rel, "run_to_run_rel": floor}


UNIFIED_REQUESTS = 32    # 4 batches of 8
# card against the CPU, max|diff| / max|ref|: between the f32 reading
# (about 3e-6) and the TF32 control's (about 7e-4 to 1.4e-3) on an H100
UNIFIED_GATE = 1e-4
MARGIN_GATE = 1e-4       # CPU top-2 logit margin where tokens may differ
EOS_SCALES = (1.5, 3.0, 6.0, 12.0, 24.0)   # EOS embedding row, after x0.1


def eos_frozen(toks, n_tokens):
    """The step of each row's first EOS (None where there is none); fails
    unless every token after it is PAD."""
    import numpy as np
    from pq3d_tpu_torch.models.t5 import T5_EOS_ID, T5_PAD_ID
    firsts = []
    for row in toks:
        if row.shape != (n_tokens,):
            fail(f"generation tokens of shape {row.shape}")
        eos = np.flatnonzero(row == T5_EOS_ID)
        if len(eos) and (row[eos[0] + 1:] != T5_PAD_ID).any():
            fail("tokens after the first EOS are not all PAD")
        firsts.append(int(eos[0]) if len(eos) else None)
    return firsts


def eos_biased_decode(model, b, n_tokens):
    """Greedy decode of batch ``b`` with T5's embedding (tied to the
    logits) scaled by 0.1 and its EOS row by each of ``EOS_SCALES`` in turn,
    until some row emits EOS before its last step: random weights never
    emit it at full width, so this is what exercises the EOS freeze on the
    card.  The embedding is restored after.  Returns the scale and each
    row's first EOS step."""
    import torch
    from pq3d_tpu_torch.models.t5 import T5_EOS_ID
    emb = model.generation_head.decoder.embed.weight
    saved = emb.detach().clone()
    try:
        for scale in EOS_SCALES:
            with torch.no_grad():
                emb.copy_(saved * 0.1)
                emb[T5_EOS_ID] *= scale
            with torch.inference_mode():
                toks = model(b)["generation_tokens"].cpu().numpy()
            firsts = eos_frozen(toks, n_tokens)
            if any(f is not None and f < n_tokens - 1 for f in firsts):
                return scale, firsts
    finally:
        with torch.no_grad():
            emb.copy_(saved)
    fail(f"no row emitted EOS before its last step at EOS scales "
         f"{EOS_SCALES}: the EOS freeze was not exercised")


def unified_requests(n, seed):
    """``n`` (scene, lang) requests cycling through the three synthetic
    unified datasets: scenes of 50,000 points and 32 instances."""
    from pq3d_tpu_torch.data import unified_datasets as uds
    cfg = {"data": {"synthetic": {"num_train": n, "n_points": 50_000,
                                  "n_instances": 32}}}
    sets = [uds.SyntheticRefer(cfg, "train"), uds.SyntheticQA(cfg, "train"),
            uds.SyntheticCaption(cfg, "train")]
    return [sets[i % 3].get_item(seed * 1000 + i) for i in range(n)]


def part_times(model, b, reps=3):
    """Device ms of PointNet++, the CLIP tower, the query decoder and the
    greedy decode inside one forward of batch ``b`` (CUDA events recorded
    by hooks around each module; median of ``reps`` forwards)."""
    import torch
    parts = {"pointnet": model.pc_encoder.backbone,
             "clip_tower": model.txt_encoder.tower,
             "query_decoder": model.unified_encoder,
             "decode": model.generation_head}
    events = {k: [] for k in parts}
    hooks = []

    def record(name, opening):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            if opening:
                events[name].append([ev])
            else:
                events[name][-1].append(ev)
        return hook
    for name, mod in parts.items():
        hooks.append(mod.register_forward_pre_hook(record(name, True)))
        hooks.append(mod.register_forward_hook(record(name, False)))
    try:
        forward_ms = []
        for _ in range(reps):
            forward_ms.append(cuda_time(lambda: model(b), 1))
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    out = {k: sorted(a.elapsed_time(e) for a, e in v)[len(v) // 2]
           for k, v in events.items()}
    out["forward"] = sorted(forward_ms)[len(forward_ms) // 2]
    return out


def unified_phase(card, dev, profile):
    """Stage-2 serving at full width through UnifiedServer; returns the
    phase's numbers."""
    import copy
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data import unified_datasets as uds
    from pq3d_tpu_torch.data.unified_pipeline import (UnifiedPipelineConfig,
                                                      collate_unified,
                                                      process_item)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.models.t5 import T5_PAD_ID
    from pq3d_tpu_torch.ops import windowed_conv, zrun_conv
    from pq3d_tpu_torch.serve import UnifiedServer, to_device

    # f32 matmuls in f32 on the card: the CPU gate below measures the
    # port, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config("unified_tasks_sceneverse")
    pipe = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
    n_tokens = cfg["model"]["generation_head"]["args"]["max_new_tokens"]
    feature_dims = {"mv": 768, "voxel": 128}
    import threading
    alive = [t.name for t in threading.enumerate()]
    print(f"unified: {len(alive)} Python threads alive at the phase's start "
          f"({', '.join(alive)}); torch intra-op threads "
          f"{torch.get_num_threads()}", flush=True)
    t0 = time.time()
    model = build_model(cfg, device="cuda", seed=0)
    print(f"unified: model built in {time.time() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params | pipeline {pipe}", flush=True)
    b1_before, b2_before = zrun_conv.launches, windowed_conv.launches
    srv = UnifiedServer(model, pipe, batch_size=8,
                        feature_dims=feature_dims, max_delay_s=0.02,
                        detokenize=uds.detokenize, device="cuda")
    try:
        for f in [srv.submit(r) for r in unified_requests(8, seed=1)]:
            f.result(timeout=900)
        settle(srv, 8)
        srv.stats = type(srv.stats)()
        reqs = unified_requests(UNIFIED_REQUESTS, seed=2)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        results = [f.result(timeout=900)
                   for f in [srv.submit(r) for r in reqs]]
        wall = time.time() - t0
        settle(srv, len(reqs))
    finally:
        srv.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = srv.stats.summary()
    n_valid = [min(len(scene["inst_labels"]), pipe.max_obj_len)
               for scene, _ in reqs]
    eos_rows = 0
    for r, n in zip(results, n_valid):
        if not isinstance(r, dict) or r.get("ground_obj") is None:
            fail("a unified request did not resolve to an answer")
        g = r["ground_obj"]
        if not (0 <= g < n and np.isfinite(r["ground_scores"][g])):
            fail(f"ground_obj {g} is not a valid object of {n} with a "
                 f"finite score")
        if eos_frozen([np.asarray(r["generation_tokens"])],
                      n_tokens)[0] is not None:
            eos_rows += 1
    stages = " ".join(f"{k}={v:.3f}s" for k, v in sorted(
        st["stage_s"].items()))
    print(f"unified: {st['scenes']} requests in {st['steps']} batches of 8 "
          f"| {st['scenes_per_sec']:.3f} scenes/s (wall {wall:.2f} s) p50 "
          f"{st['p50_latency_s'] * 1e3:.1f} ms p99 "
          f"{st['p99_latency_s'] * 1e3:.1f} ms | {stages} | "
          f"max_memory_allocated {peak:.2f} GiB | rows with EOS "
          f"{eos_rows} of {len(reqs)} | ({card})", flush=True)

    # one batch (with its responses) on the card and on the CPU
    rng = np.random.default_rng(5)
    items = [process_item(s, l, pipe, rng, False, feature_dims)
             for s, l in reqs[:8]]
    np_batch = collate_unified([{k: v for k, v in it.items()
                                 if not k.startswith("meta_")}
                                for it in items], pipe, feature_dims,
                               train=False)
    np_batch.pop("obj_fts")
    b = to_device(np_batch, dev)
    serve_b = {k: v for k, v in b.items() if k != "response"}
    with torch.inference_mode():
        parts = part_times(model, serve_b)
    print("unified: device-clock ms on one batch of 8 (CUDA-event spans "
          "around each module, waits for the host's launches included; "
          "median of 3) "
          + " ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f" ({card})", flush=True)
    with torch.inference_mode():
        got = model(b)
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.time()
    with torch.inference_mode():
        ref = cpu_model(to_device(np_batch, torch.device("cpu")))
        valid = b["query_pad_masks"].cpu()
        ground_rel = rel_err(got["ground_logits"].cpu()[valid],
                             ref["ground_logits"][valid])
        gen_rel = rel_err(got["generation_logits"].cpu(),
                          ref["generation_logits"])
        toks_gpu = got["generation_tokens"].cpu()
        toks_cpu = ref["generation_tokens"]
        # the CPU decode's logits at every step: its own tokens fed back,
        # every position attended, as the decode loop does
        head = cpu_model.generation_head
        enc = head.LayerNorm_0(head.input_proj(ref["query"]))
        prev = torch.nn.functional.pad(toks_cpu[:, :-1].long(), (1, 0),
                                       value=T5_PAD_ID)
        step_logits = head.decoder(prev, enc, valid)
    cpu_s = time.time() - t0
    top2 = step_logits.topk(2, dim=-1).values
    margins = top2[..., 0] - top2[..., 1]                 # (B, steps)
    differ = (toks_gpu != toks_cpu)
    first_margin = None
    if differ.any():
        rows, steps = torch.nonzero(differ, as_tuple=True)
        first = {}
        for r_, s_ in zip(rows.tolist(), steps.tolist()):
            first.setdefault(r_, s_)
        first_margin = max(margins[r_, s_].item()
                           for r_, s_ in first.items())
    print(f"unified: card vs CPU (f32, TF32 off) on one batch: "
          f"ground_logits rel {ground_rel:.3e}, teacher-forced generation "
          f"logits rel {gen_rel:.3e} (gate {UNIFIED_GATE:g}) | greedy "
          f"tokens {'equal' if first_margin is None else 'differ'}"
          + ("" if first_margin is None else
             f", CPU top-2 margin at the first differing step "
             f"{first_margin:.3e} (gate {MARGIN_GATE:g})")
          + f" | smallest CPU top-2 margin over all steps "
          f"{margins.min().item():.3e} | CPU forward {cpu_s:.1f} s",
          flush=True)
    # control: the same batch with f32 matmuls in TF32, against the same
    # CPU reference, so the gate's distance from both readings is on record
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            got32 = model(b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ground_rel32 = rel_err(got32["ground_logits"].cpu()[valid],
                           ref["ground_logits"][valid])
    gen_rel32 = rel_err(got32["generation_logits"].cpu(),
                        ref["generation_logits"])
    print(f"unified: TF32 control (the same batch, TF32 on) against the "
          f"CPU: ground_logits rel {ground_rel32:.3e}, teacher-forced "
          f"generation logits rel {gen_rel32:.3e} (gate {UNIFIED_GATE:g})",
          flush=True)
    scale, firsts = eos_biased_decode(model, serve_b, n_tokens)
    print(f"unified: EOS freeze on the card (one batch, T5 embedding x0.1, "
          f"EOS row x{scale:g}): first EOS at steps "
          f"{[f if f is not None else '-' for f in firsts]} of {n_tokens}, "
          f"only PAD after it", flush=True)
    b1 = zrun_conv.launches - b1_before
    b2 = windowed_conv.launches - b2_before
    print(f"unified: launches of B1 {b1} and B2 {b2} (neither is on the "
          f"stage-2 path)", flush=True)
    if not (ground_rel <= UNIFIED_GATE and gen_rel <= UNIFIED_GATE):
        fail("the card's unified forward disagrees with the CPU's")
    if ground_rel32 <= UNIFIED_GATE and gen_rel32 <= UNIFIED_GATE:
        fail("the TF32 control passes the card-against-CPU gate: the gate "
             "would not catch f32 matmuls run in TF32")
    if first_margin is not None and first_margin >= MARGIN_GATE:
        fail(f"greedy tokens differ where the CPU's top-2 margin is "
             f"{first_margin:.3e}")
    if profile:
        stem, ext = os.path.splitext(profile)

        def unified_batch():
            with torch.inference_mode():
                model(serve_b)
        profile_run(unified_batch, "unified batch (forward and decode)",
                    f"{stem}_unified{ext}")
    return {"scenes_per_sec": st["scenes_per_sec"],
            "p50_s": st["p50_latency_s"], "p99_s": st["p99_latency_s"],
            "stage_s": st["stage_s"], "peak_gib": peak, "device_ms": parts,
            "ground_rel": ground_rel, "gen_rel": gen_rel,
            "ground_rel_tf32": ground_rel32, "gen_rel_tf32": gen_rel32,
            "eos_scale": scale, "tokens_equal": first_margin is None}


UNIFIED_TRAIN_ITEMS_VAL = 132   # one full eval batch of 128 and one of 4
# card against the CPU on one train step at batch 4 (f32, TF32 off),
# relative; four runs on an H100 80GB HBM3 at 700 W read: the loss parts
# at most 2.0e-7 (the TF32 control 8.8e-8 to 5.4e-5), the gradient norm
# 2.7e-6 to 9.4e-6 (3.3e-4 to 1.4e-3), all gradients together in L2
# 1.0e-5 to 2.9e-4 (1.0e-2 to 2.1e-2).  All updates together in L2 read
# 1.4e-4 to 1.6e-2 (1.0e-1 to 1.5e-1) and are not gated: AdamW's first
# step moves an element by up to the rate whatever the size of its
# gradient, so one element with a gradient near eps reads as a whole
# update; every element is held to 2.1 x the rate instead (one correct
# AdamW step moves it by at most lr * (1 + wd * |p|), |p| < 5 here)
UNIFIED_TRAIN_GATE = 1e-5    # the loss parts
UNIFIED_TRAIN_GATES = {"grad_norm": 1e-4, "gradients": 1e-3}
GRAD_NOISE = 1e-6   # a gradient below this share of the largest is f32 noise


def timed_train_run(trainer, loader, epoch, label, card):
    """One epoch of ``loader`` through ``trainer.train_epoch`` (its
    prefetching loader included), every step synchronised and split by
    CUDA events into forward, loss, backward and optimizer; the seconds
    each batch took to come out of the loader (in the prefetch thread).
    Step 1 is the warm step; steps 2-6 are timed."""
    import torch
    from pq3d_tpu_torch.train.state import make_train_step
    parts = ("forward", "loss", "backward", "optimizer")
    marks = []

    def mark(part):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][part] = ev
    inner = make_train_step(trainer.model, trainer._optimizer,
                            trainer._scheduler, trainer.loss_fn,
                            trainer._grad_norm, mark=mark)
    steps, host_s = [], []

    def timed_step(batch):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        marks.append({"start": start})
        out = inner(batch)
        marks[-1]["optimizer"].synchronize()
        m = marks[-1]
        edges = ("start",) + parts
        steps.append({"end": time.time(),
                      **{p: m[a].elapsed_time(m[p])
                         for a, p in zip(edges, parts)},
                      **{k: float(v) for k, v in out.items()}})
        return out

    def timed_loader(ep):
        it = iter(loader(ep))
        while True:
            t = time.time()
            try:
                b = next(it)
            except StopIteration:
                return
            host_s.append(time.time() - t)
            yield b

    saved = trainer._train_step, trainer.train_data
    trainer._train_step, trainer.train_data = timed_step, timed_loader
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        trainer.train_epoch(epoch)
    finally:
        trainer._train_step, trainer.train_data = saved
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    bs = loader.loaders[0].batch_size
    for i, (s, h) in enumerate(zip(steps, host_s)):
        print(f"unified_train {label}: step {i + 1}{' (warm)' if i == 0 else ''}"
              f" loss {s['loss']:.4f} ground {s.get('ground_loss', 0):.4f} "
              f"generation {s.get('generation_loss', 0):.4f} grad_norm "
              f"{s['grad_norm']:.3f} | host pipeline {h:.3f} s | device ms "
              + " ".join(f"{p} {s[p]:.1f}" for p in parts)
              + f" = {sum(s[p] for p in parts):.1f}", flush=True)
    if len(steps) != 6:
        fail(f"unified_train {label}: the epoch ran {len(steps)} steps, "
             f"expected 6")
    if not all(math.isfinite(s[k]) for s in steps for k in s):
        fail(f"unified_train {label}: a loss or gradient norm is not finite")
    span = steps[-1]["end"] - steps[0]["end"]
    dev = {p: sorted(s[p] for s in steps[1:])[2] for p in parts}
    rec = {"steps_per_s": 5 / span, "items_per_s": 5 * bs / span,
           "wall_s": wall, "host_s": host_s,
           "host_s_timed_mean": sum(host_s[1:]) / 5,
           "device_ms_median": dev,
           "device_step_ms_median": sorted(
               sum(s[p] for p in parts) for s in steps[1:])[2],
           "peak_gib": peak / 2**30, "steps": steps}
    print(f"unified_train {label}: 5 timed steps (2-6) in {span:.2f} s: "
          f"{rec['steps_per_s']:.3f} steps/s, {rec['items_per_s']:.1f} "
          f"items/s at batch {bs} | host pipeline {rec['host_s_timed_mean']:.3f}"
          f" s a batch (steps 2-6; warm {host_s[0]:.3f}) | device ms a step "
          f"(median of 2-6) {rec['device_step_ms_median']:.1f}: "
          + " ".join(f"{p} {v:.1f}" for p, v in dev.items())
          + f" | epoch wall {wall:.2f} s | max_memory_allocated "
          f"{rec['peak_gib']:.2f} GiB | os.cpu_count() {os.cpu_count()} "
          f"({card})", flush=True)
    return rec


def unified_train_check(trainer, cfg, np_batch, total_steps):
    """One train step at batch 4 from the same weights on the card (TF32
    off, then TF32 on as the control) and on a deep copy of the model on
    the CPU, every dropout and memory dropout off.  Returns the readings
    of both card runs against the CPU ({tf32: readings}) and the CPU
    step's seconds."""
    import copy
    import torch
    from pq3d_tpu_torch.optim.optimizers import build_from_config
    from pq3d_tpu_torch.serve import to_device
    from pq3d_tpu_torch.train.state import make_train_step
    model = trainer.model
    model.unified_encoder.set_memory_generator(None)
    cpu_model = copy.deepcopy(model).cpu()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    old = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}

    def one_step(net, device):
        opt, sched, gn = build_from_config(cfg, net, total_steps)
        step = make_train_step(net, opt, sched, trainer.loss_fn, gn)
        with dropout_off(net):
            m = step(to_device(np_batch, device))
        if device.type == "cuda":
            torch.cuda.synchronize()
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.detach().cpu() for n, p in
                 net.named_parameters()},
                {n: p.detach().cpu() for n, p in net.named_parameters()})
    dev = next(model.parameters()).device
    card = {}
    for tf32 in (False, True):
        model.load_state_dict(start)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            card[tf32] = one_step(model, dev)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    model.unified_encoder.set_memory_generator(torch.Generator(
        device=dev).manual_seed(int(cfg.get("rng_seed", 42))))
    t0 = time.time()
    ref = one_step(cpu_model, torch.device("cpu"))
    cpu_s = time.time() - t0
    lr = float(cfg["solver"]["lr"])
    return ({k: step_readings(card[k], ref, old, lr) for k in card},
            cpu_s)


def gate_train_check(label, check, cpu_s):
    """Print ``unified_train_check``'s readings and fail unless the f32
    step is within the gates and the TF32 control is not; returns the two
    readings (f32, TF32)."""
    f32, tf32 = check[False], check[True]
    keys = [k for k in f32 if k not in (
        "worst", "noise", "noise_update_over_lr", "param_diff_over_lr",
        "updates")]
    gates = {k: UNIFIED_TRAIN_GATES.get(k, UNIFIED_TRAIN_GATE)
             for k in keys}
    print(f"{label}: one step at batch 4, card (f32, TF32 off) vs "
          "CPU, relative: " + " ".join(
              f"{k} {f32[k]:.3e} (gate {gates[k]:g})" for k in keys)
          + " | per-tensor worst, max|diff| / max|ref|: "
          + " ".join(f"{k} {v:.3e} {n}" for k, (v, n) in
                     f32["worst"].items())
          + f" | updates {f32['updates']:.3e} (not gated), updated "
          f"parameters at most {f32['param_diff_over_lr']:.3f} x lr "
          f"apart (gate 2.1) | TF32 control: " + " ".join(
              f"{k} {tf32[k]:.3e}" for k in keys + ["updates"])
          + f" | f32-noise gradients {f32['noise']}: update "
          f"{f32['noise_update_over_lr']:.3f} x lr | CPU step "
          f"{cpu_s:.1f} s", flush=True)
    if any(f32[k] > gates[k] for k in keys) \
            or f32["noise_update_over_lr"] > 1.01 \
            or f32["param_diff_over_lr"] > 2.1:
        fail(f"{label}: the card's train step disagrees with the CPU's")
    if all(tf32[k] <= gates[k] for k in keys):
        fail(f"{label}: the TF32 control passes the train-step gates: they "
             "would not catch f32 matmuls run in TF32")
    return f32, tf32


def step_readings(got, ref, old, lr):
    """One train step against a reference step from the same weights
    ``old``: (metrics, gradients, updated parameters) each.  Relative
    differences of the loss parts and the gradient norm; of all gradients
    together and of all updates (new minus old) together, in L2 (a single
    element whose gradient is near AdamW's eps moves its update by up to
    the rate, so per-tensor maxima say little); the per-tensor worst,
    max|diff| / max|ref|, beside them.  Tensors whose reference gradient is
    f32 noise (below ``GRAD_NOISE`` of the largest, but not 0) are left
    out and their largest update is reported in units of the rate."""
    metrics, grads, params = ref
    gmax = max(g.abs().max().item() for g in grads.values())
    noise = sorted(n for n, g in grads.items()
                   if 0 < g.abs().max().item() <= GRAD_NOISE * gmax)
    r = {k: abs(got[0][k] - v) / abs(v) for k, v in metrics.items() if v}
    sums = {"gradients": [0.0, 0.0], "updates": [0.0, 0.0]}
    worst = {"gradients": (0.0, ""), "updates": (0.0, "")}
    for n, g in grads.items():
        if n in noise:
            continue
        for key, a, b in (("gradients", got[1][n], g),
                          ("updates", got[2][n] - old[n],
                           params[n] - old[n])):
            a, b = a.double(), b.double()
            sums[key][0] += (a - b).square().sum().item()
            sums[key][1] += b.square().sum().item()
            den = b.abs().max().item()
            if den > 0 and (a - b).abs().max().item() / den > worst[key][0]:
                worst[key] = ((a - b).abs().max().item() / den, n)
    for key, (num, den) in sums.items():
        r[key] = math.sqrt(num / den)
    r["worst"] = worst
    r["noise"] = noise
    r["noise_update_over_lr"] = max(
        [(got[2][n] - old[n]).abs().max().item() / lr for n in noise]
        or [0.0])
    r["param_diff_over_lr"] = max(
        (got[2][n] - p).abs().max().item() / lr for n, p in params.items())
    return r


# tensors (parameters and BatchNorm statistics) of the full-width
# unified_tasks_sceneverse model that share name and shape with the
# instseg_sceneverse one: what the recipe's warm start must load
# (tests/test_torch_warm_start.py::test_published_warm_start_count)
RECIPE_WARM_START_LOADED = 200


def unified_train_phase(card, dev, profile):
    """Stage-2 training at full width through the trainer that
    ``python -m pq3d_tpu_torch.run`` builds; returns the phase's
    numbers."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.unified_loader import (MixedTaskLoader,
                                                    UnifiedTaskLoader)
    from pq3d_tpu_torch.data.unified_pipeline import (collate_unified,
                                                      process_item)
    from pq3d_tpu_torch.ops import windowed_conv, zrun_conv

    torch.backends.cuda.matmul.allow_tf32 = False
    # dropout draws from the global generators: seed them so the phase's
    # weights do not depend on what ran before it
    torch.manual_seed(0)
    t_phase = time.time()
    exp_dir = tempfile.mkdtemp(prefix="pq3d_unified_train_")
    bs = int(load_config("unified_tasks_sceneverse")["dataloader"]
             ["batchsize"])
    overrides = [
        "data.train=[SyntheticRefer,SyntheticQA,SyntheticCaption]",
        "data.synthetic.n_points=50000", "data.synthetic.n_instances=32",
        # two train batches a dataset: 6 steps an epoch, 1 warm + 5 timed
        f"data.synthetic.num_train={2 * bs}",
        f"data.synthetic.num_val={UNIFIED_TRAIN_ITEMS_VAL}",
        # the YAML's 5000-step warmup makes the first steps' updates vanish
        "solver.sched.args.warmup_steps=0",
        "log_every=1", "device=cuda", f"exp_dir={exp_dir}"]
    try:
        cfg = load_config("unified_tasks_sceneverse", overrides)
        print("unified_train: unified_tasks_sceneverse at its widths, batch "
              f"{cfg['dataloader']['batchsize']} (eval "
              f"{cfg['dataloader']['batchsize_eval']}), overrides: "
              + " ".join(overrides[:-1]), flush=True)
        t0 = time.time()
        trainer = run.build_multitask_trainer(cfg)
        trainer._lazy_init()
        model = trainer.model
        print(f"unified_train: trainer built in {time.time() - t0:.1f} s, "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
              f"params", flush=True)
        groups = trainer._optimizer.param_groups
        gen_ids = {id(p) for p in model.generation_head.parameters()}
        gen = [g for g in groups if id(g["params"][0]) in gen_ids]
        rest = [g for g in groups if id(g["params"][0]) not in gen_ids]
        print("unified_train: AdamW groups (initial lr, weight decay, "
              "tensors): " + "; ".join(
                  f"{g['initial_lr']:g}, {g['weight_decay']:g}, "
                  f"{len(g['params'])}" for g in groups), flush=True)
        if not (len(gen) == 2 and all(
                all(id(p) in gen_ids for p in g["params"])
                and g["initial_lr"] == 1e-5 for g in gen)
                and all(g["initial_lr"] == 1e-4 for g in rest)):
            fail("the generation head's AdamW groups are not at 1e-5 beside "
                 "1e-4")

        zrun_conv.reset_counts()            # main path starts here
        windowed_conv.reset_counts()
        base = trainer.train_data
        runs = {"workers0": timed_train_run(trainer, base, 0, "workers=0",
                                            card)}
        nw = min(8, (os.cpu_count() or 2) - 1)
        pooled = MixedTaskLoader(
            [UnifiedTaskLoader(lo.dataset, lo.cfg, lo.batch_size, True,
                               seed=lo.seed, feature_dims=lo.feature_dims,
                               num_workers=nw) for lo in base.loaders],
            seed=base.seed)
        try:
            runs[f"workers{nw}"] = timed_train_run(
                trainer, pooled, 1, f"workers={nw}", card)
        finally:
            pooled.close()
        b1, b2 = zrun_conv.launches, windowed_conv.launches  # path ends
        lrs = [g["lr"] for g in groups]
        print(f"unified_train: rates after {trainer.step} steps: generation "
              f"head {gen[0]['lr']:.4e}, the rest {rest[0]['lr']:.4e} "
              f"(ratio {gen[0]['lr'] / rest[0]['lr']:.6f}) | launches of B1 "
              f"{b1} and B2 {b2} over both runs (neither is on the "
              f"stage-2 path)", flush=True)
        if abs(gen[0]["lr"] / rest[0]["lr"] - 0.1) > 1e-9 or b1 or b2 \
                or len(set(lrs)) != 2:
            fail("rates not at 1:10 after the steps, or a hand kernel ran on "
                 "the stage-2 training path")

        # learning: one QA batch's loss (ground and generation; train
        # mode, every dropout and memory dropout off) before and after 5
        # steps on it
        one = next(iter(base.loaders[1](99)))
        wb = trainer._put(one)
        before = batch_loss(trainer, wb)
        losses = [float(trainer.train_batch(one)["loss"]) for _ in range(5)]
        after = batch_loss(trainer, wb)
        print(f"unified_train: 5 steps on one batch, loss {losses} (dropout "
              f"and memory dropout on); both off {before:.4f} before, "
              f"{after:.4f} after", flush=True)
        if not after < before:
            fail("the unified loss did not fall over 5 steps on one batch")

        # card against the CPU, one train step at batch 4
        lo0 = base.loaders[0]
        sets = [lo.dataset for lo in base.loaders]
        rng = np.random.default_rng(7)
        items = [process_item(*sets[i % 3].get_item(i), lo0.cfg, rng, True,
                              lo0.feature_dims) for i in range(4)]
        np_batch = collate_unified(
            [{k: v for k, v in it.items() if not k.startswith("meta_")}
             for it in items], lo0.cfg, lo0.feature_dims, train=True)
        check, cpu_s = unified_train_check(trainer, cfg, np_batch,
                                           trainer._total_steps)
        f32, tf32 = gate_train_check("unified_train", check, cpu_s)

        # evaluation of the three val sets, the last batch of each
        # wrap-padded (128 + 4 real rows)
        torch.cuda.synchronize()
        t0 = time.time()
        results = trainer.eval_epoch(0)
        torch.cuda.synchronize()
        eval_s = time.time() - t0
        counts = {name: ev.total_count for name, _, ev in trainer.val_sets}
        cap = [ev for _, _, ev in trainer.val_sets if hasattr(ev, "_items")]
        keys_scored = [len({it["key"] for it in ev._items}) for ev in cap]
        print(f"unified_train: eval of 3 x {UNIFIED_TRAIN_ITEMS_VAL} items "
              f"(the metrics: the [eval 0] line above) in {eval_s:.2f} s | "
              f"items scored {counts}, distinct caption keys {keys_scored} "
              f"| target_metric {results['target_metric']:.4f}",
              flush=True)
        if not all(math.isfinite(v) for v in results.values()) \
                or set(counts.values()) != {UNIFIED_TRAIN_ITEMS_VAL} \
                or keys_scored != [UNIFIED_TRAIN_ITEMS_VAL]:
            fail("an eval metric is not finite or an item was not scored "
                 "exactly once")
        if profile:
            stem, ext = os.path.splitext(profile)
            profile_run(lambda: trainer.train_batch(one),
                        "unified train step", f"{stem}_unified_train{ext}")
        trainer._close_loaders()
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    total = time.time() - t_phase
    print(f"unified_train: phase {total:.1f} s ({card})", flush=True)
    return {"runs": runs, "check": f32, "check_tf32": tf32, "cpu_s": cpu_s,
            "eval_s": eval_s, "loss_before": before, "loss_after": after,
            "phase_s": total}


RECIPE_SPEC = {"n_train": 8, "n_val": 2}   # real-scan statistics otherwise
RECIPE_GATE = 2e-2                         # train_check's


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def last_metrics(exp_dir, prefix):
    """The last value of each eval metric a run logged under a prefix that
    starts with ``prefix`` (``val`` for stage 1, ``val-<dataset>`` for
    stage 2), keyed ``prefix/name``."""
    out = {}
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            p = str(rec.get("prefix", ""))
            if p.startswith(prefix):
                out.update({f"{p}/{k}": v for k, v in rec.items()
                            if k not in ("step", "time", "prefix")})
    return out


def all_finite(metrics):
    return bool(metrics) and all(
        isinstance(v, (int, float)) and math.isfinite(v)
        for v in metrics.values())


def recipe_stage(label, argv, zrun_conv, stage1, card):
    """One ``python -m pq3d_tpu_torch.run`` call in this process, with the
    B1 and assignment solver counts set to 0 just before it and read just
    after.  Records each batch's host-pipeline seconds (and the first train
    batch), each model forward's mode and routed convs (stage 1), each
    epoch's metrics and the peak memory; restores the signal handlers the
    trainer installs.  Gates B1 against the routed convs and the solver
    at one launch a set-criterion loss (each train step's and each eval
    forward's), never under the direct criterion or on stage 2."""
    import signal
    import torch
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.data import datasets, unified_loader
    from pq3d_tpu_torch.models.query3d import Query3DUnified
    from pq3d_tpu_torch.ops import hungarian
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    rec = {"host": [], "forwards": [], "epochs": [], "first": None,
           "offline_mask": []}

    def assembler(orig):
        def timed(*args):
            t = time.time()
            batch = orig(*args)
            train = bool(args[5])
            rec["host"].append((train, time.time() - t))
            if train:
                rec["offline_mask"].append("offline_attn_mask" in batch)
                if rec["first"] is None:
                    rec["first"] = batch
            return batch
        return timed

    def forward(orig):
        def counted(self, batch):
            if stage1:
                rec["forwards"].append((self.training, len(
                    self.voxel_encoder.backbone.routed_convs(
                        level_rows(batch)))))
            return orig(self, batch)
        return counted

    def epoch(orig):
        def recorded(self, e):
            out = orig(self, e)
            rec["epochs"].append(out)
            return out
        return recorded

    owner = (datasets, "_assemble_instseg_batch") if stage1 else \
        (unified_loader, "_assemble_unified_batch")
    handlers = {s: signal.getsignal(s) for s in (signal.SIGUSR1,
                                                 signal.SIGTERM)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zrun_conv.reset_counts()                   # this path starts here
    hungarian.reset_counts()
    t0 = time.time()
    try:
        with patched(*owner, assembler), \
                patched(Query3DUnified, "forward", forward), \
                patched(Query3DTrainer, "train_epoch", epoch):
            trainer = run.main(argv)
        torch.cuda.synchronize()
    finally:
        for sig, h in handlers.items():
            signal.signal(sig, h)
    rec["wall_s"] = time.time() - t0
    rec["counts"] = dict(zrun_conv.phase_launches)   # and ends here
    rec["hungarian"] = hungarian.launches
    rec["peak"] = torch.cuda.max_memory_allocated()
    steps = sum(int(e["batches"]) for e in rec["epochs"])
    epoch_s = sum(e["epoch_time_s"] for e in rec["epochs"])
    host_train = [h for tr, h in rec["host"] if tr]
    host_eval = [h for tr, h in rec["host"] if not tr]
    rec.update(steps=steps, epoch_s=epoch_s,
               steps_per_s=steps / max(epoch_s, 1e-9),
               host_train_s=sum(host_train) / max(len(host_train), 1),
               host_eval_s=sum(host_eval) / max(len(host_eval), 1))
    train_routed = [n for tr, n in rec["forwards"] if tr]
    eval_routed = [n for tr, n in rec["forwards"] if not tr]
    rec.update(train_routed=train_routed, eval_routed=eval_routed)
    print(f"recipe: {label}: {rec['wall_s']:.1f} s in all, {steps} steps "
          f"in {epoch_s:.2f} s ({rec['steps_per_s']:.3f} steps/s), host "
          f"pipeline {rec['host_train_s']:.3f} s a train batch "
          f"({len(host_train)}), {rec['host_eval_s']:.3f} s an eval batch "
          f"({len(host_eval)}) | max_memory_allocated "
          f"{rec['peak'] / 2**30:.2f} GiB | zrun_conv launches fwd "
          f"{rec['counts']['fwd']} bwd {rec['counts']['bwd']}, routed "
          f"convs per train forward {train_routed}, per eval forward "
          f"{eval_routed}; assignment solver launches {rec['hungarian']} "
          f"({card})", flush=True)
    crit = ((trainer.cfg["model"].get("InstSegLoss") or {}).get(
        "criterion_type", "set") if stage1 else None)
    want = len(rec["forwards"]) if crit == "set" else 0
    if rec["hungarian"] != want:
        fail(f"{label}: the assignment solver launched {rec['hungarian']} "
             f"times; {want} expected (one a {crit or 'stage-2'} loss)")
    if stage1:
        if len(train_routed) != steps or not all(train_routed):
            fail(f"{label}: {len(train_routed)} train forwards with "
                 f"routed convs {train_routed} for {steps} steps")
        # forward: every forward's routed convs; dx: the train steps'
        if rec["counts"]["fwd"] != sum(train_routed) + sum(eval_routed) \
                or rec["counts"]["bwd"] != sum(train_routed):
            fail(f"{label}: zrun_conv launches fwd {rec['counts']['fwd']} "
                 f"bwd {rec['counts']['bwd']} against routed convs "
                 f"{train_routed} (train) and {eval_routed} (eval)")
    elif rec["counts"]["fwd"] or rec["counts"]["bwd"]:
        fail(f"{label}: zrun_conv ran on the stage-2 path")
    return trainer, rec


def recipe_phase(card, dev, zrun_conv, synth_ms, flops_peak, bw_peak):
    """The JAX package's two-stage recipe (tools/dress_rehearsal.py) on a
    SceneVerse-layout replica at real-scan statistics, through
    ``python -m pq3d_tpu_torch.run``; returns the phase's numbers."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from pq3d_tpu_torch.data.datasets import SceneVerseInstSeg, load_pth
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.data.replica import ReplicaSpec, write_replica
    from pq3d_tpu_torch.models.sparse_unet import flatten_maps
    from pq3d_tpu_torch.ops.voxelize import quantize
    from pq3d_tpu_torch.serve import to_device

    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="pq3d_recipe_")
    base, pred, aux = (os.path.join(root, d) for d in ("base", "pred",
                                                        "aux"))
    out = {}
    try:
        # ---- the replica --------------------------------------------------
        spec = ReplicaSpec(**RECIPE_SPEC)
        t0 = time.time()
        ids = write_replica(base, pred, aux, spec)
        write_s = time.time() - t0
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(root) for f in fs)
        sd = os.path.join(base, "ScanNet", "scan_data")
        voxels, segments, instances = [], [], []
        for scan in ids:
            pts = load_pth(os.path.join(sd, "pcd_with_global_alignment",
                                        f"{scan}.pth"))[0]
            voxels.append(len(quantize(np.asarray(pts, np.float32),
                                       0.02)[0]))
            segments.append(int(np.asarray(load_pth(os.path.join(
                sd, "segment_id", f"{scan}.pth"))).max()) + 1)
            instances.append(len(load_pth(os.path.join(
                sd, "instance_id_to_label", f"{scan}.pth"))))
        print(f"recipe: replica of {spec.n_train} + {spec.n_val} scans "
              f"written in {write_s:.1f} s, {nbytes / 2**20:.1f} MiB; "
              f"{spec.n_points} points a scan; voxels at 0.02 m {voxels}, "
              f"segments {segments}, instances {instances}", flush=True)
        out["replica"] = {"write_s": write_s, "bytes": nbytes,
                          "voxels": voxels, "segments": segments,
                          "instances": instances}

        # ---- stage 1, its resume, the GT-query variant --------------------
        s1, gtd, s2 = (os.path.join(root, d) for d in ("stage1", "gt",
                                                        "stage2"))
        common = [f"data.scene_verse_base={base}",
                  f"data.scene_verse_aux={aux}",
                  "data.load_scan_options.load_image_segment_feat=true",
                  "data.load_scan_options.load_point_segment_feat=true",
                  "model.voxel_encoder.args.pallas_conv=true",
                  "log_every=1", "device=cuda"]
        t1, r1 = recipe_stage("stage 1 (instseg_sceneverse)", [
            "--config-name", "instseg_sceneverse", *common, f"exp_dir={s1}",
            "solver.epochs=1", "solver.epochs_per_eval=1"], zrun_conv, True,
            card)
        m1 = last_metrics(s1, "val")
        del t1
        t1b, r1b = recipe_stage("stage 1 resumed", [
            "--config-name", "instseg_sceneverse", f"exp_dir={s1}",
            "resume=true", "solver.epochs=2", "solver.epochs_per_eval=2"],
            zrun_conv, True, card)
        m1b = last_metrics(s1, "val")
        lost = sorted(set(m1) - set(m1b))
        print(f"recipe: stage 1 eval (official protocol, full resolution) "
              f"{ {k: m1[k] for k in sorted(m1)[:4]} } ...; after the "
              f"resume (epoch {t1b.tracker.epoch}) "
              f"{ {k: m1b[k] for k in sorted(m1b)[:4]} } ...; "
              f"{len(m1b)} metrics", flush=True)
        if not (all_finite(m1) and all_finite(m1b)) or lost \
                or t1b.tracker.epoch != 2:
            fail(f"stage 1: metrics not finite or lost across the resume "
                 f"{lost}")

        # B1 on a batch of 4 of these scans (eval mode), beside the
        # synthetic phase's 4 served scenes
        cfg1 = t1b.cfg
        scenes_ds = SceneVerseInstSeg(cfg1, "train")
        batch = make_batch([scenes_ds.get_scene(i) for i in range(4)],
                           pipeline_config(cfg1["data"]["instseg_options"]),
                           np.random.default_rng(0))
        rows = level_rows(batch)
        routed = t1b.model.voxel_encoder.backbone.routed_convs(rows)
        print(f"recipe: 4 replica scans collated, flat level rows {rows}, "
              f"{len(routed)} routed convs a forward: "
              f"{[r[0] for r in routed]}", flush=True)
        fm = flatten_maps(to_device(batch["maps"], dev))
        b1 = b1_shapes(zrun_conv, fm, routed, dev, flops_peak, bw_peak,
                       "recipe")
        b1_ms = sum(r["ms"] * r["per_forward"] for r in b1)
        print(f"recipe: B1 {b1_ms:.3f} ms a forward (median per call, "
              f"summed over the {len(routed)} routed convs) on SceneVerse-"
              f"statistics scans against {synth_ms:.3f} ms on the synthetic "
              f"phase's scenes ({card})", flush=True)
        del t1b, fm, batch, scenes_ds
        torch.cuda.empty_cache()

        tgt, rgt = recipe_stage("GT-query variant (instseg_sceneverse_gt)", [
            "--config-name", "instseg_sceneverse_gt", *common,
            f"exp_dir={gtd}", "solver.epochs=1", "solver.epochs_per_eval=0"],
            zrun_conv, True, card)
        gt_loss = [e.get("loss", float("nan")) for e in rgt["epochs"]]
        if not rgt["offline_mask"] or not all(rgt["offline_mask"]) \
                or not all(math.isfinite(x) for x in gt_loss):
            fail(f"GT variant: offline masks {rgt['offline_mask']}, loss "
                 f"{gt_loss}")
        print(f"recipe: GT variant: every batch carries offline_attn_mask "
              f"{rgt['first']['offline_attn_mask'].shape}, direct loss "
              f"{gt_loss}", flush=True)
        tc = train_check_phase(tgt, zrun_conv, rgt["first"])
        del tgt
        torch.cuda.empty_cache()

        # ---- stage 2, warm-started from stage 1 ---------------------------
        t2, r2 = recipe_stage("stage 2 (unified_tasks_sceneverse)", [
            "--config-name", "unified_tasks_sceneverse",
            f"data.scene_verse_base={base}", f"data.scene_verse_aux={aux}",
            f"data.scene_verse_pred={pred}", "dataloader.batchsize=8",
            "dataloader.batchsize_eval=8", "solver.epochs=1",
            "solver.epochs_per_eval=1", "solver.sched.args.warmup_steps=10",
            f"pretrain_ckpt_path={os.path.join(s1, 'ckpt', 'latest')}",
            "log_every=1", "device=cuda", f"exp_dir={s2}"], zrun_conv,
            False, card)
        m2 = last_metrics(s2, "val-")
        sets = sorted({k.split("/")[0] for k in m2})
        print(f"recipe: stage 2 warm start loaded {len(t2.warm_started)} "
              f"tensors (predicted {RECIPE_WARM_START_LOADED}); eval of "
              f"{len(sets)} datasets, {len(m2)} metrics, target_metric "
              f"{ {k: m2[k] for k in m2 if k.endswith('target_metric')} }",
              flush=True)
        if len(t2.warm_started) != RECIPE_WARM_START_LOADED:
            fail("the warm start loaded another count than predicted")
        if not all_finite(m2) or len(sets) != 7:
            fail(f"stage 2: eval metrics not finite or missing: {sets}")
        del t2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs = {"stage1": r1, "stage1_resume": r1b, "gt": rgt, "stage2": r2}
    for r in runs.values():
        r.pop("first", None)
    total = time.time() - t_phase
    print(f"recipe: phase {total:.1f} s ({card})", flush=True)
    out.update(runs=runs, b1=b1, b1_ms=b1_ms, train_check=tc,
               warm_started=RECIPE_WARM_START_LOADED, phase_s=total,
               hungarian={n: r["hungarian"] for n, r in runs.items()},
               launches={k: sum(runs[n]["counts"][k] for n in
                                ("stage1", "stage1_resume", "gt"))
                         for k in ("fwd", "bwd")})
    return out


# ---- phase ddp: data-parallel training and replicated serving ----------

# the stage-1 runs of phase ddp: phase 8's trainer (full width, the
# 70k-point scenes) at a global batch of 4, an epoch of four steps, on the
# user config that user_config writes (its eval batch is 4)
DDP_STAGE1 = ["model.voxel_encoder.args.pallas_conv=true",
              "data.train=[SyntheticInstSeg]", "data.val=[SyntheticInstSeg]",
              "data.synthetic.num_train=16", "data.synthetic.num_val=4",
              "data.synthetic.n_points=70000",
              "data.synthetic.n_instances=24",
              "data.synthetic.n_segments=400", "dataloader.batchsize=4",
              "solver.epochs=1", "solver.epochs_per_eval=0",
              "solver.epochs_per_save=0", "log_every=1"]
# stage 2: phase 11's widths and scenes at the YAML's batch of 128, one
# batch a dataset (three steps)
DDP_STAGE2 = ["data.train=[SyntheticRefer,SyntheticQA,SyntheticCaption]",
              "data.synthetic.n_points=50000",
              "data.synthetic.n_instances=32",
              "data.synthetic.num_train=128", "data.synthetic.num_val=4",
              "solver.sched.args.warmup_steps=0", "solver.epochs=1",
              "solver.epochs_per_eval=0", "solver.epochs_per_save=0",
              "log_every=1",
              # the synthetic tokenizer the YAML's HF names fall back to
              # here (no local HF files), without importing transformers
              "data_wrapper.tokenizer=null",
              "data_wrapper.generation_tokenizer=null"]
DDP_GATE = FLAT_RECT_GATE       # step 1's global loss, 2 ranks against 1
REPLICA_GATE = 1e-5             # replicated against one server's logits
# the mesh server as built against one server as built (self-mask off):
# a part's convs route by its rows, so a conv B1 runs for the whole batch
# may run plain for a part, and the two sum in other orders; B1's own gate
# against its plain version (b1_shapes) bounds that
MESH_BUILT_GATE = 1e-2
# each stage's runs (phase ddp's and phase mesh's) end after these steps:
# step 1 (all-plain) and the timed ones after it; a smaller dataset would
# shuffle other scenes into step 1
STAGE_STEPS = {"stage1": 2, "stage2": 2}
# phase mesh's runs: phase ddp's (the same global batches, the same steps)
# on a mesh
MESH_STAGE1 = DDP_STAGE1 + ["parallel.fsdp=2"]
MESH_STAGE2 = DDP_STAGE2 + ["parallel.tp=2"]
# the 2-rank launch's allocator: two tensor-parallel ranks, each holding
# all 128 rows, reserved 37.21 GiB each with the default one (peak
# allocated 23.85), leaving 2.65 GiB of the card free
MESH_ALLOC_CONF = "expandable_segments:True"
# phase ddp's configs: stage 1's runs read the user config that
# user_config writes from STAGE1_BASE; stage 2's runs name STAGE2_CONFIG
STAGE1_BASE = "instseg_sceneverse"
STAGE2_CONFIG = "unified_tasks_sceneverse"
DDP_DEVICE = "cuda:0"           # the card of every rank of phase ddp
# the user config that phase ddp's stage-1 runs name by path: the packaged
# instseg_sceneverse.yaml with these lines changed (the YAML's eval batch
# of 1 does not split over 2 ranks), which is the packaged config with
# USER_CONFIG_OVERRIDES
USER_CONFIG_EDITS = (('name: "instseg-sceneverse"',
                      'name: "smoke-${rng_seed}"'),
                     ("  batchsize_eval: 1\n", "  batchsize_eval: 4\n"))
USER_CONFIG_OVERRIDES = ["name=smoke-${rng_seed}",
                         "dataloader.batchsize_eval=4"]


def user_config(work):
    """Write phase ddp's user config (USER_CONFIG_EDITS on the packaged
    instseg_sceneverse.yaml) into ``work``; returns its path."""
    from pq3d_tpu_torch.config import config_path
    with open(config_path(STAGE1_BASE)) as f:
        text = f.read()
    for old, new in USER_CONFIG_EDITS:
        if text.count(old) != 1:
            fail(f"ddp: the packaged {STAGE1_BASE}.yaml holds "
                 f"{text.count(old)} lines {old!r}, not one")
        text = text.replace(old, new)
    path = os.path.join(work, "smoke_instseg.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


def process_start():
    """This process's start on the wall clock: its start in clock ticks
    after boot (/proc/self/stat) against the uptime."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def ddp_rank(argv):
    """One rank of phases ddp and mesh, run by ``python -m
    pq3d_tpu_torch.launch --entry chip_smoke:ddp_rank -- REPORT_DIR --run
    LABEL --steps=N <run arguments> [--run LABEL ...]``: it runs
    ``pq3d_tpu_torch.run.main`` once a run, one run after another in this
    process (which joined the group once), each with the trainer's
    ``train_batch`` wrapped to take step 1 all-plain (``all_plain``), set
    B1's counts to 0 after it (a run's main path is steps 2 on), time
    every later step (host clock to a synchronize) with the synced batch
    norms' all-reduces and the tensor-parallel collectives inside it (each
    between two synchronizes) and count its routed convs; the run ends
    after N steps, as a preemption ends it.  Then rank 0 holds B1 against
    its plain version at the routed shapes of the run's last batch.  Each
    rank writes REPORT_DIR/{LABEL}_rank{r}.json a run: the readings, the
    config the rank resolved, the run's wall stamps and the process's
    start-up stamps (process start, the launcher's rank stamps, this
    entry)."""
    entry = time.time()
    import copy
    import gc
    import torch
    from pq3d_tpu_torch import launch, run
    from pq3d_tpu_torch.models import query3d
    from pq3d_tpu_torch.models.sparse_unet import flatten_maps
    from pq3d_tpu_torch.ops import hungarian, windowed_conv, zrun_conv
    from pq3d_tpu_torch.parallel import dist, tp
    from pq3d_tpu_torch.serve import to_device
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    start = {"process": process_start(), "entry": entry,
             "imported": time.time(),
             **json.loads(os.environ[launch.RANK_WALL_ENV])}
    report_dir, runs, device_args = argv[0], [], []
    for arg in argv[1:]:
        if arg == "--run":
            runs.append({"label": None, "steps": None, "argv": []})
        elif arg.startswith("device="):
            device_args.append(arg)     # the launcher's, for every run
        elif runs[-1]["label"] is None:
            runs[-1]["label"] = arg
        elif arg.startswith("--steps=") and not runs[-1]["argv"]:
            runs[-1]["steps"] = int(arg.split("=", 1)[1])
        else:
            runs[-1]["argv"].append(arg)
    rank = dist.rank()
    cur = {"timed": False}

    def timing(fn, key):
        """``fn`` timed between synchronizes inside the timed steps, into
        the run's ``{key}_s`` and ``{key}_calls``: the synced batch norms'
        all-reduces (``bn``), the tensor-parallel collectives (``tp``: the
        all-reduces of a row product's forward and a column product's
        backward, the all-gathers of the gathered and scattered ones)."""
        def call(*a):
            if not cur["timed"]:
                return fn(*a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            cur["rec"][f"{key}_s"] += time.perf_counter() - t0
            cur["rec"][f"{key}_calls"] += 1
            return out
        return call
    sum_fn = dist._AllReduceSum
    saved = {"bn": (sum_fn.forward, sum_fn.backward),
             "tp": (tp._Reduce.forward, tp._Copy.backward, tp._gather),
             "train_batch": Query3DTrainer.train_batch,
             "build_model": query3d.build_model,
             "builders": dict(run.BUILDERS)}
    sum_fn.forward = staticmethod(timing(saved["bn"][0], "bn"))
    sum_fn.backward = staticmethod(timing(saved["bn"][1], "bn"))
    tp._Reduce.forward = staticmethod(timing(saved["tp"][0], "tp"))
    tp._Copy.backward = staticmethod(timing(saved["tp"][1], "tp"))
    tp._gather = timing(saved["tp"][2], "tp")

    def build_model(*a, **k):
        t0 = time.time()
        try:
            return saved["build_model"](*a, **k)
        finally:
            w = cur["rec"]["wall"]
            w["model_s"] = w.get("model_s", 0.0) + time.time() - t0
    query3d.build_model = build_model

    def builder(fn):
        def build(cfg):
            cur["rec"]["wall"]["build_start"] = time.time()
            cur["rec"]["cfg"] = copy.deepcopy(cfg)  # as this rank resolved it
            try:
                return fn(cfg)
            finally:
                cur["rec"]["wall"]["built"] = time.time()
        return build
    for task, fn in saved["builders"].items():
        run.BUILDERS[task] = builder(fn)

    def train_batch(self, batch):
        rec = cur["rec"]
        backbone = getattr(getattr(self.model, "voxel_encoder", None),
                           "backbone", None)
        mem = memory_now()
        rec["memory"].append(mem)
        print(f"[rank {rank}] {rec['label']} before step "
              f"{len(rec['memory'])}: " + memory_text(mem), flush=True)
        rec["wall"].setdefault("first_start", time.time())
        if "first" not in rec:
            with all_plain(self.model):
                m = saved["train_batch"](self, batch)
            rec["first"] = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize()
            rec["first_end"] = time.perf_counter()
            rec["wall"]["first_end"] = time.time()
            torch.cuda.reset_peak_memory_stats()
            zrun_conv.reset_counts()        # the main path starts here
            windowed_conv.reset_counts()
            hungarian.reset_counts()
            return m
        routed = (len(backbone.routed_convs(level_rows(batch)))
                  if backbone is not None else 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur["timed"] = True
        m = saved["train_batch"](self, batch)
        torch.cuda.synchronize()
        cur["timed"] = False
        rec["steps"].append({"s": time.perf_counter() - t0,
                             "end": time.perf_counter(),
                             "routed": routed, "loss": float(m["loss"])})
        cur["last"] = batch
        rec["wall"]["last_end"] = time.time()
        if cur["max_steps"] and len(rec["steps"]) + 1 >= cur["max_steps"]:
            self._preempted = True      # ends the run after this step
        return m
    Query3DTrainer.train_batch = train_batch
    try:
        for spec in runs:
            rec = {"label": spec["label"], "rank": rank,
                   "world": dist.world(),
                   "backend": (torch.distributed.get_backend()
                               if dist.is_initialized() else None),
                   "steps": [], "bn_s": 0.0, "bn_calls": 0, "tp_s": 0.0,
                   "tp_calls": 0, "memory": [], "start": start,
                   "wall": {"run_start": time.time()}}
            cur.update(rec=rec, max_steps=spec["steps"], last=None,
                       timed=False)
            trainer = run.main(spec["argv"] + device_args)
            torch.cuda.synchronize()
            rec["launches"] = dict(zrun_conv.phase_launches)  # path ends
            rec["b2_launches"] = windowed_conv.launches
            rec["hungarian"] = hungarian.launches
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
            rec["peak_reserved"] = torch.cuda.max_memory_reserved()
            sharding = trainer.sharding
            if sharding is None:
                rec["checksum"] = dist.param_checksum(trainer.model)
            else:
                full = sharding.full_state_dict()
                rec["checksum"] = dist.tensor_checksum(list(full.values()))
                rec["replicated_checksum"] = sharding.replicated_checksum()
                rec["param_bytes"] = sum(p.nbytes for p in sharding.params)
                rec["full_param_bytes"] = sum(full[n].nbytes
                                              for n in sharding.names)
                rec["mesh"] = sharding.mesh.describe()
                del full
            backbone = getattr(getattr(trainer.model, "voxel_encoder",
                                       None), "backbone", None)
            if rank == 0 and backbone is not None:
                dev = torch.device("cuda", torch.cuda.current_device())
                b = cur["last"]
                flops_peak, bw_peak = peaks_for(
                    torch.cuda.get_device_name(dev))
                rec["b1"] = b1_shapes(
                    zrun_conv, flatten_maps(to_device(b["maps"], dev)),
                    backbone.routed_convs(level_rows(b)), dev, flops_peak,
                    bw_peak, f"ddp {spec['label']} rank {rank}")
            rec["wall"]["run_end"] = time.time()
            with open(os.path.join(report_dir, f"{spec['label']}_rank"
                                   f"{rank}.json"), "w") as f:
                json.dump(rec, f)
            del trainer, sharding, backbone
            cur.update(rec=None, last=None)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        Query3DTrainer.train_batch = saved["train_batch"]
        sum_fn.forward = staticmethod(saved["bn"][0])
        sum_fn.backward = staticmethod(saved["bn"][1])
        tp._Reduce.forward = staticmethod(saved["tp"][0])
        tp._Copy.backward = staticmethod(saved["tp"][1])
        tp._gather = saved["tp"][2]
        query3d.build_model = saved["build_model"]
        run.BUILDERS.update(saved["builders"])


def ddp_launch(label, nproc, backend, runs, work, env=None, procs=None):
    """``python -m pq3d_tpu_torch.launch`` of ``nproc`` ranks on cuda:0
    over ``backend`` with ``ddp_rank`` as the entry, which runs ``runs``
    ((label, config, overrides, steps): each run ends after that many
    steps, as a preemption ends it) one after another in each rank
    (``env``: added to the ranks' environment; ``procs``: the launch's
    process is appended, for a caller that must stop it).  Returns
    {"runs": {label: {"reports", "logged", "ckpt_checksums", "config",
    "overrides", "exp_dir", "wall_split"}}, "wall_s", "start_split"}:
    each run's readings and rank 0's wall split of it, and the launch's
    wall split up to the first run (the launcher's start, the rank's
    interpreter, its imports, the group's init, the entry's imports) and
    after the last (the exit).  Fails the phase when the launch exits
    non-zero."""
    import torch
    out = os.path.join(work, label)
    os.makedirs(out)
    args = []
    for run_label, config, overrides, steps in runs:
        args += ["--run", run_label, f"--steps={steps}", "--config-name",
                 config, *overrides,
                 f"exp_dir={os.path.join(out, run_label)}"]
    cmd = [sys.executable, "-m", "pq3d_tpu_torch.launch", "--nproc-per-node",
           str(nproc), "--backend", backend, "--devices",
           ",".join([DDP_DEVICE] * nproc), "--entry", "chip_smoke:ddp_rank",
           "--", out, *args]
    env = dict(os.environ, PYTHONPATH=HERE, **(env or {}))
    t0 = time.time()
    with open(os.path.join(out, "log.txt"), "w") as log:
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        if procs is not None:
            procs.append(proc)
        try:
            rc = proc.wait(timeout=1200)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.time() - t0
    text = open(os.path.join(out, "log.txt")).read()
    if rc:
        errors = [line for line in text.splitlines()
                  if "Error" in line or "Killed" in line][:20]
        memory = [line for line in text.splitlines()
                  if "] before step" in line or "[launch]" in line]
        print("\n".join(errors + memory) + "\n" + text[-6000:],
              flush=True)
        fail(f"ddp: {label} ({nproc} rank(s), {backend}) exited {rc}")
    for line in text.splitlines():
        if line.startswith("[run] mesh") and "rank 0 at" in line:
            print(f"ddp: {label}: {line}", flush=True)
    result = {"runs": {}, "wall_s": wall}
    for run_label, config, overrides, steps in runs:
        reports = []
        for r in range(nproc):
            with open(os.path.join(out, f"{run_label}_rank{r}.json")) as f:
                reports.append(json.load(f))
        run_dir = os.path.join(out, run_label)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        state = torch.load(os.path.join(run_dir, "ckpt", "latest",
                                        "state.pt"),
                           map_location="cpu", weights_only=False,
                           mmap=True)
        with open(os.path.join(run_dir, "config.json")) as f:
            snapshot = json.load(f)
        w = reports[0]["wall"]
        result["runs"][run_label] = {
            "reports": reports, "logged": logged,
            "ckpt_checksums": state.get("rank_checksums"),
            "snapshot": snapshot,
            "config": config, "overrides": overrides, "exp_dir": run_dir,
            "wall_split": {
                "config": w["build_start"] - w["run_start"],
                "model": w["model_s"],
                "data": w["built"] - w["build_start"] - w["model_s"],
                "first_batch": w["first_start"] - w["built"],
                "first_step": w["first_end"] - w["first_start"],
                "steps": w["last_end"] - w["first_end"],
                "end": w["run_end"] - w["last_end"]}}
        del state
    s = reports[0]["start"]
    last = max(r["reports"][0]["wall"]["run_end"]
               for r in result["runs"].values())
    result["start_split"] = {
        "launcher": s["process"] - t0, "interpreter": s["main"]
        - s["process"], "imports": s["imports"] - s["main"],
        "group": s["group"] - s["imports"],
        "entry": s["imported"] - s["group"],
        "runs": last - s["imported"], "exit": wall - (last - t0)}
    return result


def memory_now():
    """The card's free memory, this process's allocations on it, its host
    RSS and the host's available memory, in GiB."""
    import torch
    free, total = torch.cuda.mem_get_info()
    host = {}
    for path, key in (("/proc/self/status", "VmRSS"),
                      ("/proc/meminfo", "MemAvailable")):
        with open(path) as f:
            for line in f:
                if line.startswith(key + ":"):
                    host[key] = int(line.split()[1]) / 2**20
    return {"card_free": free / 2**30, "card_total": total / 2**30,
            "allocated": torch.cuda.memory_allocated() / 2**30,
            "reserved": torch.cuda.memory_reserved() / 2**30,
            "host_rss": host.get("VmRSS"),
            "host_available": host.get("MemAvailable")}


def memory_text(m):
    return (f"card free {m['card_free']:.2f} of {m['card_total']:.2f} GiB, "
            f"this rank allocated {m['allocated']:.2f} GiB (reserved "
            f"{m['reserved']:.2f}); host RSS {m['host_rss']:.2f} GiB, host "
            f"available {m['host_available']:.2f} GiB")


def split_text(split):
    return ", ".join(f"{k.replace('_', ' ')} {v:.1f}"
                     for k, v in split.items())


def wall_text(run):
    """A run's wall split (rank 0's), in seconds."""
    return (f"{sum(run['wall_split'].values()):.1f} s "
            f"({split_text(run['wall_split'])})")


def ddp_summary(run):
    """steps/s from the end of step 1 to the end of the last (each step a
    global batch; the loader's waits included), the seconds of each step's
    ``train_batch``, the peaks, the synced batch norms' all-reduce share of
    those seconds."""
    reps = run["reports"]
    step_s = [sum(s["s"] for s in r["steps"]) for r in reps]
    wall = max(r["steps"][-1]["end"] - r["first_end"] for r in reps)
    return {"steps_per_s": len(reps[0]["steps"]) / wall,
            "step_s": [[s["s"] for s in r["steps"]] for r in reps],
            "peak_gib": [r["peak_bytes"] / 2**30 for r in reps],
            "bn_share": [r["bn_s"] / s for r, s in zip(reps, step_s)],
            "bn_calls_a_step": [r["bn_calls"] / len(r["steps"])
                                for r in reps],
            "launches": [r["launches"] for r in reps]}


def check_user_config(label, run, path):
    """Gate: every rank's resolved config and the run's snapshot
    (config.json) equal the packaged instseg_sceneverse with
    USER_CONFIG_OVERRIDES and the run's own overrides: the user file at
    ``path`` was read, by path, with its embedded interpolation."""
    from pq3d_tpu_torch.config import load_config
    want = load_config(STAGE1_BASE, [
        *USER_CONFIG_OVERRIDES, *run["overrides"],
        f"exp_dir={run['exp_dir']}", f"device={DDP_DEVICE}"])
    got = [r["cfg"] for r in run["reports"]] + [run["snapshot"]]
    if any(g != want for g in got):
        diff = sorted(k for g in got for k in set(g) | set(want)
                      if g.get(k) != want.get(k))
        fail(f"ddp: {label}: the config read from {path} differs from the "
             f"packaged one with {USER_CONFIG_OVERRIDES} at {diff}")
    print(f"ddp: {label}: read --config-name {path} (a user YAML file, "
          f"given relative to the ranks' working directory): every rank's "
          f"config and the snapshot equal the packaged "
          f"{STAGE1_BASE} with {USER_CONFIG_OVERRIDES} (name "
          f"{want['name']!r})", flush=True)


def ddp_stage(label, two, one, card, with_b1):
    """One stage of phase ddp: its run on 2 gloo ranks on cuda:0 (``two``)
    against its run on one nccl rank at the same global batch (``one``),
    ``STAGE_STEPS[label]`` steps each; gates and prints; returns the
    numbers."""
    r0, r1 = two["reports"]
    if not (r0["backend"] == r1["backend"] == "gloo" and r0["world"] == 2
            and one["reports"][0]["backend"] == "nccl"):
        fail(f"ddp: {label} ran on the wrong groups: "
             f"{[(r['backend'], r['world']) for r in two['reports']]}, "
             f"{one['reports'][0]['backend']}")
    if r0["checksum"] != r1["checksum"]:
        fail(f"ddp: {label}: the two ranks end with different weights")
    sums = two["ckpt_checksums"]
    if sums != [r0["checksum"]] * 2:
        fail(f"ddp: {label}: the checkpoint's rank checksums {sums}")
    loss2 = [x["loss"] for x in two["logged"] if x["prefix"] == "train"
             and x["step"] == 1][0]
    loss1 = [x["loss"] for x in one["logged"] if x["prefix"] == "train"
             and x["step"] == 1][0]
    rel = abs(loss2 - loss1) / abs(loss1)
    if not (r0["first"]["loss"] == r1["first"]["loss"] == loss2
            and rel <= DDP_GATE):
        fail(f"ddp: {label}: step 1's global loss {loss2!r} (ranks "
             f"{r0['first']['loss']!r}, {r1['first']['loss']!r}) against "
             f"one rank's {loss1!r}: rel {rel:.2e} (gate {DDP_GATE:.0e})")
    for run in (two, one):
        for r in run["reports"]:
            routed = sum(s["routed"] for s in r["steps"])
            fwd, bwd = r["launches"]["fwd"], r["launches"]["bwd"]
            if with_b1 and not fwd == bwd == routed > 0:
                fail(f"ddp: {label} rank {r['rank']}: B1 launched {fwd} "
                     f"forward, {bwd} dx for {routed} routed convs")
            if not with_b1 and fwd + bwd:
                fail(f"ddp: {label}: B1 ran on stage 2")
            solver = len(r["steps"]) if with_b1 else 0
            if r["hungarian"] != solver:
                fail(f"ddp: {label} rank {r['rank']}: the assignment solver "
                     f"launched {r['hungarian']} times in "
                     f"{len(r['steps'])} steps ({solver} expected)")
    s2, s1 = ddp_summary(two), ddp_summary(one)
    print(f"ddp: {label}: step 1 all-plain f32 global loss, 2 gloo ranks "
          f"{loss2:.6f} against 1 nccl rank {loss1:.6f} (rel {rel:.2e}, "
          f"gate {DDP_GATE:.0e}); weights checksums equal on both ranks "
          f"and in the checkpoint", flush=True)
    print(f"ddp: {label}: {s2['steps_per_s']:.3f} steps/s with 2 gloo ranks "
          f"on one card against {s1['steps_per_s']:.3f} with 1 nccl rank "
          f"(a step: the global batch, steps 2 on; train_batch s "
          f"{s2['step_s']} against {s1['step_s']}); peak per rank {s2['peak_gib']} GiB against "
          f"{s1['peak_gib']} GiB; synced batch norm all-reduces "
          f"{s2['bn_calls_a_step']} a step, their share of train_batch "
          f"{s2['bn_share']}; B1 launches per rank {s2['launches']} "
          f"against {s1['launches']}; assignment solver launches per rank "
          f"{[r['hungarian'] for r in two['reports']]} against "
          f"{[r['hungarian'] for r in one['reports']]}; run wall "
          f"{wall_text(two)} and "
          f"{wall_text(one)} ({card})", flush=True)
    return {"loss_2": loss2, "loss_1": loss1, "loss_rel": rel,
            "two": s2, "one": s1, "b1": r0.get("b1"),
            "wall_split": {"two": two["wall_split"],
                           "one": one["wall_split"]},
            "launches": {"fwd": sum(r["launches"]["fwd"]
                                    for r in two["reports"]),
                         "bwd": sum(r["launches"]["bwd"]
                                    for r in two["reports"])},
            "hungarian": sum(r["hungarian"] for run in (two, one)
                             for r in run["reports"])}


def replicated_phase(card, zrun_conv):
    """ReplicatedServer with two stage-1 replicas on cuda:0 (one model)
    against one InstSegServer on 8 scenes: every request answered, both
    replicas used, each scene's final logits within REPLICA_GATE of the
    single server's.  A scene meets other batch mates on a replica, so its
    forward must not depend on them: exact FPS (no scene's queries depend
    on which replica's generator it met) and phase 5b's caps, which hold
    every level of these scenes (the YAML's overflow, and then a level
    pads to its batch's largest scene).  Segment pooling sums with
    atomics, whose order moves the features by about 1e-6, and the
    decoder's self-mask turns that into flipped attend bits and logits
    1e-4 apart from run to run: the gate reads both servers with the
    self-mask off, and the self-mask-on difference is printed.  The main
    path is the replicated serving with the model as built (self-mask
    on)."""
    import dataclasses
    import torch
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import pipeline_config
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import InstSegServer, ReplicatedServer

    class Recording(InstSegServer):
        def __init__(self, *a, **k):
            self.logits, self._ids = {}, []
            super().__init__(*a, **k)

        def _dispatch(self, scenes, ids):
            self._ids = [id(s) for s in scenes]
            return super()._dispatch(scenes, ids)

        def _forward(self, batch):
            cls_l, mask_l = super()._forward(batch)
            for i, sid in enumerate(self._ids):
                self.logits[sid] = (cls_l[i].float(), mask_l[i].float(),
                                    batch["seg_pad_masks"][i])
            return cls_l, mask_l

    cfg = serving_config("rect",
                         [f"data.instseg_options.level_caps={LAYOUT_CAPS}"])
    pipe = dataclasses.replace(pipeline_config(cfg["data"]
                                               ["instseg_options"]),
                               fps_subsample=0)
    model = build_model(cfg, device="cuda", seed=0)
    encoder = model.unified_encoder
    scenes = make_scenes(8, seed=3)

    def server(device):
        return Recording(model, pipe, batch_size=4, num_classes=200,
                         topk=100, max_delay_s=0.02,
                         extra_features={"mv": 768, "pc": 768},
                         device=device)

    def serve(replicated):
        srv = (ReplicatedServer(server, devices=["cuda:0", "cuda:0"])
               if replicated else server("cuda:0"))
        t0 = time.time()
        try:
            answers = [f.result(timeout=900)
                       for f in [srv.submit(s) for s in scenes]]
            wall = time.time() - t0
            deadline = time.time() + 30   # the workers book a batch just
            while sum(r.stats.scenes for r in getattr(  # after resolving
                    srv, "replicas", [srv])) < 8 and time.time() < deadline:
                time.sleep(0.01)
        finally:
            srv.close()
        logits = {}
        for r in getattr(srv, "replicas", [srv]):
            logits.update(r.logits)
        return srv, answers, logits, wall

    def worst(a, b):
        out = 0.0
        for s in scenes:
            ca, ma, va = a[id(s)]
            cb, mb, vb = b[id(s)]
            out = max(out, rel_err(cb, ca), rel_err(mb[vb], ma[va]))
        return out
    rels = {}
    for self_mask in (False, True):
        encoder.use_self_mask = self_mask
        _, want, one, _ = serve(False)
        if self_mask:
            zrun_conv.reset_counts()             # main path starts here
        rep, got, many, wall = serve(True)
        if self_mask:
            launches = zrun_conv.launches        # main path ends here
        for a, b in zip(want, got):
            if not (isinstance(b, list) and len(a) == len(b)):
                fail("replicated: a request got no answer or another count "
                     "of instances")
        rels[self_mask] = worst(one, many)
    st = rep.stats_summary()
    print(f"replicated: 2 replicas on cuda:0 answered {st['scenes']} "
          f"scenes ({[p['scenes'] for p in st['replicas']]} each) in "
          f"{wall:.2f} s, {st['scenes_per_sec']:.3f} scenes/s summed; "
          f"final logits against one InstSegServer: rel "
          f"{rels[False]:.2e} with the self-mask off (gate "
          f"{REPLICA_GATE:.0e}), {rels[True]:.2e} with it on (not gated); "
          f"B1 launches {launches} ({card})", flush=True)
    if not (st["scenes"] == 8 and all(p["scenes"] > 0
                                      for p in st["replicas"])
            and rels[False] <= REPLICA_GATE and launches > 0):
        fail("replicated: the replicas disagree with one server or one "
             "replica idled")
    del model
    torch.cuda.empty_cache()
    return {"logits_rel": rels[False], "logits_rel_self_mask": rels[True],
            "launches": launches, "scenes_per_s": st["scenes_per_sec"]}


def ddp_phase(card, zrun_conv, beside=None):
    """Phase ddp: two launches, each running its runs one after another in
    its ranks: 2 gloo ranks on cuda:0 run stage 1 (DDP_STAGE1, read from
    the user YAML file that ``user_config`` writes, named by a path
    relative to the ranks' working directory), stage 1 with
    ``parallel.fsdp=2``, stage 2 and stage 2 with ``parallel.tp=2`` (the
    two mesh runs are phase mesh's, gated there on these records), and 1
    nccl rank runs stage 1 (the same file) and stage 2; then the gates,
    and ReplicatedServer.  ``beside``: a function this process runs while
    the launches run (phase export's exports, which are host work).
    Returns the numbers, with the mesh runs' records under
    ``mesh_runs``."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    work = tempfile.mkdtemp(prefix="pq3d_ddp_")
    procs = []
    try:
        path = os.path.relpath(user_config(work), HERE)
        steps1, steps2 = STAGE_STEPS["stage1"], STAGE_STEPS["stage2"]
        stage1 = ("stage1", path, DDP_STAGE1, steps1)
        stage2 = ("stage2", STAGE2_CONFIG, DDP_STAGE2, steps2)
        plan = {"gloo2": (2, "gloo", [
                    stage1, ("stage1_fsdp", path, MESH_STAGE1, steps1),
                    stage2, ("stage2_tp", STAGE2_CONFIG, MESH_STAGE2,
                             steps2)],
                    {"PYTORCH_CUDA_ALLOC_CONF": MESH_ALLOC_CONF}),
                "nccl1": (1, "nccl", [stage1, stage2], None)}

        def launch_all():
            return {label: ddp_launch(label, n, backend, runs, work, env,
                                      procs)
                    for label, (n, backend, runs, env) in plan.items()}
        t0 = time.time()
        with ThreadPoolExecutor(1) as pool:
            job = pool.submit(launch_all)
            try:
                if beside is not None:
                    beside()
                    print(f"ddp: this process's work beside the launches "
                          f"ended {time.time() - t0:.1f} s after they "
                          f"began", flush=True)
            except BaseException:
                for p in procs:             # stop the launch under way
                    if p.poll() is None:
                        p.kill()
                raise
            launches = job.result()
        print(f"ddp: launches ended {time.time() - t0:.1f} s after they "
              f"began", flush=True)
        gloo, nccl = launches["gloo2"]["runs"], launches["nccl1"]["runs"]
        for label, run in (("stage1_gloo2", gloo["stage1"]),
                           ("stage1_fsdp_gloo2", gloo["stage1_fsdp"]),
                           ("stage1_nccl1", nccl["stage1"])):
            check_user_config(label, run, path)
        s1 = ddp_stage("stage1", gloo["stage1"], nccl["stage1"], card,
                       with_b1=True)
        s2 = ddp_stage("stage2", gloo["stage2"], nccl["stage2"], card,
                       with_b1=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    walls = {}
    for label, launch in launches.items():
        walls[label] = {"wall_s": launch["wall_s"],
                        "start_split": launch["start_split"],
                        "runs": {k: r["wall_split"]
                                 for k, r in launch["runs"].items()}}
        print(f"ddp: launch {label}: {launch['wall_s']:.1f} s (rank 0: "
              f"{split_text(launch['start_split'])}); its runs: "
              + "; ".join(f"{k} {wall_text(r)}"
                          for k, r in launch["runs"].items())
              + f" ({card})", flush=True)
    rp = replicated_phase(card, zrun_conv)
    return {"stage1": s1, "stage2": s2, "replicated": rp,
            "launch_walls": walls,
            "mesh_runs": {k: gloo[k] for k in ("stage1_fsdp", "stage2_tp")}}


# phase mesh's runs: label -> (phase ddp's stage it mirrors, config,
# overrides); phase ddp makes them in its 2-rank launch
MESH_RUNS = {"stage1_fsdp": ("stage1", STAGE1_BASE,
                             USER_CONFIG_OVERRIDES + MESH_STAGE1),
             "stage2_tp": ("stage2", STAGE2_CONFIG, MESH_STAGE2)}


def mesh_train_phase(card, dd, work, labels=("stage1_fsdp", "stage2_tp")):
    """Phase mesh (i)-(ii) in a launch of their own (``labels``: which of
    MESH_RUNS), on 2 gloo ranks on cuda:0, gated against phase ddp's
    records ``dd`` (tools/torch_mesh_phase.py)."""
    launch = ddp_launch("mesh", 2, "gloo", [
        (label, MESH_RUNS[label][1], MESH_RUNS[label][2],
         STAGE_STEPS[MESH_RUNS[label][0]]) for label in labels], work,
        env={"PYTORCH_CUDA_ALLOC_CONF": MESH_ALLOC_CONF})
    print(f"mesh: launch {launch['wall_s']:.1f} s (rank 0: "
          f"{split_text(launch['start_split'])})", flush=True)
    return mesh_train_gates(card, dd, launch["runs"])


def mesh_train_gates(card, dd, runs):
    """Phase mesh (i)-(ii): FSDP stage 1 and tensor-parallel stage 2 on 2
    gloo ranks on cuda:0 (``runs``: their records), gated against phase
    ddp's records ``dd``."""
    out = {}
    for label, run in runs.items():
        stage = MESH_RUNS[label][0]
        ref = dd[stage]
        r0, r1 = run["reports"]
        if not (r0["backend"] == r1["backend"] == "gloo"
                and r0["mesh"].endswith("collectives: gloo")):
            fail(f"mesh: {label} ran on {r0['backend']}: {r0['mesh']}")
        loss = [x["loss"] for x in run["logged"] if x["prefix"] == "train"
                and x["step"] == 1][0]
        rel = abs(loss - ref["loss_1"]) / abs(ref["loss_1"])
        if not (r0["first"]["loss"] == r1["first"]["loss"] == loss
                and rel <= DDP_GATE):
            fail(f"mesh: {label}: step 1's global loss {loss!r} (ranks "
                 f"{r0['first']['loss']!r}, {r1['first']['loss']!r}) "
                 f"against phase 13's one rank {ref['loss_1']!r}: rel "
                 f"{rel:.2e} (gate {DDP_GATE:.0e})")
        sums = run["ckpt_checksums"]
        if not r0["checksum"] == r1["checksum"] == sums[0] == sums[1]:
            fail(f"mesh: {label}: the gathered weights differ: ranks "
                 f"{r0['checksum']}, {r1['checksum']}, checkpoint {sums}")
        for r in run["reports"]:
            routed = sum(x["routed"] for x in r["steps"])
            fwd, bwd = r["launches"]["fwd"], r["launches"]["bwd"]
            b1_ok = (fwd == bwd == routed > 0) if stage == "stage1" \
                else fwd + bwd == 0
            if not b1_ok or r["b2_launches"]:
                fail(f"mesh: {label} rank {r['rank']}: B1 launched {fwd} "
                     f"forward, {bwd} dx for {routed} routed convs; B2 "
                     f"{r['b2_launches']}")
            solver = len(r["steps"]) if stage == "stage1" else 0
            if r["hungarian"] != solver:
                fail(f"mesh: {label} rank {r['rank']}: the assignment "
                     f"solver launched {r['hungarian']} times in "
                     f"{len(r['steps'])} steps ({solver} expected)")
        s = ddp_summary(run)
        tp_share = [r["tp_s"] / sum(x["s"] for x in r["steps"])
                    for r in run["reports"]]
        tp_calls = [r["tp_calls"] / len(r["steps"]) for r in run["reports"]]
        if stage == "stage2":
            if r0["replicated_checksum"] != r1["replicated_checksum"]:
                fail(f"mesh: {label}: the tp peers' replicated weights "
                     "differ")
            if not min(tp_calls) > 0:
                fail(f"mesh: {label}: no tensor-parallel collective ran")
        base = ref["two"]
        print(f"mesh: {label}: step 1 all-plain f32 global loss "
              f"{loss:.6f} against phase 13's one nccl rank "
              f"{ref['loss_1']:.6f} (rel {rel:.2e}, gate {DDP_GATE:.0e}); "
              f"gathered weights' checksums equal on both ranks and in the "
              f"checkpoint; parameter bytes a rank "
              f"{[r['param_bytes'] for r in run['reports']]} of the full "
              f"model's {r0['full_param_bytes']} "
              f"({r0['param_bytes'] / r0['full_param_bytes']:.3f}); "
              f"{s['steps_per_s']:.3f} steps/s against phase 13's 2-rank "
              f"DDP {base['steps_per_s']:.3f} (train_batch s "
              f"{s['step_s']}); peak a rank {s['peak_gib']} GiB (DDP "
              f"{base['peak_gib']}), reserved "
              f"{[r['peak_reserved'] / 2**30 for r in run['reports']]} GiB; "
              f"tensor-parallel collectives a step "
              f"{tp_calls}, their share of train_batch {tp_share}; synced "
              f"batch norm all-reduces a step {s['bn_calls_a_step']}; B1 "
              f"launches per rank {s['launches']}; assignment solver "
              f"launches per rank {[r['hungarian'] for r in run['reports']]}"
              f"; before the last step "
              + "; ".join(f"rank {r['rank']}: {memory_text(r['memory'][-1])}"
                          for r in run["reports"])
              + f"; run wall {wall_text(run)} ({card})", flush=True)
        out[label] = {"loss": loss, "loss_rel": rel, "summary": s,
                      "param_bytes": [r["param_bytes"]
                                      for r in run["reports"]],
                      "full_param_bytes": r0["full_param_bytes"],
                      "tp_calls_a_step": tp_calls, "tp_share": tp_share,
                      "b1": r0.get("b1"), "mesh": r0["mesh"],
                      "memory": [r["memory"] for r in run["reports"]],
                      "wall_split": run["wall_split"],
                      "b2_launches": sum(r["b2_launches"]
                                         for r in run["reports"]),
                      "hungarian": sum(r["hungarian"]
                                       for r in run["reports"]),
                      "launches": {"fwd": sum(r["launches"]["fwd"]
                                              for r in run["reports"]),
                                   "bwd": sum(r["launches"]["bwd"]
                                              for r in run["reports"])}}
    return out


def mesh_server_phase(card, zrun_conv):
    """Phase mesh (iii): InstSegServer and UnifiedServer with
    mesh=["cuda:0", "cuda:0"] against one server each (see the module
    docstring).  Each part of a batch routes its convs by its own rows.
    Two stage-1 pairs, both with the decoder's self-mask off
    (replicated_phase says why): all-plain (``all_plain``), gated at
    REPLICA_GATE, and the main path, the model as built, gated at
    MESH_BUILT_GATE; then B1 against its plain version at the routed
    shapes of one part's forward (``b1_shapes``)."""
    import dataclasses
    import threading
    import torch
    from pq3d_tpu_torch.config import load_config, serving_config
    from pq3d_tpu_torch.data import unified_datasets as uds
    from pq3d_tpu_torch.data.instseg_pipeline import pipeline_config
    from pq3d_tpu_torch.data.unified_pipeline import UnifiedPipelineConfig
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.models.sparse_unet import flatten_maps
    from pq3d_tpu_torch.ops import windowed_conv
    from pq3d_tpu_torch.serve import InstSegServer, UnifiedServer
    mesh = ["cuda:0", "cuda:0"]

    class Recording(InstSegServer):
        """Keeps each scene's final logits and each part's first batch; a
        mesh part runs on its device's thread after ``_dispatch`` returns,
        so each part's scene ids wait in that part's queue, in batch
        order."""

        def __init__(self, *a, **k):
            self.logits, self._pending, self.part_batch = {}, {}, {}
            self._lock = threading.Lock()
            super().__init__(*a, **k)

        def _dispatch(self, scenes, ids):
            n = max(len(self.mesh_models), 1)
            rows = self.batch_size // n
            with self._lock:
                for part in range(n):
                    self._pending.setdefault(part, []).append(
                        [id(s) for s in scenes[part * rows:
                                               (part + 1) * rows]])
            return super()._dispatch(scenes, ids)

        def _forward_on(self, model, batch):
            cls_l, mask_l = super()._forward_on(model, batch)
            part = next(i for i, r in enumerate(self.mesh_models or [model])
                        if r is model)
            with self._lock:
                self.part_batch.setdefault(part, batch)
                for i, sid in enumerate(self._pending[part].pop(0)):
                    self.logits[sid] = (cls_l[i].float(),
                                        mask_l[i].float(),
                                        batch["seg_pad_masks"][i])
            return cls_l, mask_l

    cfg = serving_config("rect",
                         [f"data.instseg_options.level_caps={LAYOUT_CAPS}"])
    pipe = dataclasses.replace(pipeline_config(cfg["data"]
                                               ["instseg_options"]),
                               fps_subsample=0)
    model = build_model(cfg, device="cuda", seed=0)
    backbone = model.voxel_encoder.backbone
    expected = []       # routed convs of each forward (each mesh part's)
    model.register_forward_pre_hook(
        lambda mod, args: expected.append(len(backbone.routed_convs(
            level_rows(args[0])))))
    scenes = make_scenes(8, seed=3)

    def serve(on_mesh):
        srv = Recording(model, pipe, batch_size=4, num_classes=200,
                        topk=100, max_delay_s=SERVE_HOLD_S,
                        extra_features={"mv": 768, "pc": 768},
                        **({"mesh": mesh} if on_mesh
                           else {"device": "cuda:0"}))
        try:
            answers = [f.result(timeout=900)
                       for f in [srv.submit(s) for s in scenes]]
            settle(srv, len(scenes))
        finally:
            srv.close()
        for a in answers:
            if not isinstance(a, list):
                fail("mesh: a request got no answer")
        return srv

    serve(False)                # warm-up: the timed servers start warm
    rels, rates = {}, {}
    model.unified_encoder.use_self_mask = False
    for built in (False, True):
        with (contextlib.nullcontext() if built else all_plain(model)):
            one = serve(False)
            if built:
                zrun_conv.reset_counts()         # main path starts here
                windowed_conv.reset_counts()
                expected.clear()
            srv = serve(True)
        if built:
            launches = zrun_conv.launches        # main path ends here
            b2 = windowed_conv.launches
            parts = list(expected)
        rels[built] = max(
            max(rel_err(srv.logits[id(s)][0], one.logits[id(s)][0]),
                rel_err(srv.logits[id(s)][1][srv.logits[id(s)][2]],
                        one.logits[id(s)][1][one.logits[id(s)][2]]))
            for s in scenes)
        rates[built] = (srv.stats.summary()["scenes_per_sec"],
                        one.stats.summary()["scenes_per_sec"])
    model.unified_encoder.use_self_mask = True
    if not (rels[False] <= REPLICA_GATE and rels[True] <= MESH_BUILT_GATE
            and len(parts) == 2 * 2 and launches == sum(parts) > 0
            and b2 == 0):
        fail(f"mesh: the stage-1 mesh server: logits rel {rels[False]:.2e} "
             f"all-plain (gate {REPLICA_GATE:.0e}), {rels[True]:.2e} as "
             f"built (gate {MESH_BUILT_GATE:.0e}); B1 launches {launches} "
             f"against routed convs per part forward {parts}; B2 {b2}")
    print(f"mesh: InstSegServer(mesh=2 x cuda:0, batch 4): 8 scenes, final "
          f"logits against one server, self-mask off: rel {rels[False]:.2e}"
          f" all-plain (gate {REPLICA_GATE:.0e}), {rels[True]:.2e} as "
          f"built (gate {MESH_BUILT_GATE:.0e}); B1 launches {launches} = "
          f"routed convs of each part's forward {parts}; "
          f"{rates[True][0]:.3f} scenes/s against one server's "
          f"{rates[True][1]:.3f} (all-plain pair: {rates[False][0]:.3f} "
          f"against {rates[False][1]:.3f}) ({card})", flush=True)
    # B1 at the routed shapes of one part's forward (a part's rows)
    pb = srv.part_batch[0]
    dev = torch.device("cuda", 0)
    flops_peak, bw_peak = peaks_for(torch.cuda.get_device_name(dev))
    maps = {k: v.clone() if torch.is_tensor(v) else v   # out of the
            for k, v in pb["maps"].items()}             # inference mode
    part_b1 = b1_shapes(zrun_conv, flatten_maps(maps),
                        backbone.routed_convs(level_rows(pb)), dev,
                        flops_peak, bw_peak, "mesh part")
    if not part_b1:
        fail("mesh: a part's forward routed no conv to B1")
    del model, srv, one, pb, maps
    torch.cuda.empty_cache()

    ucfg = load_config("unified_tasks_sceneverse")
    upipe = UnifiedPipelineConfig(**ucfg["data"]["unified_options"])
    umodel = build_model(ucfg, device="cuda", seed=0)
    reqs = unified_requests(8, seed=2)
    tokens, urates = {}, {}
    for on_mesh in (False, True):
        srv = UnifiedServer(umodel, upipe, batch_size=8,
                            feature_dims={"mv": 768, "voxel": 128},
                            max_delay_s=SERVE_HOLD_S,
                            detokenize=uds.detokenize,
                            **({"mesh": mesh} if on_mesh
                               else {"device": "cuda:0"}))
        try:
            answers = [f.result(timeout=900)
                       for f in [srv.submit(r) for r in reqs]]
            settle(srv, len(reqs))
        finally:
            srv.close()
        tokens[on_mesh] = [a["generation_tokens"] for a in answers]
        urates[on_mesh] = srv.stats.summary()["scenes_per_sec"]
    same = all((a == b).all() for a, b in zip(tokens[True], tokens[False]))
    print(f"mesh: UnifiedServer(mesh=2 x cuda:0, batch 8): 8 requests, "
          f"tokens {'equal to' if same else 'NOT equal to'} one server's; "
          f"{urates[True]:.3f} requests/s against {urates[False]:.3f} "
          f"({card})", flush=True)
    if not same:
        fail("mesh: the unified mesh server's tokens differ from one "
             "server's")
    del umodel
    torch.cuda.empty_cache()
    return {"logits_rel_plain": rels[False], "logits_rel_built": rels[True],
            "launches": launches, "b2_launches": b2, "b1": part_b1,
            "scenes_per_s": rates[True][0],
            "one_scenes_per_s": rates[True][1],
            "unified_per_s": urates[True],
            "unified_one_per_s": urates[False]}


def mesh_phase(card, zrun_conv, dd):
    """Phase mesh: (i)-(ii) gated on the runs that phase ddp's 2-rank launch
    made (``dd["mesh_runs"]``; without them, in a launch of their own),
    (iii) in this process."""
    import gc
    import shutil
    import tempfile
    import torch
    t0 = time.time()
    if "mesh_runs" in dd:
        out = mesh_train_gates(card, dd, dd["mesh_runs"])
    else:
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"mesh: this process holds "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved); the "
              f"card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB "
              f"free for the ranks ({card})", flush=True)
        work = tempfile.mkdtemp(prefix="pq3d_mesh_")
        try:
            out = mesh_train_phase(card, dd, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    out["server"] = mesh_server_phase(card, zrun_conv)
    out["seconds"] = time.time() - t0
    print(f"mesh: phase {out['seconds']:.1f} s ({card})", flush=True)
    return out


# the JAX package's bench.py serving setups: (bf16 cast, two-phase, flat)
VARIANT_SETUPS = {"f32": (False, False, False), "bf16": (True, False, False),
                  "two_bf16": (True, True, False),
                  "flat_bf16": (True, False, True)}
VARIANT_HEADS = "model.heads=[ground,generation,qa]"
FLAT_GATE = 1e-5         # flat_obj against padded, f32, one batch
BF16_GATE = (0.1, 0.03)  # tests/test_bf16_modes.py: error / scale, margin
TOWER_GATE = (0.05, 0.005)   # the same file: max and mean |bf16 - f32|
VARIANT_TRAIN_BS = 32
VOTES_GATE = 1e-4


def variant_batch(reqs, pipe, feature_dims, seed, response=False):
    """``collate_unified`` of ``reqs`` (eval mode), without the padded
    layout's duplicate ``obj_fts`` and, unless asked, the responses."""
    import numpy as np
    from pq3d_tpu_torch.data.unified_pipeline import (collate_unified,
                                                      process_item)
    rng = np.random.default_rng(seed)
    items = [{k: v for k, v in process_item(
        s, l, pipe, rng, False, feature_dims).items()
        if not k.startswith("meta_")} for s, l in reqs]
    b = collate_unified(items, pipe, feature_dims, train=False)
    drop = {"obj_fts"} | (set() if response else {"response"})
    return {k: v for k, v in b.items() if k not in drop}


def variant_forward(model, b):
    """One eval forward of ``b``, the two-phase decode included: (outputs,
    tokens)."""
    import torch
    with torch.inference_mode():
        out = model(b)
        toks = out["generation_tokens"] if "generation_tokens" in out \
            else model.decode_states(out["generation_enc"],
                                     out["generation_enc_mask"])
    return out, toks


def variant_times(model, b, reps=3):
    """Device ms of one batch (CUDA events, median of ``reps``): the
    forward and the decode.  One phase: the decode is the generation
    head's span inside the forward; two phases: the forward, then
    ``decode_states`` on its states."""
    import torch
    head = model.generation_head
    spans, fwd, dec = [], [], []

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans.append(ev)
    hooks = [head.register_forward_pre_hook(mark),
             head.register_forward_hook(mark)]
    try:
        for _ in range(reps):
            spans.clear()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            with torch.inference_mode():
                ev[0].record()
                out = model(b)
                ev[1].record()
                if "generation_enc" in out:
                    model.decode_states(out["generation_enc"],
                                        out["generation_enc_mask"])
                ev[2].record()
            ev[2].synchronize()
            fwd.append(ev[0].elapsed_time(ev[1]))
            dec.append(ev[1].elapsed_time(ev[2]) if "generation_enc" in out
                       else spans[0].elapsed_time(spans[1]))
    finally:
        for h in hooks:
            h.remove()
    return {"forward": sorted(fwd)[reps // 2],
            "decode": sorted(dec)[reps // 2]}


def bf16_gate(ref, got, valid=None):
    """tests/test_bf16_modes.py's gate reading of f32 logits ``ref``
    against bf16 ones ``got`` (padded slots, ``~valid``, left out): (max
    error / the f32 scale, top-1 equal on every row whose f32 top-2 margin
    exceeds 0.03 of the scale, the number of such rows)."""
    import torch
    ref, got = ref.float().cpu(), got.float().cpu()
    if valid is not None:
        ref = torch.where(valid, ref, -1e9)
        got = torch.where(valid, got, -1e9)
    real = ref if valid is None else ref[valid]
    diff = (ref - got).abs() if valid is None else (ref - got).abs()[valid]
    scale = real.abs().max().item() + 1e-6
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) / scale > BF16_GATE[1]
    same = (ref.argmax(-1) == got.argmax(-1))[decided].all().item()
    return diff.max().item() / scale, bool(same), int(decided.sum())


def flat_rows(reqs, pipe, bs):
    """(F, real objects) of each batch of ``bs`` the flat layout would
    collate from ``reqs``."""
    from pq3d_tpu_torch.data.unified_pipeline import flat_obj_rows
    out = []
    for i in range(0, len(reqs), bs):
        n = [min(len(s["inst_labels"]), pipe.max_obj_len)
             for s, _ in reqs[i:i + bs]]
        n += [n[-1]] * (bs - len(n))
        out.append((flat_obj_rows(sum(n), bs, pipe.max_obj_len,
                                  pipe.flat_obj_bucket), sum(n)))
    return out


def serve_variant(label, model, pipe, cast, warm, reqs, feature_dims,
                  card):
    """``reqs`` through ``UnifiedServer(batch_size=8)`` after ``warm``:
    the summary, the peak memory and every answer checked."""
    import numpy as np
    import torch
    from pq3d_tpu_torch.data import unified_datasets as uds
    from pq3d_tpu_torch.serve import UnifiedServer
    srv = UnifiedServer(model, pipe, batch_size=8,
                        feature_dims=feature_dims, max_delay_s=0.02,
                        detokenize=uds.detokenize, device="cuda", cast=cast)
    try:
        for f in [srv.submit(r) for r in warm]:
            f.result(timeout=900)
        settle(srv, len(warm))
        srv.stats = type(srv.stats)()
        torch.cuda.reset_peak_memory_stats()
        results = [f.result(timeout=900)
                   for f in [srv.submit(r) for r in reqs]]
        settle(srv, len(reqs))
    finally:
        srv.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = srv.stats.summary()
    for r, (scene, _) in zip(results, reqs):
        n = min(len(scene["inst_labels"]), pipe.max_obj_len)
        g = r.get("ground_obj") if isinstance(r, dict) else None
        if g is None or not (0 <= g < n
                             and np.isfinite(r["ground_scores"][g])):
            fail(f"variants {label}: a request did not resolve to a valid "
                 f"object with a finite score")
        if np.asarray(r["generation_tokens"]).shape != (
                model.generation_head.cfg.max_new_tokens,):
            fail(f"variants {label}: generation tokens of a wrong shape")
    stages = " ".join(f"{k}={v:.3f}s" for k, v in sorted(
        st["stage_s"].items()))
    print(f"variants {label}: {st['scenes']} requests in {st['steps']} "
          f"batches of 8 | {st['scenes_per_sec']:.3f} scenes/s p50 "
          f"{st['p50_latency_s'] * 1e3:.1f} ms p99 "
          f"{st['p99_latency_s'] * 1e3:.1f} ms | {stages} | "
          f"max_memory_allocated {peak:.2f} GiB ({card})", flush=True)
    return {"scenes_per_sec": st["scenes_per_sec"],
            "p50_s": st["p50_latency_s"], "p99_s": st["p99_latency_s"],
            "stage_s": st["stage_s"], "peak_gib": peak}


def variants_serving(card, dev):
    """Phase 14 (a): the four serving setups of the ``qa`` model."""
    import copy
    import dataclasses
    import torch
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.unified_pipeline import UnifiedPipelineConfig
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import to_device
    from pq3d_tpu_torch.utils.inference import (cast_batch_bf16,
                                                cast_model_bf16)
    cfg = load_config("unified_tasks_sceneverse", [VARIANT_HEADS])
    feature_dims = {"mv": 768, "voxel": 128}
    pads = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
    flats = dataclasses.replace(pads, flat_obj=True)
    t0 = time.time()
    m32 = build_model(cfg, device="cuda", seed=0)
    m16 = cast_model_bf16(copy.deepcopy(m32))
    print(f"variants: unified_tasks_sceneverse with heads [ground, "
          f"generation, qa] ({m32.qa_head.MLPHead_0.Dense_1.out_features} "
          f"answers) built and cast in {time.time() - t0:.1f} s", flush=True)
    warm = unified_requests(8, seed=1)
    reqs = unified_requests(UNIFIED_REQUESTS, seed=2)
    one = {name: variant_batch(reqs[:8], p, feature_dims, 5)
           for name, p in (("pad", pads), ("flat", flats))}
    runs, outs = {}, {}
    for label, (bf16, two, flat) in VARIANT_SETUPS.items():
        model = m16 if bf16 else m32
        head = model.generation_head
        head.cfg = dataclasses.replace(head.cfg, two_phase=two)
        cast = cast_batch_bf16 if bf16 else None
        runs[label] = serve_variant(label, model, flats if flat else pads,
                                    cast, warm, reqs, feature_dims, card)
        b = to_device(one["flat" if flat else "pad"], dev)
        if cast is not None:
            b = cast(b)
        runs[label]["device_ms"] = variant_times(model, b)
        out, toks = variant_forward(model, b)
        scores = out["answer_scores"]
        if tuple(scores.shape) != (8, 8864) \
                or not torch.isfinite(scores.float()).all():
            fail(f"variants {label}: answer_scores of shape "
                 f"{tuple(scores.shape)} or not finite")
        outs[label] = (out["ground_logits"].float().cpu(),
                       scores.float().cpu(), toks.cpu())
        print(f"variants {label}: one batch on the device clock (CUDA "
              f"events, median of 3): forward "
              f"{runs[label]['device_ms']['forward']:.3f} ms, decode "
              f"{runs[label]['device_ms']['decode']:.3f} ms"
              f"{' (inside the forward)' if not two else ''} | "
              f"answer_scores {tuple(scores.shape)} finite", flush=True)
        head.cfg = dataclasses.replace(head.cfg, two_phase=False)
    rows = flat_rows(reqs, flats, 8)
    share = sum(f for f, _ in rows) / (len(rows) * 8 * flats.max_obj_len)
    print(f"variants flat_bf16: F per batch {[f for f, _ in rows]} for "
          f"{[n for _, n in rows]} real objects, against B x O = "
          f"{8 * flats.max_obj_len}: F / (B x O) {share:.4f}", flush=True)

    # f32, one batch with responses: flat against padded, two phases
    # against one
    pad_b = to_device(variant_batch(reqs[:8], pads, feature_dims, 5, True),
                      dev)
    flat_b = to_device(variant_batch(reqs[:8], flats, feature_dims, 5,
                                     True), dev)
    out_p, toks_p = variant_forward(m32, pad_b)
    out_f, toks_f = variant_forward(m32, flat_b)
    valid = pad_b["query_pad_masks"]
    flat_rel = {"ground_logits": rel_err(out_f["ground_logits"][valid],
                                         out_p["ground_logits"][valid])}
    for k in ("generation_logits", "answer_scores"):
        flat_rel[k] = rel_err(out_f[k], out_p[k])
    m32.generation_head.cfg = dataclasses.replace(
        m32.generation_head.cfg, two_phase=True)
    _, toks_2 = variant_forward(m32, pad_b)
    m32.generation_head.cfg = dataclasses.replace(
        m32.generation_head.cfg, two_phase=False)
    two_f32 = bool(torch.equal(toks_2, toks_p))
    two_bf16 = bool(torch.equal(outs["two_bf16"][2], outs["bf16"][2]))
    gates = {k: bf16_gate(outs["f32"][i], outs["bf16"][i],
                          valid.cpu() if i == 0 else None)
             for i, k in ((0, "ground_logits"), (1, "answer_scores"))}
    print(f"variants: flat_obj against padded (f32, one batch): "
          + " ".join(f"{k} rel {v:.3e}" for k, v in flat_rel.items())
          + f" (gate {FLAT_GATE:g}), tokens "
          f"{'equal' if torch.equal(toks_f, toks_p) else 'DIFFER'} | two "
          f"phases against one: tokens {'equal' if two_f32 else 'DIFFER'} "
          f"in f32, {'equal' if two_bf16 else 'DIFFER'} in bf16 | bf16 "
          f"against f32: " + " ".join(
              f"{k} error {e:.3e} of the scale (gate {BF16_GATE[0]:g}), "
              f"top-1 {'equal' if same else 'DIFFERS'} on {n} decided rows"
              for k, (e, same, n) in gates.items())
          + " | tokens bf16 = f32 on "
          f"{int((outs['bf16'][2] == outs['f32'][2]).all(-1).sum())} of 8 "
          f"rows", flush=True)
    if any(v > FLAT_GATE for v in flat_rel.values()) \
            or not torch.equal(toks_f, toks_p):
        fail("flat_obj disagrees with the padded layout")
    if not (two_f32 and two_bf16):
        fail("two-phase tokens differ from one-phase tokens")
    if not all(e < BF16_GATE[0] and same for e, same, _ in gates.values()):
        fail("the bf16 forward is outside test_bf16_modes' gate")
    runs["flat_share"] = share
    runs["flat_rel"] = flat_rel
    runs["bf16_gates"] = {k: v[0] for k, v in gates.items()}
    del m32, m16
    return runs


def variants_training(card, dev):
    """Phase 14 (b): the ``qa`` model trained in the flat object layout."""
    import math as _math
    import shutil
    import tempfile
    import numpy as np
    import torch
    from pq3d_tpu_torch import run
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data import unified_datasets as uds
    from pq3d_tpu_torch.data.unified_pipeline import (collate_unified,
                                                      process_item)
    torch.manual_seed(0)
    exp_dir = tempfile.mkdtemp(prefix="pq3d_variants_train_")
    bs = VARIANT_TRAIN_BS
    overrides = [
        VARIANT_HEADS, f"model.qa_num_answers={len(uds.SyntheticQA.COLORS)}",
        "data.unified_options.flat_obj=true",
        "data.train=[SyntheticQA,SyntheticRefer]",
        "data.synthetic.n_points=50000", "data.synthetic.n_instances=32",
        f"data.synthetic.num_train={2 * bs}",
        f"data.synthetic.num_val={bs}", f"dataloader.batchsize={bs}",
        f"dataloader.batchsize_eval={bs}",
        "solver.sched.args.warmup_steps=0", "log_every=1", "device=cuda",
        f"exp_dir={exp_dir}"]
    try:
        cfg = load_config("unified_tasks_sceneverse", overrides)
        t0 = time.time()
        trainer = run.build_multitask_trainer(cfg)
        trainer._lazy_init()
        names = [n for n, _ in trainer.loss_fn.entries]
        print(f"variants train: trainer built in {time.time() - t0:.1f} s "
              f"(overrides: {' '.join(overrides[:-1])}); losses {names}",
              flush=True)
        steps, it = [], iter(trainer.train_data(0))
        torch.cuda.reset_peak_memory_stats()
        while True:
            t = time.time()
            try:
                batch = next(it)
            except StopIteration:
                break
            host = time.time() - t
            t = time.time()
            m = trainer.train_batch(batch)
            torch.cuda.synchronize()
            steps.append({"host_s": host, "step_s": time.time() - t,
                          "flat_rows": int(batch["pc_obj_flat"].shape[0]),
                          **{k: float(v) for k, v in m.items()}})
        peak = torch.cuda.max_memory_allocated() / 2**30
        for i, s in enumerate(steps):
            print(f"variants train: step {i + 1}"
                  f"{' (warm)' if i == 0 else ''} loss {s['loss']:.4f} "
                  f"answer {s.get('answer_loss', float('nan')):.4f} "
                  f"ground {s.get('ground_loss', float('nan')):.4f} "
                  f"generation {s.get('generation_loss', float('nan')):.4f}"
                  f" | F {s['flat_rows']} of {bs * 80} | host pipeline "
                  f"{s['host_s']:.3f} s, step {s['step_s']:.3f} s",
                  flush=True)
        timed = steps[1:]
        rate = len(timed) / sum(s["step_s"] for s in timed)
        print(f"variants train: {len(timed)} timed steps at batch {bs}: "
              f"{rate:.3f} steps/s of train_batch ({rate * bs:.1f} items/s),"
              f" host pipeline {np.mean([s['host_s'] for s in timed]):.3f} "
              f"s a batch | max_memory_allocated {peak:.2f} GiB ({card})",
              flush=True)
        qa = [s for s in steps if "answer_loss" in s]
        if "answer_loss" not in names or len(steps) != 4 or not qa \
                or not all(_math.isfinite(s[k]) for s in steps for k in s):
            fail("variants train: answer_loss missing or a loss not finite")
        # four SyntheticQA items: every loss, answer_loss included
        lo0 = trainer.train_data.loaders[0]
        rng = np.random.default_rng(7)
        items = [process_item(*lo0.dataset.get_item(i), lo0.cfg, rng, True,
                              lo0.feature_dims) for i in range(4)]
        np_batch = collate_unified(
            [{k: v for k, v in it.items() if not k.startswith("meta_")}
             for it in items], lo0.cfg, lo0.feature_dims, train=True)
        check, cpu_s = unified_train_check(trainer, cfg, np_batch,
                                           trainer._total_steps)
        f32, _ = gate_train_check("variants train", check, cpu_s)
        results = trainer.eval_epoch(0)
        acc = {k: v for k, v in results.items()
               if k.startswith("SyntheticQA/ans")}
        print(f"variants train: ScanQAEval on {bs} SyntheticQA val items: "
              + " ".join(f"{k} {v:.4f}" for k, v in acc.items()),
              flush=True)
        if set(acc) != {"SyntheticQA/ans1_acc", "SyntheticQA/ans10_acc"} \
                or not all(_math.isfinite(v) for v in acc.values()):
            fail("variants train: ScanQAEval's acc@1 / acc@10 missing or "
                 "not finite")
        trainer._close_loaders()
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    return {"steps_per_s": rate, "peak_gib": peak, "check": f32,
            "acc": acc, "steps": steps}


def variant_vs_cpu(label, overrides, np_batch, dev, prep=None):
    """One batch of 8 through the model of ``overrides`` at full width on
    the card and on the CPU (f32, TF32 off): relative errors of the ground
    logits and the teacher-forced logits, tokens equal or not."""
    import copy
    import torch
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import to_device
    cfg = load_config("unified_tasks_sceneverse", overrides)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    if prep is not None:
        prep(cpu_model)
    model = copy.deepcopy(cpu_model).to(dev)
    with torch.inference_mode():
        got = model(to_device(np_batch, dev))
        ref = cpu_model(to_device(np_batch, torch.device("cpu")))
    valid = torch.from_numpy(np_batch["query_pad_masks"])
    rel = {"ground_logits": rel_err(got["ground_logits"].cpu()[valid],
                                    ref["ground_logits"][valid]),
           "generation_logits": rel_err(got["generation_logits"].cpu(),
                                        ref["generation_logits"])}
    same = bool(torch.equal(got["generation_tokens"].cpu(),
                            ref["generation_tokens"]))
    print(f"variants {label}: card vs CPU (f32, TF32 off), one batch of 8: "
          + " ".join(f"{k} rel {v:.3e}" for k, v in rel.items())
          + f" (gate {UNIFIED_GATE:g}) | greedy tokens "
          f"{'equal' if same else 'differ'}", flush=True)
    if any(v > UNIFIED_GATE for v in rel.values()):
        fail(f"variants {label}: the card disagrees with the CPU")
    return {**rel, "tokens_equal": same}


def vertical_bottom_forward(np_batch, dev, card):
    """Phase 14's ``pairwise_rel_type: vertical_bottom``: the model of
    ``model.obj_loc.pairwise_rel_type=vertical_bottom`` at full width, one
    forward of ``np_batch`` on the card, against the same model and
    weights with ``center``.  The model passes no box sizes (JAX's passes
    ``whls=None``), so the gate is bit-equal ground, teacher-forced and
    token outputs."""
    import torch
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import to_device
    cfg = load_config("unified_tasks_sceneverse",
                      ["model.obj_loc.pairwise_rel_type=vertical_bottom"])
    model = build_model(cfg, device="cuda", seed=0).eval()
    if model.pairwise_rel_type != "vertical_bottom":
        fail("variants: build_model did not read pairwise_rel_type")
    b = to_device(np_batch, dev)
    keys = ("ground_logits", "generation_logits", "generation_tokens")
    outs = {}
    for rel_type in ("vertical_bottom", "center"):
        model.pairwise_rel_type = rel_type
        with torch.inference_mode():
            out = model(b)
        outs[rel_type] = {k: out[k] for k in keys}
    same = {k: torch.equal(outs["vertical_bottom"][k], outs["center"][k])
            for k in keys}
    print(f"variants vertical_bottom: one forward of 8 requests at full "
          f"width, pairwise_rel_type vertical_bottom against center at the "
          f"same weights: "
          + ", ".join(f"{k} {'bit-equal' if same[k] else 'DIFFER'}"
                      for k in keys) + f" ({card})", flush=True)
    if not all(same.values()):
        fail("variants: vertical_bottom's outputs differ from center's")
    del model
    torch.cuda.empty_cache()
    return {"bit_equal": same}


def variants_one_batch(card, dev):
    """Phase 14 (c): gate + attention projection + image prompts, BERT,
    the bf16 tower, and PointnetSAModuleVotes, card against CPU."""
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.unified_pipeline import (PROMPT_IMAGE,
                                                      UnifiedPipelineConfig)
    from pq3d_tpu_torch.models.clip_text import CLIPTextEncoder
    from pq3d_tpu_torch.models.pointnet import PointnetSAModuleVotes
    from pq3d_tpu_torch.models.query3d import init_weights
    cfg = load_config("unified_tasks_sceneverse")
    pipe = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
    feature_dims = {"mv": 768, "voxel": 128}
    np_batch = variant_batch(unified_requests(8, seed=3), pipe,
                             feature_dims, 6, response=True)
    rng = np.random.default_rng(8)
    img = dict(np_batch, prompt_img_fts=rng.standard_normal(
        (8, pipe.prompt_len, 768)).astype(np.float32))
    img["prompt_type"] = np.where(np.arange(8) % 3 == 0, PROMPT_IMAGE,
                                  np_batch["prompt_type"])
    res = {"vertical_bottom": vertical_bottom_forward(np_batch, dev, card),
           "gate_attention_image": variant_vs_cpu(
        "gate + attention projection + image prompts (rows 0, 3, 6)",
        ["model.unified_encoder.args.structure=gate",
         "model.txt_encoder.args.projection_type=attention"], img, dev,
        prep=lambda m: m.image_encoder(768)),
        "bert": variant_vs_cpu(
            "BERTLanguageEncoder (projection_type: attention, which BERT "
            "has none of, as in JAX)",
            ["model.txt_encoder.name=BERTLanguageEncoder",
             "model.txt_encoder.args.projection_type=attention"],
            np_batch, dev)}

    # the CLIP tower at compute_dtype bfloat16 against f32, same weights
    tw = cfg["model"]["txt_tower"]
    kw = dict(output_dim=768, vocab_size=tw["vocab_size"],
              width=tw["width"], tower_heads=tw["heads"],
              tower_layers=tw["layers"])
    enc32 = CLIPTextEncoder(**kw)
    init_weights(enc32, torch.Generator().manual_seed(0))
    enc16 = CLIPTextEncoder(compute_dtype="bfloat16", **kw)
    enc16.load_state_dict(enc32.state_dict())
    enc32, enc16 = enc32.to(dev).eval(), enc16.to(dev).eval()
    txt = torch.from_numpy(np_batch["prompt_type"] == 1).to(dev)
    # LOC rows hold coordinates, not token ids: they read token 0
    ids = torch.where(txt[:, None], torch.from_numpy(
        np_batch["prompt"]).to(dev).long(), 0)
    mask = torch.from_numpy(np_batch["prompt_pad_masks"]).to(dev)
    with torch.inference_mode():
        o32 = enc32(ids, mask)
        o16 = enc16(ids, mask)
        ms = {k: cuda_time(lambda e=e: e(ids, mask), 5)
              for k, e in (("f32", enc32), ("bf16", enc16))}
    d = (o32 - o16).abs()[txt]
    tower = {"max": d.max().item(), "mean": d.mean().item(),
             "dtype": str(o16.dtype), **{f"{k}_ms": v for k, v in ms.items()}}
    print(f"variants tower_bf16: CLIP-large text encoder, compute_dtype "
          f"bfloat16 against float32 on the card (TXT rows): max "
          f"|diff| {tower['max']:.4f} (gate {TOWER_GATE[0]}), mean "
          f"{tower['mean']:.5f} (gate {TOWER_GATE[1]}), output "
          f"{tower['dtype']} | {ms['f32']:.3f} ms f32, {ms['bf16']:.3f} ms "
          f"bf16 a batch of 8 ({card})", flush=True)
    if not (tower["max"] < TOWER_GATE[0] and tower["mean"] < TOWER_GATE[1]
            and o16.dtype == torch.float32):
        fail("the bf16 CLIP tower is outside test_bf16_modes' tolerance")
    res["tower_bf16"] = tower

    # PointnetSAModuleVotes, rbf pooling, unique counts: 1024-point clouds
    votes = PointnetSAModuleVotes(3, (64, 64, 128), npoint=256, radius=0.2,
                                  nsample=16, pooling="rbf",
                                  ret_unique_cnt=True)
    init_weights(votes, torch.Generator().manual_seed(0))
    votes.eval()
    pts = rng.standard_normal((2, 1024, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True).max()
    rgb = rng.random((2, 1024, 3)).astype(np.float32)
    cpu_in = (torch.from_numpy(pts), torch.from_numpy(rgb))
    with torch.inference_mode():
        ref = votes(*cpu_in)
        got = [t.cpu() for t in votes.to(dev)(*(t.to(dev)
                                                 for t in cpu_in))]
    same = all(torch.equal(got[i], ref[i]) for i in (0, 2, 3))
    vrel = rel_err(got[1], ref[1])
    print(f"variants votes: PointnetSAModuleVotes (rbf, ret_unique_cnt) on "
          f"2 clouds of 1024 points, card vs CPU: centers, indices and "
          f"unique counts {'equal' if same else 'DIFFER'}, features rel "
          f"{vrel:.3e} (gate {VOTES_GATE:g}); unique neighbours a center "
          f"{got[3].float().mean().item():.2f} of 16", flush=True)
    if not same or vrel > VOTES_GATE:
        fail("PointnetSAModuleVotes on the card disagrees with the CPU")
    res["votes_rel"] = vrel
    return res


def variants_phase(card, dev):
    """Phase 14: stage 2's serving setups, the qa and flat_obj training,
    and the one-batch checks of the other options; returns the phase's
    numbers."""
    import torch
    from pq3d_tpu_torch.ops import windowed_conv, zrun_conv
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    zrun_conv.reset_counts()               # main path starts here
    windowed_conv.reset_counts()
    serving = variants_serving(card, dev)
    torch.cuda.empty_cache()
    training = variants_training(card, dev)
    torch.cuda.empty_cache()
    b1, b2 = zrun_conv.launches, windowed_conv.launches    # path ends
    one = variants_one_batch(card, dev)
    total = time.time() - t0
    print(f"variants: launches of B1 {b1} and B2 {b2} over the serving and "
          f"training runs (neither is on a stage-2 path) | phase "
          f"{total:.1f} s ({card})", flush=True)
    if b1 or b2:
        fail("a hand kernel ran on a stage-2 path")
    return {"serving": serving, "training": training, "one_batch": one,
            "b1": b1, "b2": b2, "phase_s": total}


# ---- phase swin_layouts: the Swin3D backbone and the flat device maps ---

# dev_flat: card-built flat maps against host ones; card_cpu: the card
# against the CPU with the sparse convs in f32; card_cpu_served: the same as
# served, where a last-bit f32 difference flips a bf16 conv operand's
# rounding by one bf16 step (2^-8 of the element): a few such steps
# bf16_mask: the cast's mask logits against f32, read up to the first
# flipped attend bit; they carry the level-0 segment mean summed in bf16
# (as JAX sums it), which the card's atomic adds round in another order
# each run: one batch's reading moves between 0.048 and 0.102 over
# repeated forwards (tools/torch_bf16_spread.py), so twice the largest
SWIN_GATES = {"dev_flat": 1e-5, "card_cpu": 1e-3,
              "card_cpu_served": 4 * 2**-8, "bf16_mask": 0.2}
SWIN_BF16_REPS = 4  # forwards of the checked batch a bf16 gate reads
SWIN_TIMED = 8      # timed requests a setup: 2 batches of 4
SWIN_SEEDS = (1, 2)  # more weight seeds for the bf16 readings
# the swin config's run.py call: a few steps, then the evaluator
SWIN_TRAIN = ["data.synthetic.num_train=6", "data.synthetic.num_val=4",
              "solver.epochs=1", "solver.epochs_per_eval=1",
              "solver.epochs_per_save=0", "log_every=1", "device=cuda"]


def final_logits(cls, mask):
    """Final-round class logits without the filtered classes (0 and 2,
    -1e9 on every row) and mask logits, in f32."""
    import torch
    keep = torch.ones(cls.shape[-1], dtype=torch.bool, device=cls.device)
    keep[[0, 2]] = False
    return cls.float()[..., keep], mask.float()


def rounds_of(classes, masks):
    """Every decoder round's class and mask logits, in f32 on the host,
    and its attend bits, formed from the logits as they came out (their
    device and dtype) as MaskHeadSegLevel forms the next round's
    self-mask: sigmoid >= 0.5, which also holds for logits a little
    below 0."""
    from pq3d_tpu_torch.models.heads import _sigmoid
    return ([c.float().cpu() for c in classes],
            [m.float().cpu() for m in masks],
            [(_sigmoid(m) >= 0.5).cpu() for m in masks])


def out_rounds(out):
    """rounds_of a model output."""
    return rounds_of(out["predictions_class"], out["predictions_mask"])


def first_flips(ref, got, seg_valid):
    """Scene by scene, the first decoder round in which two forwards'
    (out_rounds) attend bits on a valid segment differ; the number of
    rounds where none does."""
    out = []
    for s, valid in enumerate(seg_valid.cpu()):
        v = valid[:, None]
        out.append(next((r for r, (a, b) in enumerate(zip(ref[2], got[2]))
                         if ((a[s] != b[s]) & v).any()), len(ref[2])))
    return out


def per_round(ref, got, seg_valid):
    """Round by round, the final_logits pairs (class, mask) of ``ref`` and
    ``got`` and the valid segments of the scenes that have not flipped an
    attend bit before this round (first_flips).  Past a flipped bit the
    forwards attend differently and part by more than rounding, so two
    forwards that sum in another order are compared up to it: a flip under
    rounding noise is a tie at the threshold."""
    valid = seg_valid.cpu()
    flips = first_flips(ref, got, valid)
    for r in range(len(ref[0])):
        idx = [s for s, f in enumerate(flips) if f >= r]
        if not idx:
            return
        yield (final_logits(ref[0][r][idx], ref[1][r][idx]),
               final_logits(got[0][r][idx], got[1][r][idx]), valid[idx])


def rounds_rel(ref, got, seg_valid):
    """The largest rel_err of the class logits and of the mask logits of
    the valid segments in each round of per_round: (error, first flipped
    round by scene)."""
    worst = 0.0
    for (c, m), (cg, mg), v in per_round(ref, got, seg_valid):
        vm = v[:, :, None].expand_as(m)
        worst = max(worst, rel_err(cg, c), rel_err(mg[vm], m[vm]))
    return worst, first_flips(ref, got, seg_valid)


def instseg_bf16_gate(ref, got, seg_valid):
    """bf16_gate on stage-1 logits, ``ref`` f32 and ``got`` bf16 (class,
    mask) pairs as final_logits gives them: the class logits, and the mask
    logits of the valid segments.  Returns (class error, mask error, top-1
    equal on the decided rows, decided rows)."""
    cls_rel, same, decided = bf16_gate(ref[0], got[0])
    mask_rel, _, _ = bf16_gate(ref[1], got[1], seg_valid.cpu()[
        :, :, None].expand_as(ref[1]))
    return cls_rel, mask_rel, same, decided


def bf16_reading(ref, got, seg_valid):
    """An f32 and a bf16 forward (out_rounds) of one batch: instseg_bf16_gate
    in every round of per_round, the gated reading
    ({class, mask} error, top-1 equal, decided rows, first flipped round
    by scene), and on the final round of the batch (final_*)."""
    rec = {"cls_rel": 0.0, "mask_rel": 0.0, "top1_equal": True,
           "decided": 0, "flips": first_flips(ref, got, seg_valid),
           "rounds": len(ref[0])}
    for pair, pair_got, v in per_round(ref, got, seg_valid):
        e, em, same, n = instseg_bf16_gate(pair, pair_got, v)
        rec["cls_rel"], rec["mask_rel"] = (max(rec["cls_rel"], e),
                                           max(rec["mask_rel"], em))
        rec["top1_equal"] &= same
        rec["decided"] += n
    final = instseg_bf16_gate(final_logits(ref[0][-1], ref[1][-1]),
                              final_logits(got[0][-1], got[1][-1]),
                              seg_valid)
    rec.update(final_cls_rel=final[0], final_mask_rel=final[1],
               final_top1_equal=final[2])
    return rec


def bf16_text(r):
    return (f"every round up to a flipped attend bit: class rel "
            f"{r['cls_rel']:.3e}, mask rel {r['mask_rel']:.3e}, top-1 equal "
            f"on all {r['decided']} decided rows {r['top1_equal']}, first "
            f"flipped round by scene {r['flips']} of {r['rounds']} | final "
            f"round: class rel "
            f"{r['final_cls_rel']:.3e}, mask rel {r['final_mask_rel']:.3e}, "
            f"top-1 equal {r['final_top1_equal']}")


def check_bf16_gate(label, forward, seg_valid):
    """tests/test_bf16_modes.py's gate on one batch, read SWIN_BF16_REPS
    times (``forward()`` gives out_rounds of the f32 and the bf16
    forward): bf16_reading's class error below 0.1 of the scale with
    top-1 equal, its mask error below SWIN_GATES['bf16_mask'], in every
    repeat; fails the phase otherwise.  Returns the worst reading with the
    mask errors of all repeats."""
    reads = [bf16_reading(*forward(), seg_valid)
             for _ in range(SWIN_BF16_REPS)]
    r = dict(max(reads, key=lambda x: x["mask_rel"]),
             cls_rel=max(x["cls_rel"] for x in reads),
             top1_equal=all(x["top1_equal"] for x in reads),
             mask_rels=[x["mask_rel"] for x in reads])
    print(f"swin_layouts: {label}, the worst of {len(reads)} forwards: "
          f"{bf16_text(r)} (gate: class {BF16_GATE[0]}, mask "
          f"{SWIN_GATES['bf16_mask']}) | mask rel by forward "
          f"{[round(x, 4) for x in r['mask_rels']]}", flush=True)
    if not (r["cls_rel"] < BF16_GATE[0] and r["top1_equal"]
            and r["mask_rel"] < SWIN_GATES["bf16_mask"]):
        fail(f"swin_layouts: {label} fails the bf16 gate")
    return r


def bf16_served_readings(label, f32_rec, bf16_rec):
    """instseg_bf16_gate on every served batch of two serve_instseg runs of
    the same scenes, f32 and cast (readings; the gate is on one batch)."""
    out = []
    for (c, m, v), (cb, mb, _) in zip(f32_rec["logits"],
                                      bf16_rec["logits"]):
        if c.shape != cb.shape or m.shape != mb.shape:
            fail(f"swin_layouts: {label}: the two runs batched differently")
        out.append(instseg_bf16_gate(final_logits(c, m),
                                     final_logits(cb, mb), v)[:3])
    print(f"swin_layouts: {label} over the {len(out)} served batches "
          f"(readings): class rel max {max(r[0] for r in out):.3e}, mask "
          f"rel max {max(r[1] for r in out):.3e}, by batch "
          f"{[round(r[1], 4) for r in out]}, top-1 equal on every batch: "
          f"{all(r[2] for r in out)}", flush=True)
    return {"cls_rel": [r[0] for r in out], "mask_rel": [r[1] for r in out],
            "top1_equal": all(r[2] for r in out)}


def bf16_seed_readings(label, cfg, b, seeds):
    """instseg_bf16_gate on the device batch ``b`` for the model of
    ``cfg`` with each weight seed in ``seeds`` against its own cast
    (readings)."""
    import torch
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.utils.inference import (cast_batch_bf16,
                                                cast_model_bf16)
    out = {}
    for seed in seeds:
        model = build_model(cfg, device="cuda", seed=seed)
        with torch.inference_mode():
            ref = out_rounds(model(b))
        cast_model_bf16(model)
        with torch.inference_mode():
            got = out_rounds(model(cast_batch_bf16(b)))
        out[seed] = bf16_reading(ref, got, b["seg_pad_masks"])
        print(f"swin_layouts: {label} with weight seed {seed} (reading): "
              f"{bf16_text(out[seed])}", flush=True)
        del model
    return out


def split_forward(model, b, reps=3):
    """One eval forward of the device batch ``b``, median of ``reps`` on
    the device clock (CUDA events), split into the backbone, its window
    attention (summed over blocks), the flat map build (when the model
    builds its maps) and the rest (outside the backbone)."""
    import torch
    from pq3d_tpu_torch.models.swin3d import WindowAttention
    from pq3d_tpu_torch.ops import device_flat_maps
    spans = {"backbone": [], "attention": [], "map_build": []}

    def timed(key):
        def pre(mod, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[key].append([ev])

        def post(mod, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[key][-1].append(ev)
        return pre, post
    hooks = []
    targets = [(model.voxel_encoder.backbone, "backbone")] + [
        (m, "attention") for m in model.modules()
        if isinstance(m, WindowAttention)]
    for mod, key in targets:
        pre, post = timed(key)
        hooks += [mod.register_forward_pre_hook(pre),
                  mod.register_forward_hook(post)]

    def build(orig):
        def wrapped(*a, **k):
            pre, post = timed("map_build")
            pre(None, None)
            out = orig(*a, **k)
            post(None, None, None)
            return out
        return wrapped
    runs = []
    try:
        with patched(device_flat_maps, "build_flat_maps", build):
            for _ in range(reps):
                for v in spans.values():
                    v.clear()
                a = torch.cuda.Event(enable_timing=True)
                z = torch.cuda.Event(enable_timing=True)
                a.record()
                with torch.inference_mode():
                    model(b)
                z.record()
                z.synchronize()
                rec = {k: sum(x.elapsed_time(y) for x, y in v)
                       for k, v in spans.items()}
                rec["forward"] = a.elapsed_time(z)
                rec["rest"] = rec["forward"] - rec["backbone"]
                runs.append(rec)
    finally:
        for h in hooks:
            h.remove()
    runs.sort(key=lambda r: r["forward"])
    return runs[len(runs) // 2]


def swin_train(card):
    """``python -m pq3d_tpu_torch.run --config-name
    instseg_swin3d_synthetic`` on the card for a few steps and its
    evaluation (finite losses and metrics), then one step of its trainer
    on the card against a deep copy on the CPU through gate_train_check,
    every conv plain in f32 and the self-mask off (all_plain), with the
    TF32 control."""
    import math as _math
    import shutil
    import tempfile
    import torch
    from pq3d_tpu_torch import run
    exp_dir = tempfile.mkdtemp(prefix="pq3d_swin_train_")
    try:
        torch.manual_seed(0)
        t0 = time.time()
        trainer = run.main(["--config-name", "instseg_swin3d_synthetic",
                            *SWIN_TRAIN, f"exp_dir={exp_dir}"])
        run_s = time.time() - t0
        with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        train = [r for r in recs if r.get("prefix") == "train"]
        val = last_metrics(exp_dir, "val")
        losses = [r["loss"] for r in train]
        print(f"swin_layouts: run.py instseg_swin3d_synthetic "
              f"({' '.join(SWIN_TRAIN)}): {len(train)} steps in "
              f"{run_s:.1f} s, losses {[round(x, 4) for x in losses]}, "
              f"eval {len(val)} metrics, "
              f"backbone {type(trainer.model.voxel_encoder.backbone).__name__}"
              f" ({card})", flush=True)
        if not train or not val or not all(
                _math.isfinite(x) for x in losses) or not all_finite(val):
            fail("swin_layouts: the swin config's run has a missing or "
                 "non-finite loss or metric")
        np_batch = {k: v for k, v in next(iter(trainer.train_data(1))).items()
                    if not k.startswith("_")}
        with all_plain(trainer.model):
            check, cpu_s = unified_train_check(
                trainer, trainer.cfg, np_batch, trainer._total_steps)
            f32, _ = gate_train_check("swin_layouts train", check, cpu_s)
        trainer._close_loaders()
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    return {"steps": len(train), "losses": losses, "run_s": run_s,
            "eval": val, "check": {k: v for k, v in f32.items()
                                   if k not in ("worst", "noise")}}


def swin_layouts_phase(card, dev):
    """Phase 15: the full-width swin model behind InstSegServer in
    flat_swin, dev_flat_swin and flat_swin_bf16, phase 5b's Res16UNet in
    dev_flat_zt and flat_zt_bf16, the card-built flat maps against the
    host's, the card against the CPU, the bf16 gates and the swin config's
    training; returns the phase's numbers (see the module docstring)."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import LOCK_PROBE, serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import (collate_flat,
                                                      device_flat_lock,
                                                      make_batch,
                                                      pipeline_config,
                                                      process_scene)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.ops import device_flat_maps, sparse
    from pq3d_tpu_torch.serve import to_device
    from pq3d_tpu_torch.utils.inference import (cast_batch_bf16,
                                                cast_model_bf16)
    t_phase = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    over = [f"data.instseg_options.level_caps={LAYOUT_CAPS}"]
    warm = make_scenes(4, seed=2)
    scenes = make_scenes(SWIN_TIMED, seed=3)
    pipes = {lay: pipeline_config(serving_config(lay, over)[
        "data"]["instseg_options"]) for lay in ("flat_swin", "flat_zt")}
    locks = {lay: device_flat_lock(warm + scenes, pipes[probe], 4)
             for lay, probe in LOCK_PROBE.items()}
    cfgs = {lay: serving_config(lay, over, flat_caps=locks.get(lay))
            for lay in ("flat_swin", "dev_flat_swin", "flat_zt",
                        "dev_flat_zt")}
    pipes = {lay: pipeline_config(c["data"]["instseg_options"])
             for lay, c in cfgs.items()}
    for lay, lock in locks.items():
        print(f"swin_layouts: {lay} lock (device_flat_lock on the largest "
              f"scene x 4, margin 1.3): {lock}", flush=True)

    def on_card(np_batch):
        b = to_device({k: v for k, v in np_batch.items() if k != "_meta"},
                      dev)
        n = b["seg_pad_masks"].shape[0]
        for name, dim in SERVE_EXTRA.items():
            b[f"{name}_seg_fts"] = torch.zeros(
                n, pipes["flat_swin"].max_segments, dim, device=dev)
            b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
        return b

    def batch_of(lay, group):
        return on_card(make_batch([dict(s) for s in group], pipes[lay],
                                  np.random.default_rng(0)))

    def dev_cfg(lay):
        args = cfgs[lay]["model"]["voxel_encoder"]["args"]
        return {"device_flat_caps": tuple(sorted(
            args["device_flat_caps"].items())),
            "device_ztriple": args.get("device_ztriple", False)}

    def pair(m, bf_m, b):
        """out_rounds of ``m`` on ``b`` and of its cast ``bf_m``."""
        with torch.inference_mode():
            return out_rounds(m(b)), out_rounds(bf_m(cast_batch_bf16(b)))

    # gate: on one batch, the flat maps built on the card equal the host's
    # collate_flat maps key by key, for swin and for the dense-block stem
    # with the z-run plans (ztriple_conv: the host's build_ztriple_plan)
    b4 = scenes[:4]
    rng = np.random.default_rng(0)
    for lay, host_lay in (("dev_flat_swin", "flat_swin"),
                          ("dev_flat_zt", "flat_zt")):
        host_pipe = dataclasses.replace(pipes[host_lay],
                                        flat_shape_caps=locks[lay])
        procs = [process_scene(dict(s), host_pipe, rng) for s in b4]
        host = collate_flat(procs, host_pipe)["maps"]
        db = make_batch([dict(s) for s in b4], pipes[lay],
                        np.random.default_rng(0))
        dt = to_device({k: v for k, v in db.items() if k != "_meta"}, dev)
        swin = lay == "dev_flat_swin"

        def build():
            return device_flat_maps.build_flat_maps(
                dt["vox_coords"], dt["n_voxels"], locks[lay],
                swin_window=4 if swin else 0,
                stem_mode="none" if swin else "dense_block",
                voxel_feats=dt["voxel_feats"], ztriple=not swin)
        built = build()
        for key in sorted(set(host) | set(built)):
            if key not in host or key not in built:
                fail(f"swin_layouts: {lay}: map {key} on one side only")
            got = built[key].cpu().numpy()
            want = host[key]
            if got.dtype != want.dtype or got.shape != want.shape \
                    or not np.array_equal(got, want):
                fail(f"swin_layouts: {lay}: the map {key} built on the "
                     "card differs from the host's")
        ms = cuda_time(build, 5)
        h2d = tree_nbytes({k: v for k, v in db.items() if k != "_meta"})
        print(f"swin_layouts: {lay}: the {len(host)} flat maps built on the "
              f"card equal collate_flat's key by key | build {ms:.3f} ms "
              f"(median of 5, CUDA events) | host-to-device "
              f"{h2d / 2**20:.2f} MiB a batch", flush=True)
        del built, dt

    fmaps = (device_flat_maps, "build_flat_maps")

    def serve(label, m, lay, **kw):
        return serve_instseg("swin_layouts", label, m, pipes[lay], warm,
                             scenes, card, fmaps, **kw)
    runs, fwd, gates = {}, {}, {}
    # the swin model: flat_swin, dev_flat_swin, flat_swin_bf16
    t0 = time.time()
    model = build_model(cfgs["flat_swin"], device="cuda", seed=0)
    print(f"swin_layouts: swin model built in {time.time() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params", flush=True)
    dev_ve = dataclasses.replace(model.voxel_enc, **dev_cfg("dev_flat_swin"))
    runs["flat_swin"] = serve("flat_swin", model, "flat_swin", rounds=True)
    runs["dev_flat_swin"] = serve("dev_flat_swin", model, "dev_flat_swin",
                                  ve=dev_ve, rounds=True)
    bf_model = cast_model_bf16(copy.deepcopy(model))
    runs["flat_swin_bf16"] = serve("flat_swin_bf16", bf_model, "flat_swin",
                                   cast=cast_batch_bf16)

    # gate: dev_flat_swin's served logits against flat_swin's, every round
    # of every scene up to an attend bit that flips (rounds_rel)
    dev_rel, flips = 0.0, []
    for (hr, (_, _, v)), dr in zip(
            zip(runs["flat_swin"]["rounds"], runs["flat_swin"]["logits"]),
            runs["dev_flat_swin"]["rounds"]):
        rel, first = rounds_rel(hr, dr, v)
        dev_rel = max(dev_rel, rel)
        flips += [r for r in first if r < len(hr[2])]
    (ch, mh), (cd, md) = (served_logits(runs["flat_swin"]),
                          served_logits(runs["dev_flat_swin"]))
    final_rel = max(rel_err(*p) for p in zip(final_logits(cd, md),
                                             final_logits(ch, mh)))
    print(f"swin_layouts: dev_flat_swin served logits vs flat_swin over "
          f"{len(scenes)} scenes, every round up to a flipped attend bit: "
          f"rel {dev_rel:.2e} (gate {SWIN_GATES['dev_flat']:.0e}); scenes "
          f"with a flipped bit {len(flips)} (first flipped rounds "
          f"{flips}), final round over all scenes "
          f"{final_rel:.2e}", flush=True)
    if not dev_rel <= SWIN_GATES["dev_flat"]:
        fail("swin_layouts: dev_flat_swin's served logits differ from "
             "flat_swin's")

    # one forward of one batch per setup on the device clock; the bf16
    # gate on that batch, readings on every served batch and on more
    # weight seeds
    flat_b, dev_b = batch_of("flat_swin", b4), batch_of("dev_flat_swin", b4)
    fwd["flat_swin"] = split_forward(model, flat_b)
    model.voxel_enc, host_ve = dev_ve, model.voxel_enc
    try:
        fwd["dev_flat_swin"] = split_forward(model, dev_b)
    finally:
        model.voxel_enc = host_ve
    fwd["flat_swin_bf16"] = split_forward(bf_model, cast_batch_bf16(flat_b))
    gates["flat_swin_bf16"] = check_bf16_gate(
        "flat_swin_bf16 vs flat_swin",
        lambda: pair(model, bf_model, flat_b), flat_b["seg_pad_masks"])
    gates["flat_swin_bf16"]["served"] = bf16_served_readings(
        "flat_swin_bf16 vs flat_swin", runs["flat_swin"],
        runs["flat_swin_bf16"])
    gates["flat_swin_bf16"]["seeds"] = bf16_seed_readings(
        "flat_swin_bf16 vs flat_swin", cfgs["flat_swin"], flat_b,
        SWIN_SEEDS)
    del bf_model, dev_b

    # gates: served scenes' full-width swin forward (a batch of one) on the
    # card against the same forward on the CPU, TF32 off: with the sparse
    # convs in f32 compute on both sides, and as served (bf16 conv
    # operands), whose bound is bf16 rounding's
    cpu_model = copy.deepcopy(model).cpu()
    scales = {}
    hooks = [m.voxel_encoder.register_forward_hook(
        lambda mod, args, out: scales.__setitem__("x", out))
        for m in (model, cpu_model)]
    cpu_rel = {"f32": [], "bf16": []}
    try:
        torch.backends.cudnn.allow_tf32 = False
        for scene in scenes[:4]:
            one = batch_of("flat_swin", [scene])
            one_cpu = {k: (v.cpu() if hasattr(v, "cpu") else
                           {kk: vv.cpu() for kk, vv in v.items()})
                       for k, v in one.items()}
            for conv in ("bf16", "f32"):
                rounding = ((lambda orig: orig) if conv == "bf16" else
                            (lambda orig: lambda t, dtype: t.float()))
                with patched(sparse, "_round", rounding), \
                        torch.inference_mode():
                    got = out_rounds(model(one))
                    card_scales = [t.float().cpu() for t in scales["x"]]
                    t0 = time.time()
                    cpu = out_rounds(cpu_model(one_cpu))
                    cpu_s = time.time() - t0
                    cpu_scales = [t.float() for t in scales["x"]]
                rel, first = rounds_rel(cpu, got, one_cpu["seg_pad_masks"])
                cpu_rel[conv].append({
                    "scales": max(rel_err(a, b) for a, b in
                                  zip(card_scales, cpu_scales)),
                    "logits": rel, "flip_round": first[0],
                    "rounds": len(got[0]),
                    "final": max(rel_err(*p) for p in zip(
                        final_logits(got[0][-1], got[1][-1]),
                        final_logits(cpu[0][-1], cpu[1][-1])))})
    finally:
        for h in hooks:
            h.remove()
        torch.backends.cudnn.allow_tf32 = True
    worst = {conv: {k: max(r[k] for r in rs)
                    for k in ("scales", "logits", "final")}
             for conv, rs in cpu_rel.items()}
    flip_rounds = {conv: [r["flip_round"] for r in rs]
                   for conv, rs in cpu_rel.items()}
    print(f"swin_layouts: {len(cpu_rel['f32'])} served scenes' full-width "
          f"swin forward, card vs CPU, the worst scene (TF32 off: "
          f"torch.backends.cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn off; logits: "
          f"every round up to a flipped attend bit) | sparse convs in f32: "
          f"segment features rel {worst['f32']['scales']:.2e}, logits rel "
          f"{worst['f32']['logits']:.2e} (gate {SWIN_GATES['card_cpu']:.0e}), "
          f"first flipped round by scene {flip_rounds['f32']} of "
          f"{cpu_rel['f32'][0]['rounds']}, final round "
          f"{worst['f32']['final']:.2e} | as served, bf16 conv operands: "
          f"{worst['bf16']['scales']:.2e}, {worst['bf16']['logits']:.2e} "
          f"(gate {SWIN_GATES['card_cpu_served']:.4g}), by scene "
          f"{[round(max(r['scales'], r['logits']), 5) for r in cpu_rel['bf16']]}"
          f", first flipped round by scene {flip_rounds['bf16']}, final round "
          f"{worst['bf16']['final']:.2e} | CPU forward {cpu_s:.1f} s",
          flush=True)
    if not max(worst["f32"]["scales"], worst["f32"]["logits"]) <= \
            SWIN_GATES["card_cpu"] or not max(
                worst["bf16"]["scales"], worst["bf16"]["logits"]) <= \
            SWIN_GATES["card_cpu_served"]:
        fail("swin_layouts: the card's swin forward disagrees with the CPU's")
    del model, cpu_model, one, one_cpu, flat_b
    torch.cuda.empty_cache()

    # phase 5b's Res16UNet: dev_flat_zt, flat_zt_bf16
    model = build_model(cfgs["flat_zt"], device="cuda", seed=0)
    zdev_ve = dataclasses.replace(model.voxel_enc, **dev_cfg("dev_flat_zt"))
    runs["dev_flat_zt"] = serve("dev_flat_zt", model, "dev_flat_zt",
                                ve=zdev_ve)
    bf_model = cast_model_bf16(copy.deepcopy(model))
    runs["flat_zt_bf16"] = serve("flat_zt_bf16", bf_model, "flat_zt",
                                 cast=cast_batch_bf16)
    if not (runs["dev_flat_zt"]["launches"] and
            runs["flat_zt_bf16"]["launches"]):
        fail("swin_layouts: B1 did not launch in dev_flat_zt or "
             "flat_zt_bf16")
    flat_b, dev_b = batch_of("flat_zt", b4), batch_of("dev_flat_zt", b4)
    host_ve = model.voxel_enc
    with torch.inference_mode():
        ref = out_rounds(model(flat_b))
        model.voxel_enc = zdev_ve
        try:
            dev_out = out_rounds(model(dev_b))
        finally:
            model.voxel_enc = host_ve
    zt_rel, zt_flips = rounds_rel(ref, dev_out, flat_b["seg_pad_masks"])
    n_rounds = len(ref[0])
    print(f"swin_layouts: dev_flat_zt forward vs flat_zt (host maps and "
          f"plans) on one batch, every round up to a flipped attend bit: "
          f"rel {zt_rel:.2e} (gate {SWIN_GATES['dev_flat']:.0e}), first "
          f"flipped round by scene {zt_flips} of {n_rounds}", flush=True)
    if not zt_rel <= SWIN_GATES["dev_flat"]:
        fail("swin_layouts: dev_flat_zt's forward differs from flat_zt's")
    gates["flat_zt_bf16"] = check_bf16_gate(
        "flat_zt_bf16 vs flat_zt", lambda: pair(model, bf_model, flat_b),
        flat_b["seg_pad_masks"])
    # dev_flat_zt's served logits stand for flat_zt's (within 1e-5 above)
    gates["flat_zt_bf16"]["served"] = bf16_served_readings(
        "flat_zt_bf16 vs dev_flat_zt", runs["dev_flat_zt"],
        runs["flat_zt_bf16"])
    gates["flat_zt_bf16"]["seeds"] = bf16_seed_readings(
        "flat_zt_bf16 vs flat_zt", cfgs["flat_zt"], flat_b, SWIN_SEEDS)
    model.voxel_enc = zdev_ve
    try:
        fwd["dev_flat_zt"] = split_forward(model, dev_b)
    finally:
        model.voxel_enc = host_ve
    fwd["flat_zt_bf16"] = split_forward(bf_model, cast_batch_bf16(flat_b))
    for lay, r in fwd.items():
        print(f"swin_layouts: {lay}: one forward of the checked batch "
              f"(CUDA events, median of 3): {r['forward']:.1f} ms = "
              f"backbone {r['backbone']:.1f} (window attention "
              f"{r['attention']:.1f}) + rest {r['rest']:.1f} (flat map "
              f"build {r['map_build']:.1f})", flush=True)
    del model, bf_model, ref, dev_out, flat_b, dev_b
    torch.cuda.empty_cache()

    train = swin_train(card)
    total = time.time() - t_phase
    print(f"swin_layouts: phase {total:.1f} s ({card})", flush=True)
    for rec in runs.values():
        for key in ("logits", "rounds", "pre", "np_batches"):
            rec.pop(key)
    return {"runs": runs, "forward_ms": fwd, "bf16": gates,
            "dev_flat_rel": dev_rel, "dev_flat_flips": flips,
            "dev_flat_final_rel": final_rel, "dev_flat_zt_rel": zt_rel,
            "card_cpu": cpu_rel, "locks": locks, "train": train,
            "phase_s": total}


# the voxel encoder's remaining conv options (phase 16): the serving
# setups beside the plain rect one, their gates (PERF.md states each
# bound's prediction), the ladder's rungs and the training runs
CONV_SETUPS = ("rect", "rect_int8", "rect_sorted", "flat_compact",
               "flat_compact_int8")
# timed requests a setup: 2 batches of 4 (32 held the script past 700 s;
# 16 until phase export joined it)
CONV_TIMED = 8
# flat_compact against rect (JAX's tests/test_flat_pack.py:177 bound, here
# over the scale); an int8 setup against its f32 twin; the card's int8
# forward against the CPU's on one scene
CONV_GATES = {"compact": 5e-3, "int8": 5e-2, "int8_cpu": 2e-2}
# the ladder's lower rung: about 3/4 of LAYOUT_CAPS at every level, a
# multiple of 128 so that B1's rows still route
LADDER_LOWER = [int(round(0.75 * c / 128)) * 128 for c in LAYOUT_CAPS]
CONV_TRAIN_STEPS = 3


def small_scenes(n, seed):
    """Scenes of 28-36k points (24 instances, 400 segments), which the
    ladder's lower rung holds."""
    import numpy as np
    from pq3d_tpu_torch.data import synthetic
    rng = np.random.default_rng(seed)
    scenes = [synthetic.make_scene(rng, n_points=28_000 + 2000 * (i % 5),
                                   n_instances=24, n_segments=400)
              for i in range(n)]
    for s in scenes:
        s["inst_labels"] = np.minimum(s["inst_labels"], 199)
    return scenes


class _SceneList:
    """A dataset of fixed scenes for InstSegLoader's batch assembly."""

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def get_scene(self, i):
        return dict(self.scenes[i])


@contextlib.contextmanager
def conv_options(backbone, cfg):
    """The Res16UNet's conv options set from a config's voxel encoder args
    (the JAX YAML defaults where unset) inside the block."""
    args = cfg["model"]["voxel_encoder"]["args"]
    want = {"grad_mode": args.get("grad_mode", "scatter_free"),
            "int8_gather": bool(args.get("int8_gather", False)),
            "sorted_gather": bool(args.get("sorted_gather", False))}
    saved = {k: getattr(backbone, k) for k in want}
    for k, v in want.items():
        setattr(backbone, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(backbone, k, v)


def conv_train_steps(trainer, batches, zrun_conv, label, card,
                     phase="conv_options"):
    """``trainer.train_batch`` on each numpy batch: per step the loss, the
    device ms (CUDA events) and the host seconds, the level-0 pad (the
    rung) and B1's forward and dx launches; peak memory over the steps."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zrun_conv.reset_counts()
    steps = []
    for b in batches:
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        t0 = time.time()
        a.record()
        m = trainer.train_batch(b)
        z.record()
        z.synchronize()
        steps.append({"loss": float(m["loss"]),
                      "device_ms": a.elapsed_time(z),
                      "host_s": time.time() - t0,
                      "pad0": int(b["maps"]["valid_0"].shape[-1])})
    rec = {"steps": steps, "b1": dict(zrun_conv.phase_launches),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    print(f"{phase}: {label}: {len(steps)} steps, losses "
          f"{[round(s['loss'], 4) for s in steps]}, device ms "
          f"{[round(s['device_ms'], 1) for s in steps]}, host s "
          f"{[round(s['host_s'], 2) for s in steps]}, level-0 pad "
          f"{[s['pad0'] for s in steps]} | B1 fwd {rec['b1']['fwd']} dx "
          f"{rec['b1']['bwd']} | max_memory_allocated "
          f"{rec['peak_gib']:.2f} GiB ({card})", flush=True)
    if not all(math.isfinite(s["loss"]) for s in steps):
        fail(f"{phase}: {label}: a loss is not finite")
    return rec


def conv_options_serving(card, dev, zrun_conv):
    """The serving half of phase 16: rect and its four option setups behind
    InstSegServer, one forward per setup on the device clock, the gates,
    the int8 forward on the card against the CPU and the DBSCAN split.
    Returns the runs and readings."""
    import copy
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.eval.instseg_eval import InstSegEval
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.ops import device_maps
    from pq3d_tpu_torch.serve import to_device
    over = [f"data.instseg_options.level_caps={LAYOUT_CAPS}"]
    warm = make_scenes(4, seed=2)
    scenes = make_scenes(CONV_TIMED, seed=3)
    cfgs = {s: serving_config(s, over) for s in CONV_SETUPS}
    pipes = {s: pipeline_config(c["data"]["instseg_options"])
             for s, c in cfgs.items()}
    t0 = time.time()
    model = build_model(cfgs["rect"], device="cuda", seed=0)
    backbone = model.voxel_encoder.backbone
    print(f"conv_options: model built in {time.time() - t0:.1f} s",
          flush=True)
    runs = {}
    for s in CONV_SETUPS:
        with conv_options(backbone, cfgs[s]):
            runs[s] = serve_instseg("conv_options", s, model, pipes[s], warm,
                                    scenes, card,
                                    (device_maps, "build_batch_maps"),
                                    rounds=True)
        compact = pipes[s].compact_conv
        if compact != (runs[s]["launches"] == 0):
            fail(f"conv_options: {s}: B1 launched {runs[s]['launches']} "
                 "times (JAX's rule: none with compact plans, the routed "
                 "convs otherwise)")

    b4 = scenes[:4]

    def batch_of(s, group=b4):
        np_b = make_batch([dict(x) for x in group], pipes[s],
                          np.random.default_rng(0))
        b = to_device({k: v for k, v in np_b.items() if k != "_meta"}, dev)
        n = b["seg_pad_masks"].shape[0]
        for name, dim in SERVE_EXTRA.items():
            b[f"{name}_seg_fts"] = torch.zeros(
                n, pipes[s].max_segments, dim, device=dev)
            b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
        return b, np_b

    feats = {}
    hook = backbone.register_forward_hook(
        lambda mod, args, out: feats.__setitem__("x", [out[0]] + out[1]))
    fwd, outs = {}, {}
    try:
        for s in CONV_SETUPS:
            b, _ = batch_of(s)
            with conv_options(backbone, cfgs[s]), torch.inference_mode():
                outs[s] = out_rounds(model(b))
                if s == "rect":
                    ref_feats = [t.clone() for t in feats["x"]]
                    outs["rect_again"] = out_rounds(model(b))
                    again = [t.clone() for t in feats["x"]]
                elif s == "rect_sorted":
                    sorted_feats = [t.clone() for t in feats["x"]]
                fwd[s] = cuda_time(lambda: model(b), 3)
            print(f"conv_options: {s}: one forward of the checked batch "
                  f"{fwd[s]:.1f} ms (CUDA events, median of 3), peak while "
                  f"served {runs[s]['peak_gib']:.2f} GiB ({card})",
                  flush=True)
    finally:
        hook.remove()
    valid = b["seg_pad_masks"]
    same_again = all(torch.equal(a, c) for a, c in zip(ref_feats, again))
    same_sorted = all(torch.equal(a, c)
                      for a, c in zip(ref_feats, sorted_feats))
    gates = {"rect_again_bits": same_again, "rect_sorted_bits": same_sorted}
    for s, ref in (("rect_again", "rect"), ("rect_sorted", "rect"),
                   ("flat_compact", "rect"), ("rect_int8", "rect"),
                   ("flat_compact_int8", "flat_compact")):
        rel, flips = rounds_rel(outs[ref], outs[s], valid)
        gates[s] = {"rel": rel, "flips": flips}
    print(f"conv_options: on one batch, every round up to a flipped attend "
          f"bit (rel = max|diff| / max|ref|): U-Net features bit-equal, "
          f"rect again {same_again}, rect_sorted {same_sorted}; logits "
          + "; ".join(f"{s} {g['rel']:.3e} (first flips {g['flips']})"
                      for s, g in gates.items() if isinstance(g, dict))
          + f" | gates: sorted bit-equal features and logits "
          f"{LAYOUT_GATE['dev_maps']}, compact "
          f"{CONV_GATES['compact']}, int8 {CONV_GATES['int8']}", flush=True)
    # the U-Net runs no atomic sum, so its features repeat bit for bit;
    # the logits after the segment pooling's atomic sums within 1e-5 up to
    # a flipped bit, as phase 5b's dev_maps against rect
    if not same_again or not same_sorted or not gates["rect_sorted"][
            "rel"] <= LAYOUT_GATE["dev_maps"]:
        fail("conv_options: rect_sorted differs from rect")
    if not gates["flat_compact"]["rel"] <= CONV_GATES["compact"]:
        fail("conv_options: flat_compact differs from rect past the gate")
    if not (gates["rect_int8"]["rel"] <= CONV_GATES["int8"] and
            gates["flat_compact_int8"]["rel"] <= CONV_GATES["int8"]):
        fail("conv_options: an int8 setup differs from its f32 twin past "
             "the gate")

    # the card's int8 forward of one scene against the CPU's (TF32 off)
    one, _ = batch_of("rect_int8", b4[:1])
    one_cpu = {k: (v.cpu() if hasattr(v, "cpu") else
                   {kk: vv.cpu() for kk, vv in v.items()})
               for k, v in one.items()}
    cpu_model = copy.deepcopy(model).cpu()
    saved_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with conv_options(backbone, cfgs["rect_int8"]), \
                conv_options(cpu_model.voxel_encoder.backbone,
                             cfgs["rect_int8"]), torch.inference_mode():
            got = out_rounds(model(one))
            t0 = time.time()
            cpu = out_rounds(cpu_model(one_cpu))
            cpu_s = time.time() - t0
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved_tf32
    rel, flips = rounds_rel(cpu, got, one_cpu["seg_pad_masks"])
    gates["int8_card_cpu"] = {"rel": rel, "flips": flips, "cpu_s": cpu_s}
    print(f"conv_options: rect_int8, one scene, card vs CPU (TF32 off), "
          f"every round up to a flipped attend bit: rel {rel:.3e} (gate "
          f"{CONV_GATES['int8_cpu']}), first flipped round {flips} | CPU "
          f"forward {cpu_s:.1f} s", flush=True)
    if not rel <= CONV_GATES["int8_cpu"]:
        fail("conv_options: the card's int8 forward disagrees with the CPU's")
    del cpu_model, one_cpu, one

    # the DBSCAN split over one served batch at full resolution, on the
    # round-1 logits (random weights leave every final mask logit below 0,
    # so the final round ranks no instance; see phase 5's rank)
    b, np_b = batch_of("rect")
    with torch.inference_mode():
        out = model(b)
    out_np = {k: [t.float().cpu().numpy() for t in out[k][1:2]]
              for k in ("predictions_class", "predictions_mask")}
    bat_np = {k: v for k, v in np_b.items() if not k.startswith("mv_")}
    split = {}
    for use in (False, True):
        ev = InstSegEval(num_classes=200, full_resolution=True,
                         use_dbscan=use)
        t0 = time.time()
        ev.update(out_np, bat_np)
        split[use] = (time.time() - t0, sum(len(p) for p in ev._preds))
        res = ev.record()
    gates["dbscan"] = {"host_s": split[True][0], "plain_s": split[False][0],
                       "preds": split[False][1],
                       "split_preds": split[True][1]}
    print(f"conv_options: InstSegEval(use_dbscan=True) over one served "
          f"batch at full resolution: update {split[True][0]:.2f} s on the "
          f"host ({split[False][0]:.2f} s without the split), "
          f"{split[False][1]} -> {split[True][1]} predictions, all_ap "
          f"{res['all_ap']:.4f}", flush=True)
    if not split[True][1] >= split[False][1] > 0 or not math.isfinite(
            res["all_ap"]):
        fail("conv_options: the DBSCAN split had no prediction to split, "
             "or lost some")
    del model, b, out
    torch.cuda.empty_cache()
    for rec in runs.values():
        for key in ("logits", "rounds", "pre", "np_batches"):
            rec.pop(key)
    return {"runs": runs, "forward_ms": fwd, "gates": gates}


def conv_options_training(card, zrun_conv):
    """The training half of phase 16: the ladder's two rungs on the
    rectangular layout, flat + compact_conv under scatter_free, and
    grad_mode native with remat_policy full (traced) against none."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from pq3d_tpu_torch.data.datasets import _assemble_instseg_batch
    from pq3d_tpu_torch.ops import sparse
    out = {}
    exp = tempfile.mkdtemp(prefix="pq3d_conv_options_")
    try:
        ladder = [LADDER_LOWER, list(LAYOUT_CAPS)]
        small, big = small_scenes(4, seed=5), make_scenes(4, seed=3)
        for group, rung in ((small, LADDER_LOWER), (big, None)):
            counts = [level_counts(s, 0.02) for s in group]
            most = [max(c[l] for c in counts) for l in range(5)]
            fits = all(m <= r for m, r in zip(most, LADDER_LOWER))
            print(f"conv_options: ladder {ladder}: most voxels per level of "
                  f"{'the small' if rung else 'phase 5b’s'} batch {most}, "
                  f"fits the lower rung: {fits}", flush=True)
            if fits != (rung is not None):
                fail("conv_options: the ladder's batches do not split over "
                     "its rungs")
        trainer = smoke_trainer(
            os.path.join(exp, "ladder"),
            f"data.instseg_options.level_cap_ladder={ladder}")
        pipe = dataclasses.replace(trainer.train_data.pipe_cfg,
                                   use_aug=False)
        extra = trainer.train_data.extra_features
        for name, group in (("lower", small), ("upper", big)):
            batches = [_assemble_instseg_batch(
                _SceneList(group), pipe, extra, list(range(4)),
                np.random.default_rng(i), True)
                for i in range(CONV_TRAIN_STEPS)]
            rec = conv_train_steps(trainer, batches, zrun_conv,
                                   f"ladder rung {name}", card)
            want = ladder[0 if name == "lower" else 1][0]
            if {s["pad0"] for s in rec["steps"]} != {want} or not (
                    rec["b1"]["fwd"] and rec["b1"]["bwd"]):
                fail(f"conv_options: ladder rung {name}: a batch took "
                     f"another rung, or B1 did not launch")
            out[f"ladder_{name}"] = rec
        trainer._close_loaders()
        del trainer
        torch.cuda.empty_cache()

        trainer = smoke_trainer(os.path.join(exp, "compact"), *FLAT_ZT[:1],
                                "data.instseg_options.compact_conv=true")
        batches = list(zip(range(CONV_TRAIN_STEPS), trainer.train_data(0)))
        calls = []
        with patched(sparse, "sparse_conv_compact_sym",
                     lambda orig: lambda *a, **k: calls.append(1)
                     or orig(*a, **k)):
            rec = conv_train_steps(trainer, [b for _, b in batches],
                                   zrun_conv, "flat_compact scatter_free",
                                   card)
        rec["compact_sym_calls"] = len(calls)
        if not calls or rec["b1"]["fwd"] or rec["b1"]["bwd"]:
            fail("conv_options: the compact training did not run "
                 "compact_sym, or ran B1")
        out["flat_compact_train"] = rec
        trainer._close_loaders()
        del trainer, batches
        torch.cuda.empty_cache()

        native = ["model.voxel_encoder.args.grad_mode=native"]
        batches = None
        for policy in ("full", "none"):
            prof = (["profile=true", "profile_wait=1", "profile_active=1"]
                    if policy == "full" else [])
            tdir = os.path.join(exp, f"native_{policy}")
            trainer = smoke_trainer(
                tdir, *native,
                f"model.voxel_encoder.args.remat_policy={policy}", *prof)
            if batches is None:
                batches = [b for _, b in zip(range(CONV_TRAIN_STEPS),
                                             trainer.train_data(0))]
            rec = conv_train_steps(trainer, batches, zrun_conv,
                                   f"native, remat_policy {policy}", card)
            out[f"native_{policy}"] = rec
            trainer._close_loaders()
            del trainer
            torch.cuda.empty_cache()
            if policy == "full":
                path = os.path.join(tdir, "trace", "trace_rank0.json")
                if not os.path.exists(path):
                    fail("conv_options: profile: true wrote no trace")
                with open(path) as f:
                    events = json.load(f).get("traceEvents", [])
                kernels = sum(1 for e in events if e.get("cat") == "kernel")
                out["trace"] = {"bytes": os.path.getsize(path),
                                "kernels": kernels}
                print(f"conv_options: the traced step (profile_wait 1, "
                      f"profile_active 1): {path} {out['trace']['bytes']} "
                      f"bytes, {kernels} CUDA kernel events", flush=True)
                if not kernels:
                    fail("conv_options: the trace holds no CUDA kernel")
        full, none = out["native_full"], out["native_none"]
        print(f"conv_options: native training peak memory remat full "
              f"{full['peak_gib']:.2f} GiB against none "
              f"{none['peak_gib']:.2f} GiB; median step "
              f"{np.median([s['device_ms'] for s in full['steps']]):.1f} "
              f"against "
              f"{np.median([s['device_ms'] for s in none['steps']]):.1f} ms "
              f"({card})", flush=True)
        if not full["peak_gib"] < none["peak_gib"]:
            fail("conv_options: remat_policy full did not lower the peak")
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    return out


def conv_options_phase(card, dev, zrun_conv):
    """Phase 16 (see the module docstring): returns the phase's numbers."""
    t0 = time.time()
    serving = conv_options_serving(card, dev, zrun_conv)
    training = conv_options_training(card, zrun_conv)
    total = time.time() - t0
    print(f"conv_options: phase {total:.1f} s ({card})", flush=True)
    return {**serving, "train": training, "phase_s": total}


GATHER_SETUPS = ("rect_gather", "dev_gather")
GATHER_TIMED = 8     # timed requests a setup: 2 batches of 4
# dev_gather's served logits against rect_gather's (the same maps, built
# on the card); rect_gather against the dense-block rect on the same
# weights and batch, every conv plain in f32 (the stems sum the same
# products in another order: 4.2e-6 to 4.6e-6 on an H100, so about 4x the
# largest reading); one train step with either stem (the same)
GATHER_GATES = {"dev_gather": LAYOUT_GATE["dev_maps"], "dense_f32": 2e-5,
                "train_step": FLAT_RECT_GATE}
GATHER_TRAIN_STEPS = 3


def gather_stem_phase(card, dev, zrun_conv):
    """Phase ``gather_stem`` (see the module docstring): the 125-tap
    gather stem served (rect_gather, dev_gather) and trained at the
    slice's widths.  Returns the phase's numbers."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.models.sparse_unet import flatten_maps
    from pq3d_tpu_torch.ops import device_maps, sparse
    from pq3d_tpu_torch.serve import to_device
    t_phase = time.time()
    over = [f"data.instseg_options.level_caps={LAYOUT_CAPS}"]
    cfgs = {s: serving_config(s, over) for s in ("rect",) + GATHER_SETUPS}
    pipes = {s: pipeline_config(c["data"]["instseg_options"])
             for s, c in cfgs.items()}
    t0 = time.time()
    model = build_model(cfgs["rect_gather"], device="cuda", seed=0)
    backbone = model.voxel_encoder.backbone
    host_ve = model.voxel_enc
    dev_args = cfgs["dev_gather"]["model"]["voxel_encoder"]["args"]
    dev_ve = dataclasses.replace(
        host_ve, device_maps=tuple(dev_args["device_maps"]),
        device_ztriple=dev_args["device_ztriple"],
        device_stem=dev_args["device_stem"])
    print(f"gather_stem: model built in {time.time() - t0:.1f} s, conv0 "
          f"kernel {tuple(backbone.conv0.kernel.shape)}", flush=True)
    warm = make_scenes(4, seed=2)
    scenes = make_scenes(GATHER_TIMED, seed=3)
    maps = (device_maps, "build_batch_maps")
    runs = {s: serve_instseg("gather_stem", s, model, pipes[s], warm,
                             scenes, card, maps,
                             ve=dev_ve if s == "dev_gather" else host_ve,
                             rounds=True)
            for s in GATHER_SETUPS}
    for s, r in runs.items():
        if not r["launches"]:
            fail(f"gather_stem: {s}: B1 did not launch")

    # gate: dev_gather's served logits against rect_gather's, batch by
    # batch, every round up to a flipped attend bit
    dg_rel, flips = 0.0, []
    for (hr, (_, _, v)), dr in zip(
            zip(runs["rect_gather"]["rounds"],
                runs["rect_gather"]["logits"]),
            runs["dev_gather"]["rounds"]):
        rel, first = rounds_rel(hr, dr, v)
        dg_rel = max(dg_rel, rel)
        flips += [r for r in first if r < len(hr[2])]
    print(f"gather_stem: dev_gather served logits vs rect_gather, every "
          f"round up to a flipped attend bit: rel {dg_rel:.2e} (gate "
          f"{GATHER_GATES['dev_gather']:.0e}); scenes with a flipped bit "
          f"{len(flips)}", flush=True)
    if not dg_rel <= GATHER_GATES["dev_gather"]:
        fail("gather_stem: dev_gather's served logits differ from "
             "rect_gather's")

    # gate: on one batch, the maps built on the card (nbr5_0 and the
    # z-run plans included) equal the host's bit for bit
    b4 = scenes[:4]
    np_b = {s: make_batch([dict(x) for x in b4], pipes[s],
                          np.random.default_rng(0)) for s in pipes}
    dt = to_device({k: v for k, v in np_b["dev_gather"].items()
                    if k != "_meta"}, dev)

    def build_maps():
        return device_maps.build_batch_maps(
            dt["vox_coords"], dt["n_voxels"], dt["voxel_feats"],
            LAYOUT_CAPS, conv0_kernel=dev_ve.conv1_kernel_size,
            stem_mode="gather", ztriple=dev_ve.device_ztriple)
    built = build_maps()
    host_maps = np_b["rect_gather"]["maps"]
    if "nbr5_0" not in host_maps or "stem_dense" in host_maps:
        fail("gather_stem: the host batch ships no nbr5_0, or a stem pack")
    for key, want in host_maps.items():
        got = built[key].cpu().numpy()
        if got.dtype != want.dtype or got.shape != want.shape \
                or not np.array_equal(got, want):
            fail(f"gather_stem: the map {key} built on the card differs "
                 "from the host's")
    build_ms = cuda_time(build_maps, 5)
    print(f"gather_stem: nbr5_0 {host_maps['nbr5_0'].shape} and the other "
          f"{len(host_maps) - 1} maps built on the card equal the host's "
          f"bit for bit | build {build_ms:.3f} ms (median of 5, CUDA "
          f"events)", flush=True)
    del built

    def on_card(s):
        b = to_device({k: v for k, v in np_b[s].items() if k != "_meta"},
                      dev)
        for name, dim in SERVE_EXTRA.items():
            b[f"{name}_seg_fts"] = torch.zeros(4, pipes[s].max_segments,
                                               dim, device=dev)
            b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
        return b
    cards = {s: on_card(s) for s in pipes}

    def forward(s):
        model.voxel_enc = dev_ve if s == "dev_gather" else host_ve
        try:
            with torch.inference_mode():
                return model(cards[s])
        finally:
            model.voxel_enc = host_ve
    fwd_all = {s: cuda_times(lambda: forward(s), 5) for s in GATHER_SETUPS}
    fwd_ms = {s: t[2] for s, t in fwd_all.items()}
    # conv0 alone: the gathered conv over nbr5_0 against the dense-block
    # stem on the same scenes and weights
    fm = {s: flatten_maps(cards[s]["maps"]) for s in ("rect", "rect_gather")}
    x0 = cards["rect_gather"]["voxel_feats"].reshape(
        -1, cards["rect_gather"]["voxel_feats"].shape[-1])
    with torch.inference_mode():
        conv0_all = {
            "gather": cuda_times(lambda: backbone.conv0(
                x0, fm["rect_gather"]["nbr5_0"],
                fm["rect_gather"]["valid_0"]), 9),
            "dense_block": cuda_times(lambda: sparse.conv0_dense_block(
                fm["rect"]["stem_dense"], fm["rect"]["stem_nbrblk"],
                fm["rect"]["stem_slot"], backbone.conv0.kernel,
                fm["rect"]["valid_0"], block=fm["rect"]["stem_block"],
                kernel=backbone.conv1_kernel_size), 9)}
    conv0_ms = {k: t[4] for k, t in conv0_all.items()}

    def spread(t):
        return f"{t[len(t) // 2]:.3f} ms (min {t[0]:.3f}, max {t[-1]:.3f})"
    print(f"gather_stem: one forward of the checked batch (CUDA events, "
          f"median of 5): " + ", ".join(f"{k} {spread(t)}" for k, t in
                                       fwd_all.items())
          + f" | conv0 alone (median of 9): gathered over nbr5_0 "
          f"{spread(conv0_all['gather'])}, dense-block stem "
          f"{spread(conv0_all['dense_block'])} on the same scenes "
          f"({card})", flush=True)
    # what those event spans hold: one traced call each, the device's busy
    # time (its kernels) against the host's clock around the call; the
    # rest is the device waiting on the host's launches and syncs

    def conv0_gather():
        with torch.inference_mode():
            backbone.conv0(x0, fm["rect_gather"]["nbr5_0"],
                           fm["rect_gather"]["valid_0"])
    busy = {s: profile_run(lambda: forward(s), f"gather_stem {s} forward",
                           top=3) for s in GATHER_SETUPS}
    busy["conv0"] = profile_run(conv0_gather, "gather_stem conv0 gathered",
                                top=3)

    # gate: rect_gather against the dense-block rect, same weights and
    # scenes, every conv plain in f32 (self-mask off: no attend bit);
    # the as-served reading (bf16 operands, self-mask on) is printed
    with all_plain(model), torch.inference_mode():
        f32 = {s: out_rounds(model(cards[s])) for s in ("rect",
                                                          "rect_gather")}
    with torch.inference_mode():
        served = {s: out_rounds(model(cards[s])) for s in ("rect",
                                                             "rect_gather")}
    valid = cards["rect"]["seg_pad_masks"]
    dense_rel, _ = rounds_rel(f32["rect"], f32["rect_gather"], valid)
    served_rel, served_flips = rounds_rel(served["rect"],
                                          served["rect_gather"], valid)
    print(f"gather_stem: rect_gather vs the dense-block rect, same weights "
          f"and scenes, every round: all-plain f32 rel {dense_rel:.3e} "
          f"(gate {GATHER_GATES['dense_f32']:.0e}); as served, up to a "
          f"flipped attend bit, rel {served_rel:.3e} (not gated; first "
          f"flipped round by scene {served_flips})", flush=True)
    if not dense_rel <= GATHER_GATES["dense_f32"]:
        fail("gather_stem: the gather stem's forward differs from the "
             "dense-block stem's")
    del model, backbone, cards, fm, x0, f32, served
    torch.cuda.empty_cache()

    # training with the gather stem, and one step against the dense block
    exp = tempfile.mkdtemp(prefix="pq3d_gather_stem_")
    try:
        trainer = smoke_trainer(os.path.join(exp, "gather"),
                                "data.instseg_options.stem_mode=gather")
        if trainer.train_data.pipe_cfg.stem_mode != "gather":
            fail("gather_stem: the trainer's pipeline is not the gather "
                 "stem's")
        batches = [b for _, b in zip(range(GATHER_TRAIN_STEPS),
                                     trainer.train_data(0))]
        if not all("nbr5_0" in b["maps"] for b in batches):
            fail("gather_stem: a training batch ships no nbr5_0")
        train = conv_train_steps(trainer, batches, zrun_conv,
                                 "training, stem_mode gather", card,
                                 phase="gather_stem")
        if not (train["b1"]["fwd"] and train["b1"]["bwd"]):
            fail("gather_stem: B1 did not run forward and dx in training")
        pipe = trainer.train_data.pipe_cfg
        loss_rel, grad_rel, per_tensor, loss_d, loss_g = two_pipe_step(
            trainer, dataclasses.replace(pipe, stem_mode="dense_block"),
            pipe)
        print(f"gather_stem: one step all-plain f32 (TF32 off), direct "
              f"criterion, dense-block stem vs gather stem on one batch: "
              f"loss {loss_d:.6f} vs {loss_g:.6f} (rel {loss_rel:.2e}); "
              f"gradients' largest difference over their maximum "
              f"{grad_rel:.2e} (gate for both "
              f"{GATHER_GATES['train_step']:.0e}); not gated: worst "
              f"tensor over its own maximum {per_tensor:.2e}", flush=True)
        if not max(loss_rel, grad_rel) <= GATHER_GATES["train_step"]:
            fail("gather_stem: the gather stem's train step differs from "
                 "the dense-block stem's")
        trainer._close_loaders()
        del trainer, batches
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    torch.cuda.empty_cache()
    total = time.time() - t_phase
    print(f"gather_stem: phase {total:.1f} s ({card})", flush=True)
    for rec in runs.values():
        for key in ("logits", "rounds", "pre", "np_batches"):
            rec.pop(key)
    return {"runs": runs, "forward_ms": fwd_ms, "conv0_ms": conv0_ms,
            "traced_host_busy_ms": busy, "map_build_ms": build_ms,
            "gates": {"dev_gather": dg_rel, "dense_f32": dense_rel,
                      "served_vs_dense": served_rel,
                      "train_loss": loss_rel, "train_grad": grad_rel},
            "train": train, "phase_s": total}


def reference_warm_start_phase(card, zrun_conv):
    """Phase ``reference_warm_start`` (see the module docstring): a
    reference-named state_dict of a full-width stage-1 model in
    ``pytorch_model.bin``, then ``python -m pq3d_tpu_torch.run
    --config-name instseg_sceneverse pretrain_ckpt_path=<dir>`` for 2
    steps on the card.  Returns the phase's numbers."""
    import shutil
    import tempfile
    import torch
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.train.trainer import Query3DTrainer
    from pq3d_tpu_torch.utils.weights import flax_leaves
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from torch_reference_names import reference_state_dict
    t_phase = time.time()
    overrides = ["model.voxel_encoder.args.pallas_conv=true",
                 "data.train=[SyntheticInstSeg]",
                 "data.val=[SyntheticInstSeg]", "data.synthetic.num_train=8",
                 "data.synthetic.num_val=4",
                 "data.synthetic.n_points=70000",
                 "data.synthetic.n_instances=24",
                 "data.synthetic.n_segments=400", "solver.epochs=1",
                 "solver.epochs_per_eval=0", "log_every=1", "device=cuda"]
    cfg = load_config("instseg_sceneverse", overrides)
    memories = tuple(cfg["model"]["memories"])
    source = build_model(cfg, device="cpu", seed=7)
    sd = reference_state_dict(source, memories, module_every=2)
    src_state = source.state_dict()
    n_leaves = sum(1 for c, _, _ in flax_leaves(source)
                   if c in ("params", "batch_stats"))
    groups = {"ME U-Net convs": ".kernel", "BN": ".running_var",
              "feat_proj_list": "feat_proj_list", "in_proj": "in_proj_",
              "mask head": "mask_head."}
    counts = {g: sum(1 for k in sd if pat in k) for g, pat in
              groups.items()}
    exp = tempfile.mkdtemp(prefix="pq3d_reference_")
    checked = {}
    try:
        ref_dir = os.path.join(exp, "reference")
        os.makedirs(ref_dir)
        path = os.path.join(ref_dir, "pytorch_model.bin")
        t0 = time.time()
        torch.save(sd, path)
        print(f"reference_warm_start: {len(sd)} reference-named tensors "
              f"({sum(k.startswith('module.') for k in sd)} under "
              f"module.; " + ", ".join(f"{g} {n}" for g, n in
                                      counts.items())
              + f") of a full-width stage-1 model (seed 7), "
              f"{os.path.getsize(path) / 2**20:.1f} MiB written in "
              f"{time.time() - t0:.1f} s", flush=True)
        if any(n == 0 for n in counts.values()):
            fail("reference_warm_start: a group of reference names is "
                 "missing from the state_dict")
        del sd

        def checking(orig):
            def warm_start(self, p):
                loaded = orig(self, p)
                state = self.model.state_dict()
                checked["report"] = self.warm_start_report
                checked["differ"] = [k for k, v in src_state.items()
                                     if not k.endswith("gauss_B")
                                     and not torch.equal(state[k].cpu(), v)]
                checked["device"] = str(next(self.model.parameters()).device)
                return loaded
            return warm_start
        argv = ["--config-name", "instseg_sceneverse", *overrides,
                f"exp_dir={os.path.join(exp, 'run')}",
                f"pretrain_ckpt_path={ref_dir}"]
        with patched(Query3DTrainer, "_warm_start", checking):
            trainer, rec = recipe_stage("reference_warm_start", argv,
                                        zrun_conv, True, card)
        with open(os.path.join(exp, "run", "metrics.jsonl")) as f:
            train = [json.loads(line) for line in f if '"train"' in line]
        del trainer
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    torch.cuda.empty_cache()
    report = checked.get("report") or {}
    losses = [r["loss"] for r in train]
    print(f"reference_warm_start: report {len(report.get('loaded', []))} "
          f"loaded (of {n_leaves} leaves), {len(report.get('missing', []))} "
          f"missing, {len(report.get('mismatched', []))} mismatched, "
          f"{len(report.get('unused', []))} unused | tensors on "
          f"{checked.get('device')} differing from their source: "
          f"{len(checked.get('differ', []))} | {len(losses)} steps, losses "
          f"{[round(x, 4) for x in losses]} | B1 fwd {rec['counts']['fwd']} "
          f"dx {rec['counts']['bwd']} ({card})", flush=True)
    if not report or report["mismatched"] or report["unused"] \
            or len(report["loaded"]) != n_leaves:
        fail("reference_warm_start: the import left a leaf unloaded, or a "
             "tensor mismatched or unused")
    if checked["differ"] or not checked["device"].startswith("cuda"):
        fail(f"reference_warm_start: {checked['differ'][:5]} on the card "
             "differ from their source after the warm start")
    if len(losses) != 2 or not math.isfinite(losses[0]):
        fail("reference_warm_start: the run did not take 2 steps with a "
             "finite first loss")
    if not (rec["counts"]["fwd"] and rec["counts"]["bwd"]):
        fail("reference_warm_start: B1 did not run forward and dx")
    total = time.time() - t_phase
    print(f"reference_warm_start: phase {total:.1f} s ({card})", flush=True)
    return {"loaded": len(report["loaded"]), "losses": losses,
            "launches": rec["counts"], "hungarian": rec["hungarian"],
            "steps_per_s": rec["steps_per_s"],
            "peak_gib": rec["peak"] / 2**30, "phase_s": total}


EXPORT_FORWARDS = 3       # timed forwards of each program (median)
EXPORT_GATES = {"stage1": 1e-5, "ground": 1e-5, "voxel_level": 2e-2}
EXPORT_KEYS = ("predictions_class", "predictions_mask")


def export_stage1_setup(device):
    """Phase export's stage-1 model (the slice's, phase 5b's caps, random
    weights from seed 0; the same weights on every device) and its batch
    of phase 5b's first 4 timed scenes with the served extra features, on
    ``device``; returns (model, batch, numpy batch)."""
    import numpy as np
    import torch
    from pq3d_tpu_torch.config import serving_config
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import to_device
    cfg = serving_config("rect",
                         [f"data.instseg_options.level_caps={LAYOUT_CAPS}"])
    pipe = pipeline_config(cfg["data"]["instseg_options"])
    model = build_model(cfg, device=device.type, seed=0)
    np_b = make_batch([dict(s) for s in make_scenes(4, seed=3)], pipe,
                      np.random.default_rng(0))
    np_b.pop("_meta")
    b = to_device(np_b, device)
    for name, dim in SERVE_EXTRA.items():
        b[f"{name}_seg_fts"] = torch.zeros(4, pipe.max_segments, dim,
                                           device=device)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    return model, b, np_b


def export_stage1_cpu(path):
    """Phase export's CPU host (``python3 chip_smoke.py --export-stage1
    PATH``, started by the phase with no card visible): exports the
    stage-1 forward on the CPU and writes the artifact to ``path``; prints
    one JSON line of its readings.  It runs beside phase ddp's ranks, so it
    takes two of the host's threads."""
    import torch
    from pq3d_tpu_torch import export
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    model, b, _ = export_stage1_setup(cpu)
    t0 = time.time()
    program = export.export_program(model, b, outputs=EXPORT_KEYS)
    export_s = time.time() - t0
    t0 = time.time()
    blob = export.save_program(program)
    with open(path, "wb") as f:
        f.write(blob)
    print(json.dumps({
        "export_s": export_s, "save_s": time.time() - t0,
        "nodes": len(program.graph.nodes),
        "zrun_conv_nodes": export.kernel_nodes(program),
        "platforms": export.exported_platforms(program),
        "artifact_mib": len(blob) / 2**20}), flush=True)


def export_prepare(card, dev):
    """Phase export's exports, which are host work: starts the CPU export of
    stage 1 in a second process that sees no card (``chip_smoke.py
    --export-stage1 PATH``), exports stage 2 on the card meanwhile (the
    trace runs on fake tensors; the program runs as exported, in memory),
    waits for the CPU export and loads its artifact onto the card.  Phase
    ddp runs it beside its launches.  Returns what ``export_phase``
    reads."""
    import dataclasses
    import subprocess
    import tempfile
    import numpy as np
    from pq3d_tpu_torch import export
    from pq3d_tpu_torch.config import load_config
    from pq3d_tpu_torch.data.unified_pipeline import (UnifiedPipelineConfig,
                                                      collate_unified,
                                                      process_item)
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.serve import to_device
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="pq3d_export_") as tmp:
        path = os.path.join(tmp, "stage1.pt2")
        cpu_host = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--export-stage1", path],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            # (ii) stage 2 at its published widths, exported on the card
            cfg = load_config("unified_tasks_sceneverse")
            upipe = UnifiedPipelineConfig(**cfg["data"]["unified_options"])
            feature_dims = {"mv": 768, "voxel": 128}
            umodel = build_model(cfg, device="cuda", seed=0)
            rng = np.random.default_rng(5)
            items = [process_item(sc, l, upipe, rng, False, feature_dims)
                     for sc, l in unified_requests(8, seed=2)]
            np2 = collate_unified([{k: v for k, v in it.items()
                                    if not k.startswith("meta_")}
                                   for it in items], upipe, feature_dims,
                                  train=False)
            for key in ("obj_fts", "response"):
                np2.pop(key, None)
            b2d = to_device(np2, dev)
            ukeys = ("ground_logits", "generation_tokens")
            t1 = time.time()
            program = export.export_program(umodel, b2d, outputs=ukeys)
            s2 = {"export_s": time.time() - t1,
                  "nodes": len(program.graph.nodes),
                  "zrun_conv_nodes": export.kernel_nodes(program)}
            # the program runs as exported, in memory: stage 1's artifact
            # carries the save and load round trip
            fn2 = export.load_forward(program)
            del program
            # the same model with early_exit: its decode is one
            # torch.while_loop, which the program keeps as a loop
            fixed_cfg = umodel.generation_head.cfg
            umodel.generation_head.cfg = dataclasses.replace(
                fixed_cfg, early_exit=True)
            try:
                t1 = time.time()
                program = export.export_program(umodel, b2d, outputs=ukeys)
                s2ee = {"export_s": time.time() - t1,
                        "nodes": len(program.graph.nodes),
                        "while_loop_nodes": export.while_loop_nodes(
                            program)}
            finally:
                umodel.generation_head.cfg = fixed_cfg
            fn2ee = export.load_forward(program)
            del program
            stdout, stderr = cpu_host.communicate(timeout=900)
        finally:
            if cpu_host.poll() is None:
                cpu_host.kill()
                cpu_host.wait()
        if cpu_host.returncode != 0:
            fail(f"export: the CPU export of stage 1 failed "
                 f"(rc {cpu_host.returncode}):\n{stderr[-3000:]}")
        s1 = json.loads(stdout.strip().splitlines()[-1])
        with open(path, "rb") as f:
            blob = f.read()
    cpu_s = time.time() - t0
    t1 = time.time()
    fn = export.load_forward(blob, device="cuda")
    s1["load_s"] = time.time() - t1
    wall = time.time() - t0
    print(f"export: prepared in {wall:.1f} s: stage 2 exported in "
          f"{s2['export_s']:.1f} s, the CPU export of stage 1 (exported in "
          f"{s1['export_s']:.1f} s, saved in {s1['save_s']:.1f} s) ended "
          f"{cpu_s:.1f} s after the start, its load and move "
          f"{s1['load_s']:.1f} s ({card})", flush=True)
    print(f"export: stage 2 with early_exit exported in "
          f"{s2ee['export_s']:.1f} s, {s2ee['nodes']} graph nodes, "
          f"{s2ee['while_loop_nodes']} while_loop ({card})", flush=True)
    return {"fn": fn, "s1": s1, "fn2": fn2, "s2": s2, "fn2ee": fn2ee,
            "s2ee": s2ee, "umodel": umodel, "b2d": b2d, "prepare_s": wall}


def export_phase(card, dev, zrun_conv, prep=None):
    """Phase ``export`` (see the module docstring): the card part, on
    ``export_prepare``'s programs (``prep``; made here when None): the
    stage-1 artifact exported on the CPU run on the card, the stage-2
    program exported on the card run in memory, and VoxelLevelEncoder at
    full width.  Returns the phase's numbers."""
    import dataclasses
    import torch
    from pq3d_tpu_torch.models.encoders import VoxelLevelEncoder
    from pq3d_tpu_torch.models.query3d import init_weights
    from pq3d_tpu_torch.ops import windowed_conv
    t_phase = time.time()
    if prep is None:
        prep = export_prepare(card, dev)
    fn, s1, fn2, s2 = prep["fn"], prep["s1"], prep["fn2"], prep["s2"]
    fn2ee, s2ee = prep["fn2ee"], prep["s2ee"]
    umodel, b2d = prep["umodel"], prep["b2d"]
    out = {"prepare_s": prep["prepare_s"]}
    prep.clear()

    def report(label, r, load_what):
        saved = (f"artifact {r['artifact_mib']:.1f} MiB, {load_what} "
                 f"{r['load_s']:.1f} s" if load_what else
                 "run in memory, not saved")
        print(f"export: {label}: exported in {r['export_s']:.1f} s, "
              f"{r['nodes']} graph nodes ({r['zrun_conv_nodes']} "
              f"pq3d.zrun_conv), {saved} | one forward "
              f"{r['exported_ms']:.1f} ms exported against "
              f"{r['eager_ms']:.1f} ms eager (CUDA events, median of "
              f"{EXPORT_FORWARDS}) ({card})", flush=True)

    # (i) stage 1: the artifact exported on the CPU, loaded onto the card
    model, bd, np_b = export_stage1_setup(dev)
    routed = model.voxel_encoder.backbone.routed_convs(level_rows(np_b))
    if s1["zrun_conv_nodes"] != len(routed):
        fail(f"export: the stage-1 graph holds {s1['zrun_conv_nodes']} "
             f"pq3d.zrun_conv nodes; the forward routes {len(routed)} "
             f"convs")
    if tuple(s1["platforms"]) != ("cpu",):
        fail("export: the stage-1 artifact's weights are not on the CPU")
    zrun_conv.reset_counts()                  # main path starts here
    windowed_conv.reset_counts()
    got = fn(bd)
    exp_ms = cuda_times(lambda: fn(bd), EXPORT_FORWARDS)
    torch.cuda.synchronize()
    launches, b2 = zrun_conv.launches, windowed_conv.launches
    forwards = 1 + EXPORT_FORWARDS            # main path ends here
    print(f"export: stage1: B1 launched {launches} times over {forwards} "
          f"forwards of the loaded program ({len(routed)} routed convs a "
          f"forward), B2 {b2} times", flush=True)
    if launches != len(routed) * forwards or b2:
        fail("export: the loaded stage-1 program did not launch B1 once "
             "per routed conv and forward, or launched B2")
    with torch.inference_mode():
        ref = model(bd)
    rel, first = rounds_rel(out_rounds(ref), out_rounds(got),
                            bd["seg_pad_masks"])
    n_rounds = len(ref["predictions_class"])
    print(f"export: stage1 exported logits against the eager card forward, "
          f"every round up to a flipped attend bit: rel {rel:.2e} (gate "
          f"{EXPORT_GATES['stage1']:.0e}); scenes with a flipped bit "
          f"{sum(f < n_rounds for f in first)}", flush=True)
    if not rel <= EXPORT_GATES["stage1"]:
        fail("export: the exported stage-1 forward disagrees with eager")

    def eager1():
        with torch.inference_mode():
            model(bd)
    s1.update(exported_ms=exp_ms[len(exp_ms) // 2],
              eager_ms=cuda_time(eager1, EXPORT_FORWARDS),
              launches=launches, forwards=forwards, rel=rel, b2_launches=b2)
    report("stage1", s1, "load and move")
    out["stage1"] = s1
    del fn, got, ref
    torch.cuda.empty_cache()

    # (iii) VoxelLevelEncoder at full width on the same batch
    vle = VoxelLevelEncoder(pallas_conv=True).eval()
    init_weights(vle, torch.Generator().manual_seed(4))
    vle.to(dev)
    vrouted = vle.backbone.routed_convs(level_rows(np_b))
    outs = {}
    for use_kernel in (True, False):
        vle.backbone.pallas_conv = use_kernel
        zrun_conv.reset_counts()
        with torch.inference_mode():
            mask, scales = vle(bd["voxel_feats"], bd["maps"])
        torch.cuda.synchronize()
        outs[use_kernel] = ([mask] + scales, zrun_conv.launches)
    vrel = max(rel_err(a, r) for a, r in zip(outs[True][0], outs[False][0]))
    finite = all(torch.isfinite(t).all().item() for t in outs[True][0])
    print(f"export: VoxelLevelEncoder (hidden 768, hlevels 0-3) with B1 "
          f"against all-plain: rel {vrel:.2e} (gate "
          f"{EXPORT_GATES['voxel_level']:.0e}) | mask features "
          f"{tuple(outs[True][0][0].shape)} | B1 launched "
          f"{outs[True][1]} times ({len(vrouted)} routed convs), "
          f"{outs[False][1]} all-plain", flush=True)
    if not (finite and vrel <= EXPORT_GATES["voxel_level"]) \
            or outs[True][1] != len(vrouted) or not vrouted \
            or outs[False][1]:
        fail("export: VoxelLevelEncoder with B1 disagrees with all-plain, "
             "or B1 did not launch once per routed conv")
    out["voxel_level"] = {"rel": vrel, "launches": outs[True][1],
                          "routed": len(vrouted)}
    del vle, outs, model, bd
    torch.cuda.empty_cache()

    # (ii)'s gates and timings
    got = fn2(b2d)
    with torch.inference_mode():
        ref = umodel(b2d)
    valid = b2d["query_pad_masks"]
    grel = rel_err(got["ground_logits"][valid], ref["ground_logits"][valid])
    same = torch.equal(got["generation_tokens"], ref["generation_tokens"])
    print(f"export: stage2 (unified_tasks_sceneverse, batch 8, "
          f"{got['generation_tokens'].shape[1]} greedy tokens): tokens "
          f"{'equal' if same else 'DIFFER'} to eager, ground_logits rel "
          f"{grel:.2e} (gate {EXPORT_GATES['ground']:.0e})", flush=True)
    if not same or not grel <= EXPORT_GATES["ground"]:
        fail("export: the exported stage-2 forward disagrees with eager")

    def eager2():
        with torch.inference_mode():
            umodel(b2d)
    s2.update(exported_ms=cuda_time(lambda: fn2(b2d), EXPORT_FORWARDS),
              eager_ms=cuda_time(eager2, EXPORT_FORWARDS), ground_rel=grel)
    report("stage2", s2, None)
    out["stage2"] = s2

    # (ii) with early_exit: the exported while_loop decode against the
    # eager early-exit decode and the fixed-length program's tokens
    fixed_cfg = umodel.generation_head.cfg
    umodel.generation_head.cfg = dataclasses.replace(fixed_cfg,
                                                     early_exit=True)
    try:
        t0 = time.time()
        with torch.inference_mode():
            eager_ee = umodel(b2d)["generation_tokens"]
        torch.cuda.synchronize()
        eager_first_s = time.time() - t0
    finally:
        umodel.generation_head.cfg = fixed_cfg
    got_ee = fn2ee(b2d)["generation_tokens"]
    fixed_toks = got["generation_tokens"]
    same_eager = torch.equal(got_ee, eager_ee)
    same_fixed = torch.equal(got_ee, fixed_toks)
    eos_rows = int((got_ee == 1).any(1).sum())
    ee_ms = cuda_times(lambda: fn2ee(b2d), 3)
    fx_ms = cuda_times(lambda: fn2(b2d), 3)
    s2ee.update(exported_ms=ee_ms[1], fixed_exported_ms=fx_ms[1],
                eager_first_s=eager_first_s, eos_rows=eos_rows)
    print(f"export: stage2 early_exit: exported in {s2ee['export_s']:.1f} "
          f"s, {s2ee['nodes']} graph nodes, {s2ee['while_loop_nodes']} "
          f"while_loop | tokens {'equal' if same_eager else 'DIFFER'} to "
          f"the eager early-exit decode (its first call {eager_first_s:.1f} "
          f"s, the loop's capture included), "
          f"{'equal' if same_fixed else 'DIFFER'} to the fixed-length "
          f"program's | rows that emit EOS {eos_rows} of "
          f"{got_ee.shape[0]} | one forward (its {got_ee.shape[1]}-token "
          f"decode inside) {ee_ms[1]:.1f} ms exported early-exit against "
          f"{fx_ms[1]:.1f} ms exported fixed-length (CUDA events, median of "
          f"3) ({card})", flush=True)
    if s2ee["while_loop_nodes"] != 1 or not (same_eager and same_fixed):
        fail("export: the exported early-exit decode disagrees with eager "
             "or with the fixed-length program, or holds no while_loop")
    out["stage2_early_exit"] = s2ee
    del fn2, fn2ee, umodel
    torch.cuda.empty_cache()
    out["phase_s"] = time.time() - t_phase
    print(f"export: phase {out['phase_s']:.1f} s", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="trace one served forward; write the table here")
    ap.add_argument("--export-stage1", metavar="PATH",
                    help="phase export's CPU host: export the stage-1 "
                         "forward on the CPU to PATH and exit")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "pq3d_tpu_torch")):
        fail("pq3d_tpu_torch/ is not beside chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    if args.export_stage1:
        import warnings
        warnings.filterwarnings("ignore", message="level .* > configured cap")
        export_stage1_cpu(args.export_stage1)
        return
    import warnings
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from pq3d_tpu_torch.config import slice_config
    from pq3d_tpu_torch.data.instseg_pipeline import (make_batch,
                                                      pipeline_config)
    from pq3d_tpu_torch.eval.instseg_eval import rank_instances
    from pq3d_tpu_torch.models.query3d import build_model
    from pq3d_tpu_torch.models.sparse_unet import flatten_maps
    from pq3d_tpu_torch.ops import hungarian, windowed_conv, zrun_conv
    from pq3d_tpu_torch.serve import InstSegServer, to_device

    # the synthetic scenes outgrow the YAML's deep level caps; the pipeline
    # pads those levels to buckets (the printed level rows show it)
    warnings.filterwarnings("ignore", message="level .* > configured cap")

    laps = {"t": time.time(), "phase": "1"}

    def lap(nxt):
        """Print the seconds the phase before ``nxt`` took."""
        now = time.time()
        print(f"timing: phase {laps['phase']} {now - laps['t']:.1f} s",
              flush=True)
        laps.update(t=now, phase=nxt)

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "unknown"
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind}", flush=True)
    flops_peak, bw_peak = peaks_for(kind)
    dev = torch.device("cuda")

    lap("2")
    # ---- 2. build: one nvcc for each source, all started together ------
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(3) as pool:
        builds = {name: pool.submit(mod.build) for name, mod in
                  (("zrun_conv.cu", zrun_conv),
                   ("windowed_conv.cu", windowed_conv),
                   ("hungarian.cu", hungarian))}
        for name, job in builds.items():
            try:
                job.result()
            except subprocess.CalledProcessError as e:
                fail(f"nvcc failed on {name}:\n{e.stderr[-4000:]}")
    print(f"build: {' and '.join(builds)} in {time.time() - t0:.1f} s",
          flush=True)
    for name, mod, kern, scale, what in (
            ("zrun_conv.cu", zrun_conv, "zrun_conv_kernel", 1,
             "Cout (of a block)"),
            ("windowed_conv.cu", windowed_conv, "windowed_conv_kernel", 8,
             "Cout (of a block)"),
            ("hungarian.cu", hungarian, "hungarian_kernel", 32,
             "columns at most, costs staged or read from global memory")):
        regs = ptxas_summary(mod.build_log, kern, scale)
        print(f"build: {name} ptxas, {what}: registers / spills: "
              f"{'; '.join(regs)}", flush=True)
        if not regs:
            fail(f"no ptxas report in {name}'s build log")

    lap("3")
    # ---- 3. kernel against its plain version at the routed shapes -------
    cfg = slice_config()
    pipe = pipeline_config(cfg["data"]["instseg_options"])
    t0 = time.time()
    model = build_model(cfg, device="cuda", seed=0)
    backbone = model.voxel_encoder.backbone
    print(f"model: built in {time.time() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params",
          flush=True)
    t0 = time.time()
    served = make_scenes(4, seed=1)
    batch = make_batch(served, pipe, np.random.default_rng(0))
    rows = level_rows(batch)
    most = [int(batch["maps"][f"valid_{l}"].sum(1).max()) for l in range(5)]
    print(f"pipeline: 4 scenes collated in {time.time() - t0:.1f} s, flat "
          f"level rows {rows}, most voxels in one scene per level {most} "
          f"(level caps {pipe.level_caps})", flush=True)
    fm = flatten_maps(to_device(batch["maps"], dev))
    routed = backbone.routed_convs(rows)
    print(f"routing: {len(routed)} convs per forward run zrun_conv: "
          f"{[r[0] for r in routed]}", flush=True)
    if not routed:
        fail("no conv of the slice routes to zrun_conv")
    per_shape = b1_shapes(zrun_conv, fm, routed, dev, flops_peak, bw_peak,
                          "kernel")
    shapes = {(r["level"], r["cin"], r["cout"]): r["per_forward"]
              for r in per_shape}
    torch.cuda.empty_cache()

    lap("4")
    # ---- 4. serve -------------------------------------------------------
    expected = []        # routed convs of each forward the server runs
    model.register_forward_pre_hook(
        lambda mod, args: expected.append(len(backbone.routed_convs(
            level_rows(args[0])))))
    srv = InstSegServer(model, pipe, batch_size=4, num_classes=200, topk=100,
                        max_delay_s=0.02,
                        extra_features={"mv": 768, "pc": 768}, device="cuda")
    try:
        warm = make_scenes(4, seed=2)
        zrun_conv.reset_counts()
        for f in [srv.submit(s) for s in warm]:
            f.result(timeout=900)
        settle(srv, len(warm))
        if zrun_conv.launches != sum(expected):
            fail(f"warm-up ran zrun_conv {zrun_conv.launches} times; "
                 f"routing expects {expected}")
        srv.stats = type(srv.stats)()
        expected.clear()
        torch.cuda.reset_peak_memory_stats()
        scenes = make_scenes(8, seed=3)
        zrun_conv.reset_counts()            # main path starts here
        windowed_conv.reset_counts()
        t0 = time.time()
        results = [f.result(timeout=900)
                   for f in [srv.submit(s) for s in scenes]]
        wall = time.time() - t0
        settle(srv, len(scenes))
        main_launches = zrun_conv.launches  # main path ends here
        b2_serve = windowed_conv.launches
    finally:
        srv.close()
    st = srv.stats.summary()
    if st["scenes"] != 8 or main_launches != sum(expected) \
            or len(expected) != st["steps"]:
        fail(f"zrun_conv launches {main_launches} != routed convs per "
             f"forward {expected} (scenes {st['scenes']})")
    n_inst = 0
    for s, preds in zip(scenes, results):
        if not isinstance(preds, list):
            fail("a request did not resolve to a prediction list")
        for p in preds:
            if p["mask"].shape != (len(s["points"]),) \
                    or not np.isfinite(p["score"]) \
                    or not 0 <= p["class"] < 200:
                fail("an instance has a wrong mask shape, score or class")
        n_inst += len(preds)
    stages = " ".join(f"{k}={v:.3f}s" for k, v in sorted(
        st["stage_s"].items()))
    print(f"serve: {st['scenes']} scenes in {st['steps']} forwards, "
          f"{n_inst} instances | {st['scenes_per_sec']:.3f} scenes/s "
          f"(wall {wall:.2f} s) p50 {st['p50_latency_s'] * 1e3:.1f} ms "
          f"p99 {st['p99_latency_s'] * 1e3:.1f} ms | {stages} | "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
          f"zrun_conv launches {main_launches} = routed convs per forward "
          f"{expected} ({card})", flush=True)

    lap("5")
    # ---- 5. check: served forward vs every conv on its plain version ----
    b = to_device({k: v for k, v in batch.items() if k != "_meta"}, dev)
    for name in ("mv", "pc"):
        b[f"{name}_seg_fts"] = torch.zeros(4, pipe.max_segments, 768,
                                           device=dev)
        b[f"{name}_seg_pad_masks"] = b["seg_pad_masks"]
    enc_out = {}
    model.voxel_encoder.register_forward_hook(
        lambda mod, args, out: enc_out.__setitem__("scales", out))
    backbone.register_forward_hook(
        lambda mod, args, out: enc_out.__setitem__("maps",
                                                   [out[0]] + out[1]))
    outs = {}
    for use_kernel in (True, False):
        backbone.pallas_conv = use_kernel
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            out = model(b)
        torch.cuda.synchronize()
        outs[use_kernel] = {
            "t": time.time() - t0, "maps": enc_out["maps"],
            "scales": enc_out["scales"],
            "cls": [c.float() for c in out["predictions_class"]],
            "mask": [m.float() for m in out["predictions_mask"]]}
    backbone.pallas_conv = True
    got, ref = outs[True], outs[False]

    rel = rel_err
    # what the routed convs feed: the U-Net's output and feature maps and
    # the segment features pooled from them, held at the CPU tests' 2e-2
    feat_rel = max(rel(a, r) for a, r in zip(got["maps"] + got["scales"],
                                            ref["maps"] + ref["scales"]))
    seg_valid = b["seg_pad_masks"][:, :, None]
    mvalid = seg_valid.expand_as(got["mask"][-1])
    keep = torch.ones(got["cls"][-1].shape[-1], dtype=torch.bool, device=dev)
    keep[[0, 2]] = False
    cls_rel = rel(got["cls"][-1][..., keep], ref["cls"][-1][..., keep])
    mask_rel = rel(got["mask"][-1][mvalid], ref["mask"][-1][mvalid])
    # self-mask attend bits (logit >= 0) that differ per decoder round: a
    # logit within rounding of 0 flips, and the rounds after it diverge
    flips = [int((((g >= 0) != (r >= 0)) & seg_valid).sum().item())
             for g, r in zip(got["mask"], ref["mask"])]
    finite = all(torch.isfinite(t).all().item()
                 for t in got["cls"][-1:] + got["mask"][-1:])
    nonneg = int(((got["mask"][-1] >= 0) & seg_valid).sum().item())
    print(f"check: forward with the kernel vs all-plain: features rel "
          f"{feat_rel:.2e} | final class rel {cls_rel:.2e}, mask rel "
          f"{mask_rel:.2e}, attend bits differing per round {flips} | "
          f"final mask logits >= 0: {nonneg} of {int(mvalid.sum().item())} "
          f"| forward {got['t'] * 1e3:.1f} ms vs plain {ref['t'] * 1e3:.1f}"
          f" ms (host clock)", flush=True)
    if not (finite and feat_rel <= 2e-2):
        fail("the served forward disagrees with its plain twin")
    # the full-resolution answer path on this batch's first decoder round,
    # whose masks are not empty under random weights (the final round's
    # may all be negative, so the served lists above may be empty)
    meta = batch["_meta"]
    n_ranked = 0
    for i in range(4):
        preds = rank_instances(
            got["cls"][1][i].cpu().numpy(), got["mask"][1][i].cpu().numpy(),
            batch["seg_pad_masks"][i], num_classes=200, topk=100,
            seg_to_full=meta["segment_to_full"][i])
        n_points = len(meta["segment_to_full"][i])
        for p in preds:
            if p["mask"].shape != (n_points,) or not np.isfinite(p["score"]):
                fail("a ranked instance has a wrong mask shape or score")
        n_ranked += len(preds)
    print(f"rank: round-1 logits of the checked batch give {n_ranked} "
          f"instances with full-resolution masks", flush=True)
    if n_ranked == 0:
        fail("no instance ranked from the round-1 logits")

    if args.profile:
        def served_forward():
            with torch.inference_mode():
                model(b)
        profile_run(served_forward, "served forward", args.profile)
    del model, backbone, srv, outs, got, ref, out, enc_out, b, fm
    torch.cuda.empty_cache()

    lap("5b")
    # ---- 5b. serve_layouts: rect, dev_maps, flat_zt, rect on a pool ----
    lay = serve_layouts_phase(card, dev, zrun_conv, args.profile)
    torch.cuda.empty_cache()

    lap("6")
    # ---- 6. winconv: kernel B2 on the served batch's coordinates --------
    wc = winconv_phase(served, batch, pipe, shapes,
                       {(r["level"], r["cin"], r["cout"]): r["ms"]
                        for r in per_shape}, dev, flops_peak, bw_peak)

    lap("7")
    # ---- 7. kernel_bwd: the backward at a training batch's shapes -------
    import tempfile
    exp_dir = tempfile.mkdtemp(prefix="pq3d_smoke_")
    try:
        t0 = time.time()
        trainer = smoke_trainer(exp_dir)
        warm = next(iter(trainer.train_data(99)))
        rows = level_rows(warm)
        print(f"train setup: trainer built, one batch of 4 augmented scenes "
              f"collated in {time.time() - t0:.1f} s, flat level rows "
              f"{rows}", flush=True)
        tbackbone = trainer.model.voxel_encoder.backbone
        troutes = tbackbone.routed_convs(rows)
        if not troutes:
            fail("no conv of the training batch routes to zrun_conv")
        bwd_shapes = {}  # (level, forward cin, cout) -> routed per step
        for _, lvl, cin, cout in troutes:
            bwd_shapes[(lvl, cin, cout)] = bwd_shapes.get((lvl, cin, cout),
                                                          0) + 1
        tfm = flatten_maps(to_device(warm["maps"], dev))
        bwd = kernel_bwd_phase(zrun_conv, tfm, bwd_shapes, dev, flops_peak,
                               bw_peak)
        del tfm

        lap("8")
        # ---- 8. train ---------------------------------------------------
        windowed_conv.reset_counts()
        tr = train_phase(trainer, zrun_conv, warm, card)
        b2_train = windowed_conv.launches

        lap("8b")
        # ---- 8b. assign: the set loss's solver on the card --------------
        asg = assign_phase(trainer, warm, card, bw_peak)

        lap("9")
        # ---- 9. train_check ---------------------------------------------
        tc = train_check_phase(trainer, zrun_conv, warm)
        if args.profile:
            stem, ext = os.path.splitext(args.profile)
            profile_run(lambda: trainer.train_batch(warm), "train step",
                        f"{stem}_train{ext}")
        del trainer
        torch.cuda.empty_cache()

        lap("9b")
        # ---- 9b. flat_train: the flat pack with the z-run gather conv ----
        t0 = time.time()
        trainer = smoke_trainer(os.path.join(exp_dir, "flat"), *FLAT_ZT)
        print(f"flat_train setup: trainer built in {time.time() - t0:.1f} s "
              f"({' '.join(FLAT_ZT)})", flush=True)
        windowed_conv.reset_counts()
        ft = flat_train_phase(trainer, zrun_conv, tr, card)
        b2_train += windowed_conv.launches
        if args.profile:
            profile_run(lambda: trainer.train_batch(ft["warm"]),
                        "flat train step", f"{stem}_flat_train{ext}")
        del trainer
        torch.cuda.empty_cache()

        lap("9c")
        # ---- 9c. dev_train: the maps built on the card in training ------
        windowed_conv.reset_counts()
        dt = dev_train_phase(card, zrun_conv, exp_dir, tr)
        b2_train += windowed_conv.launches
        trainer = None
    finally:
        import shutil
        shutil.rmtree(exp_dir, ignore_errors=True)
    del trainer
    torch.cuda.empty_cache()

    lap("10")
    # ---- 10. unified: stage-2 serving at full width ---------------------
    unified_phase(card, dev, args.profile)
    torch.cuda.empty_cache()

    lap("11")
    # ---- 11. unified_train: stage-2 training at full width --------------
    unified_train_phase(card, dev, args.profile)
    torch.cuda.empty_cache()

    lap("12")
    # ---- 12. recipe: the two-stage recipe on SceneVerse-layout files ----
    rc = recipe_phase(card, dev, zrun_conv,
                      sum(r["ms"] * r["per_forward"] for r in per_shape),
                      flops_peak, bw_peak)
    torch.cuda.empty_cache()

    lap("13")
    # ---- 13. ddp: data-parallel training (with phase 20's mesh runs in
    # the same launch) and replicated serving; phase 19's exports, which
    # are host work, made in this process while the launches run --------
    prep = {}
    dd = ddp_phase(card, zrun_conv,
                   beside=lambda: prep.update(export_prepare(card, dev)))
    torch.cuda.empty_cache()

    lap("19")
    # ---- 19. export: torch.export artifacts, B1 as pq3d::zrun_conv -----
    ex = export_phase(card, dev, zrun_conv, prep)
    del prep
    torch.cuda.empty_cache()

    lap("20")
    # ---- 20. mesh: FSDP, tensor parallelism, the mesh server (right
    # after phase 13, whose records it reads) ----------------------------
    ms = mesh_phase(card, zrun_conv, dd)
    torch.cuda.empty_cache()

    lap("14")
    # ---- 14. unified_variants: the rest of stage 2 ----------------------
    vr = variants_phase(card, dev)
    torch.cuda.empty_cache()

    lap("15")
    # ---- 15. swin_layouts: Swin3D, the flat device maps, the stage-1 cast
    sw = swin_layouts_phase(card, dev)
    torch.cuda.empty_cache()

    lap("16")
    # ---- 16. conv_options: the voxel encoder's remaining conv options ----
    co = conv_options_phase(card, dev, zrun_conv)
    co_train = {f"conv_options_{k}_{p}": r["b1"][pk]
                for k, r in co["train"].items() if "b1" in r
                for p, pk in (("fwd", "fwd"), ("bwd", "bwd"))}
    torch.cuda.empty_cache()

    lap("17")
    # ---- 17. gather_stem: the 125-tap gather stem, served and trained ---
    gs = gather_stem_phase(card, dev, zrun_conv)
    torch.cuda.empty_cache()

    lap("18")
    # ---- 18. reference_warm_start: reference weights into the trainer ---
    rw = reference_warm_start_phase(card, zrun_conv)
    torch.cuda.empty_cache()

    new_paths = {**{f"gather_stem_{k}": r["launches"]
                    for k, r in gs["runs"].items()},
                 "gather_stem_train_fwd": gs["train"]["b1"]["fwd"],
                 "gather_stem_train_bwd": gs["train"]["b1"]["bwd"],
                 "reference_warm_start_fwd": rw["launches"]["fwd"],
                 "reference_warm_start_bwd": rw["launches"]["bwd"],
                 "export": ex["stage1"]["launches"],
                 "export_voxel_level": ex["voxel_level"]["launches"],
                 "mesh_train_fwd": ms["stage1_fsdp"]["launches"]["fwd"],
                 "mesh_train_bwd": ms["stage1_fsdp"]["launches"]["bwd"],
                 "mesh_serve": ms["server"]["launches"]}

    lap("end")

    # ---- kernels line + result -----------------------------------------
    def per_fwd(key):
        return sum(r[key] * r["per_forward"] for r in per_shape)

    def per_step(key):
        return sum(r[key] * r["per_step"] for r in bwd)
    entry = {
        "name": "zrun_conv", "route": "cuda",
        "source": "pq3d_tpu_torch/csrc/zrun_conv.cu",
        "replaces": "pq3d_tpu/ops/pallas_zt.py:386",
        "launches": main_launches + tr["counts"]["fwd"]
        + tr["counts"]["bwd"] + ft["counts"]["fwd"] + ft["counts"]["bwd"]
        + sum(dt[k]["counts"][p] for k in DEV_TRAIN_MAIN
              for p in ("fwd", "bwd"))
        + rc["launches"]["fwd"] + rc["launches"]["bwd"]
        + sum(r["launches"] for r in lay["runs"].values())
        + dd["stage1"]["launches"]["fwd"] + dd["stage1"]["launches"]["bwd"]
        + dd["replicated"]["launches"]
        + sum(r["launches"] for r in sw["runs"].values())
        + sum(r["launches"] for r in co["runs"].values())
        + sum(co_train.values()) + sum(new_paths.values()),
        "launches_by_path": {"serve": main_launches,
                             **{f"serve_{k}": r["launches"]
                                for k, r in lay["runs"].items()},
                             "train_fwd": tr["counts"]["fwd"],
                             "train_bwd": tr["counts"]["bwd"],
                             "flat_train_fwd": ft["counts"]["fwd"],
                             "flat_train_bwd": ft["counts"]["bwd"],
                             **{f"dev_train_{k}_{p}": dt[k]["counts"][p]
                                for k in DEV_TRAIN_MAIN
                                for p in ("fwd", "bwd")},
                             "recipe_fwd": rc["launches"]["fwd"],
                             "recipe_bwd": rc["launches"]["bwd"],
                             "ddp_train_fwd": dd["stage1"]["launches"]["fwd"],
                             "ddp_train_bwd": dd["stage1"]["launches"]["bwd"],
                             "ddp_serve": dd["replicated"]["launches"],
                             "unified_variants": vr["b1"],
                             **{f"swin_layouts_{k}": r["launches"]
                                for k, r in sw["runs"].items()},
                             **{f"conv_options_{k}": r["launches"]
                                for k, r in co["runs"].items()},
                             **co_train, **new_paths},
        "max_abs_err": max(r["max_abs_err_f32"] for r in per_shape),
        "ms": per_fwd("ms"), "host_ms": per_fwd("host_ms"),
        "plain_ms": per_fwd("plain_ms"), "bound_ms": per_fwd("bound_ms"),
        "bound_by": max(per_shape, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "serve_layouts": lay["runs"],
        "dev_map_build_ms": lay["map_build_ms"],
        "layout_forward_ms": lay["forward_ms"],
        "scope": f"ms/host_ms/plain_ms/bound_ms: sum over the "
                 f"{len(routed)} routed convs of one served forward (B=4), "
                 f"ms the median device-clock time of a call, host_ms the "
                 f"wrapper's host time per call; bwd_*: sum of the dx "
                 f"launches over the {len(troutes)} routed convs of one "
                 f"train step (B=4); launches: the serving run, the "
                 f"serve_layouts runs (rect, dev_maps, flat_zt, rect on a "
                 f"pool), the 5 timed train steps (rectangular and flat + "
                 f"z-run), phase dev_train's {DEV_TRAIN_STEPS} timed steps "
                 f"in dev_maps and dev_flat_zt (forward, dx, on plans "
                 f"built on the card), the recipe's stage-1 "
                 f"runs (train and eval forwards, dx), phase ddp's timed "
                 f"stage-1 steps on both ranks (forward, dx) and its "
                 f"replicated serving, phase swin_layouts' dev_flat_zt and "
                 f"flat_zt_bf16 runs (0 in its swin runs), phase "
                 f"conv_options' served setups (0 in its compact ones) and "
                 f"its training runs (forward, dx), phase gather_stem's "
                 f"rect_gather and dev_gather runs and its training "
                 f"(forward, dx), phase reference_warm_start's 2 steps "
                 f"(forward, dx), phase export's {ex['stage1']['forwards']} "
                 f"forwards of the stage-1 program exported on the CPU and "
                 f"its VoxelLevelEncoder forward, phase mesh's FSDP "
                 f"stage-1 step 2 on both ranks (forward, dx) and its "
                 f"mesh server's part forwards; recipe_ms: the "
                 f"same sum "
                 f"as ms over one forward of 4 SceneVerse-replica scans",
        "recipe_ms": rc["b1_ms"], "recipe_shapes": rc["b1"],
        "recipe_train_check": rc["train_check"],
        "ddp_rank0_shapes": dd["stage1"]["b1"],
        "ddp": {k: {kk: v for kk, v in r.items() if kk != "b1"}
                for k, r in dd.items()},
        "swin_layouts": {k: v for k, v in sw.items() if k != "locks"},
        "conv_options": co,
        "gather_stem": gs, "reference_warm_start": rw, "export": ex,
        "mesh": ms,
        "shapes": per_shape,
        "bwd_launches": tr["counts"]["bwd"],
        "bwd_ms": per_step("ms"), "bwd_host_ms": per_step("host_ms"),
        "bwd_plain_ms": per_step("plain_ms"),
        "bwd_bound_ms": per_step("bound_ms"),
        "bwd_bound_by": max(bwd, key=lambda r: r["bound_ms"])["bound_by"],
        "bwd_max_abs_err": max(r["max_abs_err_dx"] for r in bwd),
        "dw_regather_ms": per_step("dw_ms"),
        "dw_regather_bound_ms": per_step("dw_bound_ms"),
        "bwd_shapes": bwd,
        "train_check": tc,
        "flat_train_check": ft["train_check"],
        "flat_vs_rect": {"loss_rel": ft["flat_vs_rect_loss_rel"],
                         "grad_rel": ft["flat_vs_rect_grad_rel"],
                         "tensor_rel": ft["flat_vs_rect_tensor_rel"]},
        "dev_train": {k: {kk: v for kk, v in r.items()
                          if kk not in ("steps", "host_s")}
                      for k, r in dt.items()},
        # shares of one forward's (dx: one step's) N x 27 slots and (tile,
        # tap) pairs, weighted by each conv's dense N x 27 x Cin x Cout work
        "slot_share": per_fwd("flops") / per_fwd("dense27_flops"),
        "mult_share": per_fwd("mult_flops") / per_fwd("dense27_flops"),
        "bwd_mult_share": per_step("mult_flops") / sum(
            2.0 * r["n"] * 27 * r["cin"] * r["cout"] * r["per_step"]
            for r in bwd),
    }
    routed_b2 = [r for r in wc["shapes"] if r["per_forward"]]

    def b2_fwd(key):
        return sum(r[key] * r["per_forward"] for r in routed_b2)
    b2_entry = {
        "name": "windowed_conv", "route": "cuda",
        "source": "pq3d_tpu_torch/csrc/windowed_conv.cu",
        "replaces": "pq3d_tpu/ops/pallas_conv.py:205",
        "launches": wc["launches"],
        "launches_by_path": {"serve": b2_serve,
                             "serve_layouts": sum(r["b2_launches"] for r in
                                                  lay["runs"].values()),
                             "train": b2_train,
                             "unified_variants": vr["b2"],
                             "swin_layouts": sum(r["b2_launches"] for r in
                                                 sw["runs"].values()),
                             "conv_options": sum(r["b2_launches"] for r in
                                                 co["runs"].values()),
                             "gather_stem": sum(r["b2_launches"] for r in
                                                gs["runs"].values()),
                             "export": ex["stage1"]["b2_launches"],
                             "mesh": ms["stage1_fsdp"]["b2_launches"]
                             + ms["stage2_tp"]["b2_launches"]
                             + ms["server"]["b2_launches"],
                             "winconv": wc["launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in wc["shapes"]),
        "ms": b2_fwd("ms"), "plain_ms": b2_fwd("plain_ms"),
        "bound_ms": b2_fwd("bound_ms"),
        "bound_by": max(routed_b2, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "kernel_ms": b2_fwd("kernel_ms"),
        "b1_ms": b2_fwd("b1_ms"),
        # the share of one forward's dense N x K x Cin x Cout work in the
        # (16-row, tap) pairs the kernel multiplies
        "mult_share": b2_fwd("mult_flops") / b2_fwd("dense_flops"),
        "fold_s": sum(r["fold_s"] for r in wc["levels"] if r["k"] == 27),
        "scope": f"ms/kernel_ms/plain_ms/bound_ms/b1_ms: sum over the "
                 f"{len(routed)} routed convs of one served forward (B=4) on "
                 f"Morton-ordered maps of the same coordinates; ms is the "
                 f"wrapper (bf16 cast, W's layout, kernel), kernel_ms the "
                 f"launch alone; fold_s: host seconds of fold_exceptions "
                 f"over the levels' 3^3 maps; launches: the winconv phase "
                 f"(B2 is on no model path)",
        "levels": wc["levels"], "shapes": wc["shapes"],
    }
    a = asg["set_loss"]
    solver_paths = {"train": tr["counts"]["hungarian"],
                    "flat_train": ft["counts"]["hungarian"],
                    **{f"dev_train_{k}": dt[k]["counts"]["hungarian"]
                       for k in DEV_TRAIN_MAIN},
                    **{f"recipe_{k}": n for k, n in rc["hungarian"].items()},
                    "ddp_train": dd["stage1"]["hungarian"],
                    "ddp_stage2": dd["stage2"]["hungarian"],
                    "mesh_train_fsdp": ms["stage1_fsdp"]["hungarian"],
                    "mesh_train_tp": ms["stage2_tp"]["hungarian"],
                    "reference_warm_start": rw["hungarian"]}
    solver_entry = {
        "name": "hungarian", "route": "cuda",
        "source": "pq3d_tpu_torch/csrc/hungarian.cu",
        "replaces": "pq3d_tpu/ops/hungarian.py:28",
        "replaces_note": "no Pallas kernel: the JAX package's on-device "
                         "lax.while_loop solver (solve, vmapped by its set "
                         "loss's solve_batch)",
        "launches": sum(solver_paths.values()),
        "launches_by_path": solver_paths,
        "max_abs_err": max(r["max_abs_err"] for r in asg.values()),
        "ms": a["ms"], "host_ms": a["host_us"] / 1e3,
        "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": a["library_ms"],
        "scope": f"ms/host_ms/plain_ms/bound_ms/library_ms: one call on "
                 f"the {a['lanes']} lanes ({a['rows']} x {a['cols']}) of "
                 f"phase 8's set loss; plain_ms on the CPU; library_ms the "
                 f"parent's path (the costs to the host, one scipy "
                 f"linear_sum_assignment a lane, the assignment back): no "
                 f"PyTorch call solves an assignment; max_abs_err: col4row "
                 f"against the plain version's over the three kinds; "
                 f"launches: the set-criterion train steps of phases 8, 9b, "
                 f"9c (dev_maps, dev_flat_zt), "
                 f"13 (every stage-1 rank) and 20 (FSDP), the recipe's "
                 f"stage-1 train and eval losses and phase 18's steps (0 "
                 f"under the direct criterion and on stage 2)",
        "kinds": asg,
    }
    print(f"summary: B1 {entry['ms']:.3f} ms per served forward (host "
          f"{entry['host_ms']:.3f} ms) against B2 {b2_entry['ms']:.3f} ms "
          f"(kernel alone {b2_entry['kernel_ms']:.3f} ms, multiplied share "
          f"{b2_entry['mult_share']:.4f}) in this run, ratio "
          f"{entry['ms'] / b2_entry['ms']:.3f}; B1 dx "
          f"{entry['bwd_ms']:.3f} ms per train step (host "
          f"{entry['bwd_host_ms']:.3f} ms); multiplied share of the dense work {entry['mult_share']:.4f} "
          f"forward, {entry['bwd_mult_share']:.4f} dx", flush=True)
    print(f"summary: assignment kernel {a['ms']:.4f} ms on the set loss's "
          f"{a['lanes']} lanes against the parent's copy + scipy path "
          f"{a['library_ms']:.3f} ms; launches {solver_paths}", flush=True)
    print(json.dumps({"kernels": [entry, b2_entry, solver_entry]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
