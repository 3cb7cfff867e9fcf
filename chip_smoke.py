"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --phases 1,2,13  # chosen phases (1, 2 always)

Phases, each printing its own lines and raising on failure (the script then
exits non-zero and prints no final line), run in the order 1, 2, 3, 4, 3b,
5, 3c, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19 (3b takes its shapes from the CMDA model
that phase 5 serves and from phase 10's schedule, 3c from the one that
phase 7 trains and phase 10's schedule; phases 11, 12 and 13 run 3b and 3c
again at their models' shapes before their own lines). ``--phases`` runs a
chosen phase with the rest of its block (PHASE_BLOCKS: 3 and 4; 3b and 5;
3c, 6 and 7), and 10 with 3b and 3c, which hold its shapes:

1. device   — a CUDA card is required; prints its name and power limit and
              turns TF32 off so that float32 checks are float32.
2. build    — compiles the port's CUDA kernels from csrc/ (one nvcc each, in
              parallel) and prints the build seconds and ptxas's registers
              and spills per kernel instantiation; counts the tensor-core
              instructions (HMMA, HGMMA) in the SASS of the three
              libraries' bf16 kernels, raising if any has none (K2-bwd's
              one-pass kernel must have HGMMA, wgmma, in each of its four
              instantiations, one per padded width; the wide kernels of
              D or C above 128 HMMA, 3 forward and 4 backward), and the
              FP32-pipe and F2FP instructions per
              MUFU.EX2 in the main loop of the flash-attention bf16 kernels,
              forward and backward; K3's GEMM must run integer wgmma (IGMMA)
              in each of its instantiations, as many as its library holds,
              beside its quantize pass.
3. kernels  — every stride-1 bottleneck shape of SlowFast-R50 8x8 serving
              (the K1 shape table) and four off-path shapes (slow s5 and
              fast s2 at the 224 crop, a projection with channel counts
              that are not multiples of 8, a height that the strip does not
              divide) through the fused kernel against its plain version,
              in float32 and bfloat16, at 1 clip and at the request batch,
              and the path's shapes in bfloat16 also at the 30-view test
              batch of phase 8 (64 clips, printing each one's split);
              at the request batch it also times the kernel, the plain
              version and the same block unfused through the port's
              nn.Module (cuDNN), beside the block's bound on an H100, and
              prints the bf16 kernel's split of the work.
3b. attention — the flash-attention kernel against its plain version at
              the four CMDA-R50 shapes (one per lateral fusion) and five
              off-path shapes (ragged keys; pooled non-local keys; three on
              the bf16 kernel's tile edges), in float32 and bfloat16, at 1
              clip and at the request batch, and the path's shapes in
              bfloat16 also at phase 8's 64-clip batch; then every
              attention shape that phase 10 runs (its multigrid frame
              counts and crops: N from 32 to 25088 tokens), f32 and bf16 at
              1 and 4 clips and bf16 at its largest phase-10 batch (up to
              128 clips); at the request batch it also times the kernel, the plain version and
              scaled_dot_product_attention, beside the shape's bound, and
              prints the kernel's ratio to each.
4. serving  — SlowFast-R50 8x8 at full width (400 classes, 32 frames,
              256² test crop, bf16, TPU.FUSED_EVAL) on seeded random weights
              made in the JAX package's layout and carried across by the
              port's weight bridge; answers REQUESTS (2) requests through
              make_forward, checks 26 kernel launches per request and the
              scores, and holds them against the module's own forward,
              printing the fused engine's request time less K1's kernel
              time (phase 3); then the same at float32 on one clip, at a
              tight tolerance.
5. cmda     — SlowFastDualAttention-R50 8x8 (the CMDA model) at full width,
              the same way, with the attention's query and key convs
              scaled on a seeded clip so that its logits are of a trained
              model's order: two requests through make_forward, 4 attention
              launches per request and none of the fused bottleneck, held
              against the same model under TPU.FLASH_ATTENTION False (the
              plain version on the card); then float32 on one clip.
3c. attention backward — the flash-attention backward kernels against
              their plain version (attention_backward), and K2's output
              with its log-sum-exp store on against it off (bit for bit),
              at the four CMDA-R50 fusion shapes of the 224² training crop
              and three off-path shapes (ragged keys, ragged tiles, D = C =
              24) and every training shape of phase 10 (bf16 also at its
              largest phase-10 batch), in float32 and bfloat16, at 1 clip
              and at the training batch, and at the smallest path shape and 1 clip also against autograd through
              chunked_attention (the JAX package's backward written out); a
              second call on the same inputs must give bit-identical dK and
              dV (and dQ in float32; bf16 dQ, summed by atomic adds, within
              the tolerance); at the training batch it prints the bf16
              kernel's split (keys a block, queries a tile, ring stages,
              blocks and blocks an SM, shared memory) and times the
              kernels, the plain
              version and the backward of scaled_dot_product_attention,
              beside the shape's bound and PR 5's two-pass kernel's times.
6. train    — SlowFast-R50 8x8 at full width trained as
              configs/Kinetics/SLOWFAST_8x8_R50.yaml trains (224² crop,
              bf16, 8 clips a card, SGD lr 0.1 with nesterov momentum 0.9,
              weight decay 1e-4, dropout 0.5, final BNs zero-initialised):
              TRAIN_WARMUP (1) warm-up and TRAIN_STEPS (3) timed steps
              through create_train_state and make_train_step, no kernel
              launched, every loss finite, BN running statistics moved;
              then PROFILE_STEPS (1) more steps traced by
              utils/profiler.py (the device-busy share and the top five
              kernels, below); then one timed step (after one warm-up)
              with TPU.REMAT and TPU.REMAT_STAGES [2].
7. cmda_train — CMDA-R50 8x8 the same way, attention calibrated as in
              phase 5: 4 forward and 4 backward calls of the attention
              kernels a step and no fused bottleneck; then one step on one
              clip in float32 and one in bfloat16, each held against the
              same step under TPU.FLASH_ATTENTION False (plain forward,
              backward by autograd through it, on the card); PROFILE_STEPS
              more steps traced after the timed ones, as in phase 6.

8. thirty_view — the 30-view test of configs/Kinetics/SLOWFAST_8x8_R50.yaml
              (TPU.FUSED_EVAL, K1) and then of
              SLOWFAST_DUALATTENTION_8x8_R50.yaml (K2, attention calibrated
              as in phase 5), bf16, on the synthetic test split (8 videos x
              10 x 3 views = 240 clips in 4 batches of the yaml's 64, the
              last 48 real and 16 padded) through the loader (8 threads),
              the pinned host→GPU copy, the preprocess and the forward
              (perform_test): one untimed batch, the forward alone on a
              resident batch, then the timed test. Gates: 26 K1 launches a
              batch on SlowFast and none on CMDA, 4 K2 launches a batch on
              CMDA and none on SlowFast; K1 plans no shape (each was
              planned, and held against the plain version, at 64 clips in
              phase 3); every clip's probabilities finite and summing to 1
              within TEST_ROW_TOL; the TestMeter complete; the first
              batch's pathways on the card within PRE_TOL of the CPU
              preprocess in float32; per video, the centred log mean
              probabilities within TEST_LOGIT_TOL of their scale of those
              of test() from a .pyth of the same weights without the
              kernels (SlowFast: TPU.FUSED_EVAL False, the module forward;
              CMDA: TPU.FLASH_ATTENTION False, the plain attention). Prints
              end-to-end clips/s, the forward alone, each batch's wait on
              the loader and its copy, preprocess and forward times, and
              peak memory; then the second batch of a fresh pass traced.
9. epochs   — CMDA-R50 as phase 7 trains it (8 clips a step, 224² crops
              from the 320-short-side canvas, jitter [256, 320], bf16,
              dropout 0.5, attention calibrated): train_epoch over the
              synthetic train split (64 videos, 8 steps) and eval_epoch over
              the val split (64 clips, 8 batches) through the loaders, once
              untimed (epoch 0: the loaders' first buffers and pinned
              canvases, the eval shapes' cuDNN plans) and once timed (epoch
              1). Gates: 4 K2 launches a train step and a val batch, 12
              K2-bwd launches a train step, no K1 (epoch 1); finite losses;
              BN running statistics moved; each step's lr get_lr_at_epoch's
              at its fractional epoch; val errors in [0, 100]. Prints train
              clips/s through the loader beside phase 7's steps alone, val
              clips/s, both epochs, and peak memory.
10. recipe  — the paper's training recipe,
              configs/Kinetics/SLOWFAST_DUAL_8x8_R50_stepwise_multigrid.yaml
              (CMDA-R50 at full width and depth, 400 classes, bf16, random
              weights), through the port's CLI (tools/run_net.py main: train,
              then the 30-view test), each cut printed (RECIPE_CUTS): 4
              epochs over 3 long-cycle shapes ([8, 8, 158] with 8-split BN
              twice, [4, 16, 158] with 4, the final [1, 32, 224] with plain
              BN), the short cycle, precise BN, a checkpoint and a val epoch
              each epoch. Gates: each epoch's (B, T, S, BN type, splits) the
              schedule's and its steps the short cycle's; finite losses;
              each step's lr the policy's; 4 K2 launches a forward (train,
              precise BN, val, test, the model-info forward) and 12 K2-bwd a
              train step; every K2 shape held in 3b/3c at its batch; each
              checkpoint bit-identical to what was saved and loaded back
              bit-identically into a model of its BN form; the test's
              per-video scores equal to test() of the last checkpoint by
              path; then the CLI again with AUTO_RESUME from the second
              checkpoint: it starts at the next epoch from that file's state
              bit for bit, at the policy's lr (run 1's). Prints per epoch
              train clips/s and peak memory, precise BN's seconds, each
              checkpoint's seconds and bytes, the test's clips/s.
11. nonlocal — configs/Kinetics/I3D_NLN_8x8_R50.yaml (single-pathway I3D
              R50 at full width and depth, 400 classes, bf16, softmax
              non-local blocks after blocks 1, 3 of s3 and 1, 3, 5 of s4,
              seeded weights with every non-local final BN γ 1 and θ, φ
              scaled so that the scaled logits have ATTN_LOGIT_STD, as
              phase 5 calibrates). First 3b and 3c at its shapes: K2 at
              s3's D = C = 256 (N 3136, M 784 at 224², 8 clips; N 4096,
              M 1024 at 256², 64 clips), s4's 512 (N 784 and 1024, dense
              on the path below TPU.FLASH_MIN_TOKENS) and two ragged wide
              shapes, f32 and bf16 at 1 clip and the path's batch, timed
              there beside the bound, the plain version and SDPA (with the
              backend it picked); K2-bwd at the same shapes at 1 and 8
              clips, against autograd at the smallest, dK and dV (and dQ)
              bit-identical on a second call, each shape's split printed.
              Then: two 4-clip requests at the 30-view shape (8 frames,
              256²) through make_forward, 2 K2 launches a request and no
              K1, held against TPU.FLASH_ATTENTION False (bf16, then f32
              on one clip); the 30-view test (phase 8's gates, 2 K2 a
              batch, against test() without the kernels); training as the
              yaml trains (224², 8 clips, SGD 0.1 nesterov, wd 1e-4,
              dropout 0.5; TRAIN_WARMUP warm-up and TRAIN_STEPS timed
              steps, 2 K2 and 6 K2-bwd launches a step, finite losses, BN
              statistics moved, PROFILE_STEPS steps traced; the non-local γ
              at the yaml's zero init), and
              one-clip f32 and bf16 steps with γ 1 against the same steps
              under TPU.FLASH_ATTENTION False: the losses, and every
              attention call of the kernel step against the plain
              versions on its inputs (NLN_LOSS_TOL argues why not the
              whole step, as phase 7 holds); and two requests of
              SLOWFAST_NLN_8x8_R50.yaml (dot_product, two pathways, 32
              frames, 256²; TPU.FUSED_EVAL True, which the fused engine
              refuses): no K1, no K2, finite rows summing to 1.
12. efficient — the four efficient CMDA families of the zoo,
              configs/Kinetics/SLOWFAST_{SHUFFLENETV2,SHUFFLENET,
              MOBILENETV2,GHOSTNET}_16x2_112.yaml (ShuffleNetV2 w2.0,
              ShuffleNet w2.0 g3, MobileNetV2 w1.0, GhostNet w1.0; full width
              and depth, 400 classes, 16 frames, 112², bf16, seeded weights,
              attention and classifier calibrated as phase 11 does). First
              3b and 3c at their fusion shapes, q and k scaled to logits of
              std ATTN_LOGIT_STD: K2 at every fusion above
              TPU.FLASH_MIN_TOKENS (N = M = 3136 at D = C = 3 and 6, 12544
              at 2), f32 and bf16 at 1 and 64 clips, timed at 64; K2-bwd at
              the trained families' (ShuffleNetV2, GhostNet), 1 and 64 clips.
              Then each family: two 4-clip requests through make_forward
              (1, 1, 1, 2 K2 launches a request, gated) against
              TPU.FLASH_ATTENTION False (bf16 at 2e-2 of the scores' scale,
              f32 on one clip at 1e-4), one request traced (device time by
              launching op: depthwise convolutions, other convolutions, BN,
              the attention kernels, copies; the host's copy ops against the
              model's blocks); the 30-view test as phase 8 runs it (GhostNet's
              scores are the mean of ReLU(logits): finite and non-negative,
              held against test() without the kernels on the mean scores);
              and ShuffleNetV2 and GhostNet trained as the yamls train (64
              clips a step, the yamls' 512 over 8 cards; SGD from lr 0.01,
              nesterov, wd 1e-4, dropout 0.5): TRAIN_WARMUP warm-up and
              TRAIN_STEPS timed steps, PROFILE_STEPS traced, K2 and K2-bwd
              launches a step gated, then one-clip
              f32 and bf16 steps held as phase 11 holds them.
13. detection — AVA on a seeded split that the phase writes in the shape of
              tests/test_ava.py's fixture (JPEG frames at 320x568 read with
              PIL, frame lists, 2-6 person boxes a keyframe with 1-3 of the
              80 action ids, scored val person boxes, val ground truth, a
              label map, one exclusion; 64 train and 32 val keyframes).
              configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml (SlowFast-R50, s5 at
              stride 1 and dilation 2, 80 classes, bf16, seeded weights)
              served through perform_detection_test (8 clips and 256 box
              slots a batch on the 256x512 canvas, the pinned ring; no
              kernel launch; ms a batch, clips/s and boxes/s end to end and
              for the forward alone, peak memory, the frame mAP in [0, 1]),
              one batch traced (device-busy share, the RoI head's and
              ROIAlign's share of the device time), one clip's bf16 logits
              against float32 (TEST_LOGIT_TOL), test() from a .pyth, and
              SLOW_8x8_R50_SHORT.yaml served. Then the same yaml with
              MODEL_NAME SlowFastDualAttention: 3b at its four serving
              shapes (N = 65536, 65536, 16384, 4096 at 8 clips) against the
              chunked plain version, 3c at its training shapes (224², 16
              clips); served with 4 K2 launches a forward at those shapes,
              each call held on its inputs, the logits held against the
              plain attention in bf16 and float32 (below); trained at the
              yaml's 16 clips (4 K2 and 12 K2-bwd launches a step, losses,
              BN, PROFILE_STEPS steps traced) with one-clip steps held as
              phase 7's.
              Last, SlowFast through tools/run_net.py (SOLVER.MAX_EPOCH 1):
              4 steps of 16 clips, one traced, a val mAP, a checkpoint and
              test() from it.
14. frames  — the frame datasets on a split the phase writes
              (phase_frames): the fatigue CMDA-R50 and SlowFast-R50,
              Charades and SSv2.
15. int8    — int8 serving and the serving export. SlowFast-R50 8x8
              (serving_cfg, module forward) with TPU.INT8_EVAL and
              +TPU.INT8_SPATIAL on the same seeded weights as a bf16
              module forward: calibrated on one request (each int8 conv's
              input shape recorded), two requests through make_forward
              (K3 launches a request gated: one per int8 conv), held
              against the same network with K3's plain version on the card
              (bit for bit) and against the bf16 forward (centred log
              probabilities, INT8_LOGIT_TOL; top-1 agreement printed), and
              the same ratio read under three planted faults
              (INT8_FAULTS; the gate must see the last); the request and a
              resident 64-clip forward timed beside bf16.
              K3 against its plain version at every int8 conv shape of
              the request and seven off-path shapes (a 3-channel stem with
              stride 2, float32 inputs): the quantize pass's code buffer
              and weight layout, the int32 accumulators and the output bit
              for bit, the plan's shared memory the library's; each shape
              timed on the device (K3's two launches and cuDNN's conv
              under the profiler, per call) and by CUDA events, beside its
              bound, the plain version, torch._int_mm (pointwise shapes
              where its rules hold) and the wrapper's host time a call;
              per request under each option the device and event sums.
              test() of SLOWFAST_8x8_R50.yaml with TPU.INT8_EVAL on the
              synthetic split twice: the first calibrates and persists, the
              second loads the file (K3 launches a batch gated). Export
              round trips (engine/export.py): fused SlowFast (26 K1
              nodes), CMDA-R50 (4 K2) and SlowFast-R50 32x2 AVA detection
              exported on the card (the int8 SlowFast's, 110 K3, is phase
              20's); each served on the card at
              batches 4 and 1 against the live forward, the launches
              inside the artifact gated, its MB and export and load
              seconds printed.

16. gradcam — Grad-CAM of CMDA-R50 8x8 (SLOWFAST_DUALATTENTION_8x8_R50.yaml
              at full width and depth, seeded weights, attention calibrated
              as in phase 5) on one clip of the synthetic test split (32
              frames, its centre 256² crop through the test preprocess),
              through visualization/video_cam.py::gradcam_clip at s4 and s3:
              4 K2 launches a call and 1 (s4) or 2 (s3) K2-bwd calls, each
              K2 call held against chunked_attention and each K2-bwd call
              against attention_backward on its inputs, at the attention
              tolerances of each output's and gradient's own scale
              (GRADCAM_SCALE_FLOOR), the gate shown to fail two planted
              dV faults (zeroed; P dO for Pᵀ dO); the bf16 CAMs
              no farther from the f32 plain path's than the bf16 plain
              path's are (CMDA_TRAIN_BF16_RATIO); at s4 also f32 against the
              plain attention (GRADCAM_F32_ATOL); each fusion's K2-bwd alone
              at its one-clip shape beside the plain version, SDPA's
              backward and the bound; ms a gradcam_clip call by CUDA
              events, K2's and K2-bwd's device time in a traced call, peak
              memory; the s4
              overlays written as GIFs (the card's machine cannot build the
              video decoder, so no mp4).
17. demo    — the demo (engine/demo.py::demo, as tools/run_net.py calls
              it) on seeded windows of a synthetic stream (DEMO_WINDOWS
              windows; the card's machine cannot build the video decoder,
              so no file source and no DEMO.OUTPUT_FILE), each run with a
              display sink that takes the overlays and reads the launches
              a window, its weights from a .pyth as TEST.CHECKPOINT_FILE_
              PATH: (a) demo/Kinetics/SLOWFAST_8x8_R50.yaml with
              TPU.FUSED_EVAL (26 K1 launches a window, the warm-up's on
              the first), its scores held against the module forward on the
              same pathways (SERVE_BF16_ATOL); (b) the CMDA-R50 demo yaml,
              attention calibrated as in phase 5 (4 K2 a window), each K2
              call against chunked_attention on its inputs (ATTN_BF16_TOL
              of its own scale) and the scores against the plain attention
              (CMDA_BF16_ATOL); (c) (a)'s yaml with TPU.INT8_EVAL: a first
              run calibrates on its first window and persists, a second
              loads the file (one K3 op call an int8 conv a window, 47),
              one window's K3 calls held bit for bit against K3's plain
              version (codes, accumulators, output), the scores against
              (a)'s bf16 module forward (INT8_LOGIT_TOL); (d)
              demo/AVA/SLOWFAST_32x2_R101_50_50.yaml from a boxes file the
              phase writes, then from a camera capture with a live detector
              (DEMO.DETECTOR_FN), no kernel. Each prints ms a window with
              and without the overlays (the demo's logged fps, the scores
              on the host), the device time, busy share and host-to-device
              bytes of a traced window, peak memory and the launches.
18. dist    — distribution (phase_distributed), CMDA-R50 8x8 as phase 7
              trains it (its seeded weights, attention calibrated, one
              fixed global batch of TRAIN_CLIPS 224² clips, bf16, the
              yaml's warm-up lr): (a) one step through DDP over NCCL at
              world size 1 against the same step without a process group
              (the loss bit for bit, the parameters within DIST_DDP_BOUND
              of the step's length, 4 K2 and 12 K2-bwd launches; a DDP
              step with gradients planted x DIST_PLANTED_SCALE by a comm
              hook must fail that bound); (b) DIST_WORLD ranks over gloo on
              cuda:0 (one card: NCCL refuses two ranks on one device),
              each a process started as the CLI's flags start one
              (--num_shards, --shard_id, --init_method, --device cuda:0,
              launch_job) and killed at DIST_DEADLINE_S: DIST_STEPS steps
              of each rank's half of the global batch (the first step's 4
              K2 and K2-bwd calls held against the plain versions on their
              inputs at their own scale, GRADCAM_SCALE_FLOOR, with the
              planted dV faults of phase 16 on the smallest call; one more
              step traced: the card's busy share and the host's wall time
              inside the synchronous all-reduces),
              then the 30-view test of SLOWFAST_8x8_R50.yaml with
              TPU.FUSED_EVAL from a .pyth (240 clips, global batches of
              64: 4 of 32 a rank, the last 24 real). Gates: the launches
              (4 K2 and 12 K2-bwd a step, then 104 K1, a rank); losses, a
              crc of the parameters and the gathered per-video scores equal
              across the ranks; losses within DIST_LOSS_TOL of one
              process's steps on the global batch, the per-video centred
              log mean probabilities within TEST_LOGIT_TOL of one
              process's test().
              Prints train clips/s at 1 process and 2 ranks, the traced
              step's busy share and all-reduce waits (and the CPU time of
              issuing the collectives), each rank's peak memory, and the
              phase's seconds.
19. space   — spatial model parallelism (phase_spatial): SPACE_WORLD ranks
              over gloo on cuda:0 under TPU.SPATIAL_SHARD 2 (D = 1),
              started through the CLI's flags (rank19_job, rank_main),
              each rank holding its band of every frame's rows: (a)
              CMDA-R50 8x8 serving CLIPS_PER_REQUEST clips at 256² (phase
              5's model, attention calibrated), its 4 K2 calls held
              against chunked_attention on their inputs (N = 16384 queries
              against M = 32768 keys at s1_fuse), the scores against one
              process's; (b) one CMDA-R50 step of TRAIN_CLIPS clips at
              224² as phase 18 takes it (each K2 and K2-bwd call held,
              phase 16's planted dV faults with "half the queries" for P
              dO), the loss within DIST_LOSS_TOL of one process's, then
              the same step in float32 (TF32 off) with its parameters
              within DIST_DDP_BOUND of one process's step, and a step with
              the space group's gradients left unsummed (a DDP comm hook)
              that must fail that bound (bf16's own distance is printed
              beside float32's: a random CMDA-R50's bf16 step is
              chaotic); (c) the fused SlowFast-R50 serving 4 clips at
              256², its 26 K1 calls on halo slabs held against
              bottleneck_reference, the probabilities against one
              process's; (d) the step's TPU.CHECKPOINT_BACKEND orbax save
              (a .dcp by async_save from both ranks) written while (c)
              runs, then resumed bit for bit. Prints each rank's peak
              memory beside one process's at the same clips, ms a request
              and a step beside one process's, and the launches (4 K2, 26
              K1, 4 K2 + 12 K2-bwd a rank).
20. entry   — the entry points under TPU.SPATIAL_SHARD 2 (phase_entry):
              ENTRY_WORLD ranks over gloo on cuda:0 started through the
              CLI's flags (rank20_job, rank_main), each against one
              process on the same inputs: (a) int8 SlowFast-R50 8x8 (4
              clips at 256²) under INT8_EVAL and +INT8_SPATIAL, calibrated
              on one request by the group's step: the group's ranges the
              maximum of the ranks' own and within ENTRY_RANGE_TOL of one
              process's, 47 / 110 K3 calls a request a rank, each on its
              halo slab bit-equal to int8_conv_reference on its inputs,
              the scores by ENTRY_INT8_RATIO against one process's bf16
              and int8 and within ENTRY_INT8_DIRECT_TOL of one process's
              int8 (a planted fault, rank 1's halo rows zeroed in
              ENTRY_FAULT_CONV, must fail both); (b) the export of (a)'s
              +INT8_SPATIAL model written by the master on the CPU (the
              other rank at a barrier; phase 15's int8 export moved
              here), moved to the card at load and served at
              EXPORT_BATCHES: equal to one process's live forward at the
              group's ranges, bit for bit; (c) Grad-CAM of CMDA-R50
              8x8 on one clip at 256², s4 and s3 (phase 16's), each K2 and
              K2-bwd call held against its plain version on its inputs,
              the scores within CMDA_BF16_ATOL of one process's, the CAMs
              by CMDA_TRAIN_BF16_RATIO against one process's float32
              plain path; (d) two injected one-clip windows of
              demo/Kinetics/SLOWFAST_8x8_R50.yaml fused (K1 on halo slabs,
              each call held) and int8 (K3, calibrated on the first
              window), the windows against one process's, only the master
              showing them. Prints ms a request, a Grad-CAM call and a
              window at 2 ranks beside one process's, each rank's peak
              memory, and K3's kernels' device ms in a traced
              +INT8_SPATIAL request on slabs beside one process's.

The depths were cut to make room for phase 16 within the time limit:
REQUESTS 3 → 2, TRAIN_STEPS 5 → 3, PROFILE_STEPS 3 → 2, FATIGUE_STEPS 4 →
3 (phase 14 traces its third step), PRECISE_BATCHES 2 → 1,
FRAME_LIST_STEPS 4 → 2; and for phase 18: TRAIN_WARMUP 2 → 1,
PROFILE_STEPS 2 → 1, DEMO_WINDOWS 3 → 2; and for phase 19: DIST_STEPS
3 → 2, FRAME_LIST_STEPS 2 → 1; and for phase 20: phase 15's int8 export
moved into phase 20, whose master writes it under the split (no width,
shape, gate or kernel hold changed).
After each phase block the smoke logs the seconds since its start.

The profiler (phases 6, 7, 8, 11, 12, 13, 16) prints, per traced window, the
device-busy share (the union of the CUDA kernels' intervals over the
window's wall time) and the top five kernels by device time; the trace
sits in build/smoke/profile_*/trace.json.

Each path runs with every kernel's launch count set to 0 just before it
and read just after; the kernels' JSON line sums the launches of phases
4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19 and 20 (its times and bounds are per
request of the SlowFast and CMDA serving paths and per CMDA train step,
phase 13's rows standing in where 3b or 3c did not run, and K3's per
request of the +INT8_SPATIAL SlowFast-R50, its ms and library_ms (cuDNN's
bf16 conv) device time from phase 15's profiler; its errors the worst on
any path). The last three lines are the kernels' JSON record, the card's name
and power limit, and the device JSON line.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
REQUESTS = 2
CLIPS_PER_REQUEST = 4
# the 30-view test batch: TEST.BATCH_SIZE of the Kinetics yamls (phase 8)
TEST_CLIPS = 64
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 FMA, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# float32: the kernel and the plain version differ only in summation order
# (K up to 3·2048); 1e-4 of the output's scale is ~100x that rounding.
F32_TOL = 1e-4
# bfloat16: the kernel rounds a and b to bf16 after their ReLU and c and the
# projection before the add, as the TPU kernel does; the plain version keeps
# float32 until the output. One bf16 rounding is 2^-9 = 0.2% relative; 2% of
# the output's scale allows for the few roundings that reach the output.
BF16_TOL = 2e-2
# serving, bf16: the fused engine folds BN into bf16 weights where the module
# runs conv and BN separately in bf16, so logits differ at bf16 rounding
# (~1%); class probabilities of the two paths then agree to within 2e-2.
SERVE_BF16_ATOL = 2e-2
# serving, float32, one clip: both paths are float32 throughout; folding BN
# and the kernel's summation order move the probabilities by far less.
SERVE_F32_ATOL = 1e-4
# attention, float32: the kernel and the plain version differ only in
# summation order (up to 128-term dot products, 32768-key softmax sums) and
# exp2 against exp, both within a few f32 ulps; 1e-4 of the output's scale.
ATTN_F32_TOL = 1e-4
# attention, bfloat16: both sides take float32 logits of the same bf16 q
# and k (exact products, sums in another order) and run the softmax in
# float32, but the kernel rounds each probability p_j to bf16 once before
# its tensor-core product with v, where the plain version keeps float32.
# The output is sum_j w_j v_j with w_j = p_j / sum_i p_i; the kernel takes
# the row sum from the unrounded probabilities, so each of its weights is
# w_j (1 + e_j) with |e_j| <= 2^-9, which moves the output by at most
# sum_j w_j |e_j| |v_j| <= 2^-9 max|v|. Each side then rounds its output to
# bf16 (half an ulp, at most 2^-8 of its magnitude), so the two differ by
# at most 2^-9 max|v| + 2^-7 of the output's scale: within 1e-2 of that
# scale while max|v| is within 1.1 times it, and in practice far inside,
# as the e_j have random signs and average out over the keys a row
# attends to. 1e-2 of the output's scale.
ATTN_BF16_TOL = 1e-2
# attention backward, float32: the kernels and the plain version compute the
# same sums in another order (up to 25088-term sums over keys or queries);
# 1e-4 of each gradient's scale.
ATTN_BWD_F32_TOL = 1e-4
# attention backward, bfloat16: both sides take float32 products of the same
# bf16 q, k, v and dO, the same float32 lse and D = rowsum(dO ∘ O) from the
# same bf16 O, and round each gradient to bf16 once (half an ulp: at most
# 2^-8 = 3.9e-3 of its magnitude). The kernel also rounds P and dS to bf16
# as the A operands of Pᵀ dO, dS k and dSᵀ q: each term of those sums is off
# by at most 2^-8 relative, and the errors have random signs, so a sum moves
# by about 2^-8 of its own magnitude, not of the sum of its terms' (the
# CPU emulator and the model in tests/test_torch_port_attention_backward.py
# put kernel against plain at 2-7e-3 of the scale). Held against autograd
# through chunked_attention, D is the unrounded O's: D moves by up to 2^-8
# Σ_c |dO_c O_c|, which enters dS as P δD; measured, it adds under 1.5e-3
# of the scale at D = C = 8-128. 2e-2 of each gradient's scale, five bf16
# roundings of room.
ATTN_BWD_BF16_TOL = 2e-2
# CMDA serving against its plain-attention path: bf16 attention outputs that
# differ by one ulp pass through the rest of the network in bf16, as K1's do
# (SERVE_BF16_ATOL); in float32 only the summation order differs. Both hold
# once the attention logits are calibrated (ATTN_LOGIT_STD).
CMDA_BF16_ATOL = 2e-2
CMDA_F32_ATOL = 1e-4
# The attention is unscaled (no 1/sqrt(D)). On random weights the standard
# deviation of its logits reaches the hundreds at s3_fuse and tens of
# thousands at s4_fuse, where the softmax is an argmax that one rounding
# upstream flips; a trained model's logits are of order 1-10. The
# query and key convs are scaled so that each fusion's logits have this
# standard deviation on a seeded clip.
ATTN_LOGIT_STD = 3.0
# I3D-NLN-R50's classifier on the same seeded weights: in eval mode the BN
# running statistics do not renormalise the residual sums, so its logits
# grow to a softmax that is one-hot in every clip (max p 1.000 in every
# request), where the probabilities, and the 30-view test's centred log
# probabilities (then set by the 1e-30 floor), no longer see a change of
# the non-local blocks. The projection is scaled so that the logits have
# this standard deviation on a seeded clip, as the attention logits are.
HEAD_LOGIT_STD = 3.0
# H100 SXM exponentials: 16 per clock per SM (the special-function unit's
# throughput for compute capability 9.0, CUDA C programming guide), 132 SMs
# at the 1.98 GHz maximum boost clock (NVIDIA data sheet)
EXP_RATE = 16 * 132 * 1.98e9
# the shapes beside the CMDA path: (label, N, M, D, C); the last three sit
# on the bf16 kernel's tile edges (N not a multiple of its 64- or 128-row
# blocks, M not of its 64-key tiles, D and C not multiples of 16 or 8)
# K1's shapes beside the SlowFast path, with no launch on it: (label, t_len,
# h, cin, ci, cout, kt, proj)
K1_OFF_PATH = [("slow s5 224 crop", 8, 7, 2048, 512, 2048, 3, False),
               ("fast s2 224 crop", 32, 56, 32, 8, 32, 3, False),
               ("proj c 40/12/48", 8, 20, 40, 12, 48, 3, True),
               ("ragged strip h 13", 8, 13, 256, 64, 256, 1, False)]
# the shapes beside the CMDA training path for the attention backward
ATTN_BWD_OFF_PATH = [("ragged keys", 1296, 1300, 8, 16),
                     ("ragged tiles", 2085, 1057, 32, 32),
                     ("d 24 c 24", 700, 333, 24, 24)]
# K2-bwd's two-pass kernel (PR 5) at the training batch, ms a call, in the
# two smoke runs that PERF.md records (NVIDIA H100 80GB HBM3, 700 W)
ATTN_BWD_PR5_MS = {"s1_fuse": "6.3493 / 6.4194", "s2_fuse": "8.9250 / 8.8969",
                   "s3_fuse": "1.0781 / 1.0813", "s4_fuse": "0.2682 / 0.2689"}
# training: clips a card (the reference configs train TRAIN.BATCH_SIZE 64
# over 8 GPUs), warm-up and timed steps
TRAIN_CLIPS = 8
TRAIN_WARMUP, TRAIN_STEPS = 1, 3
# steps traced by torch.profiler after the timed ones (phases 6 and 7)
PROFILE_STEPS = 1
# One CMDA train step on one clip with the attention kernels against the
# same step with the plain attention (FLASH_ATTENTION False).
# float32, per parameter tensor: |p_kernel - p_plain| over |p_plain -
# p_before| in L2, the step's difference over the step itself, where a
# tensor's step is below 1e-3 of the largest tensor's over that floor (the
# key conv's bias has a zero gradient in exact arithmetic, as a shift of
# every key by q·b cancels in the softmax, so its step is weight decay and
# rounding noise). The paths differ only in the attention's summation
# order (about 1e-6 relative: ATTN_F32_TOL, ATTN_BWD_F32_TOL), carried
# through the rest of the backward in float32; 1e-3.
CMDA_TRAIN_F32_TOL = 1e-3
# bfloat16: a tensor whose gradient is a sum that mostly cancels (a BN
# weight's over 25088 positions) takes a bf16 step that is mostly rounding
# noise, on either path, so tensor by tensor the two paths can differ by
# the step itself. What the kernels must not do is add error: over all
# parameters, the bf16 step with the kernels is held no farther from the
# float32 step (plain attention) than the bf16 step with the plain
# attention is, in L2, within twice: the kernels' own roundings (P once in
# the forward, P and dS once in the backward) are of the size of the plain
# path's (its output's and its gradients'), and two independent errors of
# one size make √2.
CMDA_TRAIN_BF16_RATIO = 2.0
# Running statistics: the step's new batch statistics enter with momentum
# 0.1; max |difference| within 1e-4 (f32) and 1e-2 (bf16) of max(1,
# max |statistic|).
CMDA_STATS_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the 30-view test and the epochs: loader threads (the yamls' NUM_WORKERS)
LOADER_WORKERS = 8
# every clip's bf16 probabilities: a softmax in float32 rounded to bf16 per
# class (2^-9 relative each) sums to 1 within 400 · 2^-9 · max p, and in
# practice within a few 1e-3 as the roundings have random signs; 1e-2.
TEST_ROW_TOL = 1e-2
# the 30-view test with the kernels against the same weights without them
# (SlowFast: fused engine vs module forward; CMDA: K2 vs plain attention),
# per video: the log of the mean probability less its mean over the
# classes (for one clip, the logits less theirs). The two paths differ by
# bf16 roundings (BN folded into bf16 weights and K1's roundings of a, b, c;
# K2's one rounding of P), each of order 2^-8 of a layer's activations with
# random signs, so over the ~50 layers of an R50 of order √50 · 2^-8 ≈ 3% of
# the logits' spread (phase 4 sees 2.7% of the largest probability on one
# request). A wrong block or attention moves the logits by their own
# spread. 0.1 of the largest |centred log mean probability|: three times
# the rounding estimate, a tenth of a fault.
TEST_LOGIT_TOL = 0.1
# the preprocess on the card against the CPU, float32: the same ops in the
# same order on both (gathers, one lerp per axis, the normalization), so
# only fused multiply-adds may differ, an ulp of values within ±3; 1e-5.
PRE_TOL = 1e-5
ATTN_OFF_PATH = [("ragged keys", 1296, 1300, 8, 16),
                 ("pooled non-local", 3136, 784, 64, 64),
                 ("ragged tiles", 2085, 1057, 32, 32),
                 ("d 4 c 24", 200, 333, 4, 24),
                 ("c 100", 1500, 777, 64, 100)]


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def kernel_counters():
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_backward)
    from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import \
        fused_bottleneck
    from efficient_slowfast_tpu_torch.ops.kernels.int8_conv import int8_conv

    return {"fused_bottleneck": fused_bottleneck,
            "flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward,
            "int8_conv": int8_conv}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def cuda_ms(fn, iters=10, reps=5):
    """Median over ``reps`` of the mean CUDA-event time of ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from efficient_slowfast_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    for name, out in reports.items():
        func = "?"
        for line in out.splitlines():
            entry = re.search(
                r"entry function '\w*?\d([a-z_]+kernel)(?:I(\w+?)EE|E)", line)
            if entry:  # e.g. flash_attention_tc_kernel<32,32>
                args = re.findall(r"__nv_bfloat16|^f|(?<=L[ib])\d+",
                                  entry.group(2) or "")
                func = entry.group(1) + "<" + ",".join(
                    {"__nv_bfloat16": "bf16", "f": "float"}.get(a, a)
                    for a in args) + ">"
            elif "registers" in line or "spill" in line or "error" in line:
                log("build", f"{name}: {func}: {line.split(':', 1)[-1].strip()}")
    log("build", f"built {sorted(reports) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    # cuobjdump ships beside nvcc in the CUDA toolkit
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass_counts(tool, _build.lib_path("flash_attention"))
    k1_sass_counts(tool, _build.lib_path("fused_bottleneck"))
    bwd_sass_counts(tool, _build.lib_path("flash_attention_bwd"))
    wide_sass_counts(tool, _build.lib_path("flash_attention"),
                     r"flash_attention_tc_wide_kernelILi(\d+)E", 3)
    wide_sass_counts(tool, _build.lib_path("flash_attention_bwd"),
                     r"attention_bwd_rows_kernelILi(\d+)ELb(\d)E", 4)
    k3_sass_counts(tool, _build.lib_path("int8_conv"))


def wide_sass_counts(tool, lib, pattern, expected):
    """Count the tensor-core instructions (mma.sync: HMMA) of the wide bf16
    kernels (D or C above 128) whose mangled names match ``pattern``,
    raising if any has none or if there are not ``expected`` of them."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = 0
    for func in sass.split("Function : ")[1:]:
        name = re.search(pattern, func.split("\n", 1)[0])
        if not name:
            continue
        found += 1
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         func)
        log("build", f"{os.path.basename(lib)} wide bf16 "
            f"{'/'.join(name.groups())}: HMMA {ops.count('HMMA')}, MUFU "
            f"{ops.count('MUFU')} in the SASS")
        if not ops.count("HMMA"):
            raise AssertionError(f"{lib}: a wide bf16 kernel uses no "
                                 "tensor-core instruction")
    if found != expected:
        raise AssertionError(f"{found} wide bf16 kernels in {lib}, expected "
                             f"{expected}")


def k3_sass_counts(tool, lib):
    """K3's SASS: every GEMM instantiation (conv_gemm_kernel<NWG, BN, out
    dtype>, as many as the library says it holds) must run integer wgmma
    (IGMMA), and the quantize pass (conv_quantize_kernel) must be there."""
    from efficient_slowfast_tpu_torch.ops.kernels import int8_conv as k3

    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    gemm, quantize = {}, 0
    for func in sass.split("Function : ")[1:]:
        head = func.split("\n", 1)[0]
        if "conv_quantize_kernel" in head:
            quantize += 1
            continue
        name = re.search(r"conv_gemm_kernelILi(\d)ELi(\d+)ELi(\d)E", head)
        if not name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         func)
        gemm["/".join(name.groups())] = (ops.count("IGMMA"), ops.count("IMMA"))
    expected = k3._lib().int8_conv_instantiations()
    log("build", f"int8_conv: {len(gemm)} GEMM kernels (NWG/BN/out dtype: "
        f"IGMMA, IMMA in the SASS) " + ", ".join(
            f"{k}: {v[0]}, {v[1]}" for k, v in sorted(gemm.items())) +
        f"; {quantize} quantize kernels")
    if len(gemm) != expected or not all(v[0] for v in gemm.values()) or \
            quantize != 2:
        raise AssertionError(
            f"{len(gemm)} K3 GEMM kernels (expected {expected}), IGMMA "
            f"counts {gemm}, {quantize} quantize kernels (expected 2): "
            "every GEMM instantiation must run integer wgmma")


SASS_OPS = ("HMMA", "HGMMA", "MUFU.EX2", "FFMA", "FADD", "FMUL", "FMNMX",
            "F2FP")


def sass_counts(tool, lib):
    """Count K2's tensor-core instructions in its SASS, raising if its bf16
    kernels have none; and, in the main loop of each D = C instantiation
    (the loop whose body holds the most MUFU.EX2: 32 logits and 2
    rescales per tile and warp lane), the FP32-pipe instructions per
    MUFU.EX2."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    total = dict.fromkeys(("HMMA", "HGMMA"), 0)
    for func in sass.split("Function : ")[1:]:
        shape = re.search(r"flash_attention_tc_kernelILi(\d+)ELi(\d+)E",
                          func.split("\n", 1)[0])
        if not shape:
            continue
        # (address, opcode and its first modifier, operands): "HMMA.16816"
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
            r"([A-Z0-9_]+(?:\.[A-Z0-9_]+)?)([^;]*);", func)]
        count = lambda ops: {op: sum(o == op or o.startswith(op + ".")
                                     for o in ops) for op in SASS_OPS}
        n = count([o for _, o, _ in ins])
        total["HMMA"] += n["HMMA"]
        total["HGMMA"] += n["HGMMA"]
        dp, cp = int(shape.group(1)), int(shape.group(2))
        if dp != cp:
            continue
        loops = [(int(t.group(1), 16), a) for a, o, rest in ins
                 if o.split(".")[0] == "BRA"
                 and (t := re.search(r"0x([0-9a-f]+)", rest))
                 and int(t.group(1), 16) < a]
        ex2_in = lambda span: sum(span[0] <= a <= span[1] and o == "MUFU.EX2"
                                  for a, o, _ in ins)
        lo, hi = max(loops, key=ex2_in, default=(0, ins[-1][0]))
        body = count([o for a, o, _ in ins if lo <= a <= hi])
        fp32 = sum(body[op] for op in ("FFMA", "FADD", "FMUL", "FMNMX",
                                       "F2FP"))
        log("build", f"flash_attention bf16 DP {dp} CP {cp} main loop: "
            + ", ".join(f"{op} {body[op]}" for op in SASS_OPS)
            + f"; FP32-pipe per MUFU.EX2 {fp32 / max(body['MUFU.EX2'], 1):.2f}")
    log("build", f"flash_attention bf16 kernels: HMMA {total['HMMA']}, "
        f"HGMMA {total['HGMMA']} in the SASS")
    if not total["HMMA"] + total["HGMMA"]:
        raise AssertionError("K2's bf16 kernels use no tensor-core "
                             "instruction (no HMMA or HGMMA in the SASS)")


def k1_sass_counts(tool, lib):
    """Count the tensor-core instructions of K1's bf16 kernels (one per
    kt, projection and warp tile), raising if any has none."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = 0
    for func in sass.split("Function : ")[1:]:
        name = re.search(r"fused_bottleneck_tc_kernelILi(\d)ELb(\d)ELi(\d)E",
                         func.split("\n", 1)[0])
        if not name:
            continue
        found += 1
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         func)
        hmma, hgmma = ops.count("HMMA"), ops.count("HGMMA")
        log("build", f"fused_bottleneck bf16 kt {name.group(1)} proj "
            f"{name.group(2)} m16 tiles {name.group(3)}: HMMA {hmma}, HGMMA "
            f"{hgmma} in the SASS")
        if not hmma + hgmma:
            raise AssertionError("K1's bf16 kernel uses no tensor-core "
                                 "instruction (no HMMA or HGMMA in the SASS)")
    if found != 8:
        raise AssertionError(f"{found} K1 bf16 kernels in the SASS, "
                             "expected 8")


def bwd_sass_counts(tool, lib):
    """Count the tensor-core instructions of K2-bwd's bf16 one-pass kernel
    (one instantiation per padded width, with its consumer warpgroups and
    blocks an SM), raising if any has no HGMMA (wgmma), and print the
    FP32-pipe and F2FP
    instructions per MUFU.EX2 of its main loop (the loop whose body holds
    the most MUFU.EX2: 32 per tile and thread)."""
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = 0
    for func in sass.split("Function : ")[1:]:
        name = re.search(
            r"attention_bwd_wgmma_kernelILi(\d+)ELi(\d)ELi(\d)E",
            func.split("\n", 1)[0])
        if not name:
            continue
        found += 1
        ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
            r"([A-Z0-9_]+(?:\.[A-Z0-9_]+)?)([^;]*);", func)]
        count = lambda ops: {op: sum(o == op or o.startswith(op + ".")
                                     for o in ops) for op in SASS_OPS}
        n = count([o for _, o, _ in ins])
        loops = [(int(t.group(1), 16), a) for a, o, rest in ins
                 if o.split(".")[0] == "BRA"
                 and (t := re.search(r"0x([0-9a-f]+)", rest))
                 and int(t.group(1), 16) < a]
        ex2_in = lambda span: sum(span[0] <= a <= span[1] and o == "MUFU.EX2"
                                  for a, o, _ in ins)
        lo, hi = max(loops, key=ex2_in, default=(0, ins[-1][0]))
        body = count([o for a, o, _ in ins if lo <= a <= hi])
        fp32 = sum(body[op] for op in ("FFMA", "FADD", "FMUL", "FMNMX",
                                       "F2FP"))
        ex2 = max(body["MUFU.EX2"], 1)
        log("build", f"flash_attention_backward bf16 WP {name.group(1)} "
            f"consumer warpgroups {name.group(2)}, {name.group(3)} blocks an "
            f"SM: HMMA {n['HMMA']}, HGMMA "
            f"{n['HGMMA']}, MUFU.EX2 {n['MUFU.EX2']}, F2FP {n['F2FP']} in "
            f"the SASS; main loop " + ", ".join(
                f"{op} {body[op]}" for op in SASS_OPS) +
            f"; FP32-pipe per MUFU.EX2 {fp32 / ex2:.2f}, F2FP per MUFU.EX2 "
            f"{body['F2FP'] / ex2:.2f}")
        if not n["HGMMA"]:
            raise AssertionError("K2-bwd's bf16 kernel uses no wgmma (no "
                                 "HGMMA in the SASS)")
    if found != 4:
        raise AssertionError(f"{found} K2-bwd bf16 kernels in the SASS, "
                             "expected 4")


# ---------------------------------------------------------------------------
def serving_cfg(dtype="bfloat16"):
    """SlowFast-R50 8x8 serving at the 30-view test shape (bench.py:121-149)."""
    from efficient_slowfast_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.MODEL_NAME = "SlowFast"
    cfg.MODEL.ARCH = "slowfast"
    cfg.RESNET.DEPTH = 50
    cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3, 3], [4, 4], [6, 6], [3, 3]]
    cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
    cfg.RESNET.SPATIAL_DILATIONS = [[1, 1]] * 4
    cfg.NONLOCAL.LOCATION = [[[], []]] * 4
    cfg.NONLOCAL.GROUP = [[1, 1]] * 4
    cfg.NONLOCAL.POOL = [[[1, 2, 2], [1, 2, 2]]] * 4
    cfg.SLOWFAST.ALPHA = 4
    cfg.SLOWFAST.BETA_INV = 8
    cfg.SLOWFAST.FUSION_KERNEL_SZ = 7
    cfg.MODEL.NUM_CLASSES = 400
    cfg.DATA.NUM_FRAMES = 32
    cfg.DATA.CROP_SIZE = 224
    cfg.DATA.TEST_CROP_SIZE = 256
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.FUSED_EVAL = True
    return cfg


def kernel_rows(cfg, model):
    """The stride-1 blocks of the serving forward, grouped by shape:
    [(label, t_len, h, cin, ci, cout, kt, proj, launches per request)]."""
    from efficient_slowfast_tpu_torch.engine.inference import STAGES

    blocks = []  # (pathway, stage, block index, shape key)
    strides = [s[0] for s in cfg.RESNET.SPATIAL_STRIDES]
    t_len = [cfg.DATA.NUM_FRAMES // cfg.SLOWFAST.ALPHA, cfg.DATA.NUM_FRAMES]
    for pw, name in enumerate(("slow", "fast")):
        h = cfg.DATA.TEST_CROP_SIZE // 4  # after the stem's two stride-2 ops
        for si, stage in enumerate(STAGES):
            h //= strides[si]
            i = 0
            while hasattr(getattr(model, stage), f"pathway{pw}_res{i}"):
                blk = getattr(getattr(model, stage), f"pathway{pw}_res{i}")
                br = blk.branch2
                if i > 0 or strides[si] == 1:  # strided block 0s are cuDNN's
                    blocks.append((name, stage, i, (
                        t_len[pw], h, br.a.in_channels, br.a.out_channels,
                        br.c.out_channels, br.a.kernel_size[0],
                        hasattr(blk, "branch1"))))
                i += 1
    rows = []
    for (name, stage, key), grp in itertools.groupby(
            blocks, key=lambda b: (b[0], b[1], b[3])):
        idx = [b[2] for b in grp]
        span = f"res{idx[0]}" + (f"-{idx[-1]}" if len(idx) > 1 else "")
        rows.append((f"{name} {stage} {span}",) + key + (len(idx),))
    return rows


def make_block(t_len, h, cin, ci, cout, kt, proj, clips, dtype, gen,
               card_gen=None):
    """Seeded inputs of one block: x and BN-folded weights (kernel layout).
    x is drawn on the card from ``card_gen`` where given (the test batch's
    activations run to gigabytes)."""
    dev = "cuda"
    rn = lambda *s: torch.randn(*s, generator=gen)
    x = (rn(clips * t_len, h, h, cin) if card_gen is None else torch.randn(
        clips * t_len, h, h, cin, generator=card_gen, device=dev)).to(dev, dtype)
    w = dict(wa=rn(kt, cin, ci) / (kt * cin) ** 0.5, ba=0.1 * rn(ci),
             wb=rn(3, 3, ci, ci) / (9 * ci) ** 0.5, bb=0.1 * rn(ci),
             wc=rn(ci, cout) / ci ** 0.5, bc=0.1 * rn(cout),
             wp=rn(cin, cout) / cin ** 0.5 if proj else None,
             bp=0.1 * rn(cout) if proj else None)
    w = {k: (None if v is None else
             v.to(dev, dtype if k.startswith("w") else torch.float32))
         for k, v in w.items()}
    return x, w


def block_cost(n, h, cin, ci, cout, kt, proj, elem):
    """(FLOPs, bytes) of one block: each input read once, out written once."""
    px = n * h * h
    wts = kt * cin * ci + 9 * ci * ci + ci * cout + (cin * cout if proj else 0)
    flops = 2 * px * wts
    nbytes = (px * (cin + cout) + wts) * elem + 4 * (2 * ci + cout * (2 if proj else 1))
    return flops, nbytes


def phase_kernels(cfg, model, smi, off_path=K1_OFF_PATH):
    from efficient_slowfast_tpu_torch.models.resnet import ResBlock
    from efficient_slowfast_tpu_torch.ops.kernels import _build
    from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import (
        bottleneck_reference, fused_bottleneck, plan, smem_bytes)

    gen = torch.Generator().manual_seed(SEED)
    rows = kernel_rows(cfg, model)
    per_request = sum(r[8] for r in rows)
    if per_request != 26:
        raise AssertionError(f"{per_request} stride-1 blocks, expected 26")
    lib = _build.load("fused_bottleneck")
    lib.fused_bottleneck_tc_smem_bytes.restype = ctypes.c_size_t
    lib.fused_bottleneck_tc_max_clusters.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_size_t]
    for ci, smem in ((64, 232448), (8, 115712)):  # the plan's two budgets
        log("kernels", f"K1 bf16 blocks resident at once, Ci {ci}, {smem} B "
            "a block, by cluster size: " + ", ".join(
                f"{cl}: {cl * lib.fused_bottleneck_tc_max_clusters(ci, cl, smem)}"
                for cl in (1, 2, 4, 8)))
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    record = []
    card_gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, t_len, h, cin, ci, cout, kt, proj, count in rows + [
            r + (0,) for r in off_path]:
        # the path's shapes also at the 30-view test batch (phase 8), in
        # its dtype: the plan picks each of those shapes' splits anew
        cases = [(dtype, tol, clips) for dtype, tol in (
            (torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL))
            for clips in (1, CLIPS_PER_REQUEST)]
        if count:
            cases.append((torch.bfloat16, BF16_TOL, TEST_CLIPS))
        for dtype, tol, clips in cases:
            x, w = make_block(t_len, h, cin, ci, cout, kt, proj, clips,
                              dtype, gen, card_gen if clips == TEST_CLIPS
                              else None)
            args = (x, t_len, w["wa"], w["ba"], w["wb"], w["bb"], w["wc"],
                    w["bc"], w["wp"], w["bp"])
            out = fused_bottleneck(*args)
            torch.cuda.synchronize()
            ref = bottleneck_reference(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            finite = bool(torch.isfinite(out).all())
            log("kernels", f"{label:18s} {str(dtype)[6:]:8s} clips {clips}"
                f" max_abs_err {err:.3e} (scale {scale:.3g}, tol "
                f"{tol * scale:.3e})")
            if not finite or err > tol * scale:
                raise AssertionError(f"{label} {dtype} clips {clips}: "
                                     f"err {err} > {tol * scale}")
            if clips == TEST_CLIPS:
                sp = plan(x.shape[0], h, h, cin, ci, cout, kt, 2, proj)
                log("kernels", f"{label:18s} bf16     clips {clips} split: "
                    f"cluster {sp.cluster}, strip rows {sp.rows}, CTAs "
                    f"{sp.ctas}, output pixels per CTA {sp.pixels}, shared "
                    f"memory {sp.smem} B (ring {sp.ring} B)")
            if clips != 1 and count:
                worst[dtype] = max(worst[dtype], err)
            del x, w, args, out, ref
        # timing at the request batch, in the serving dtype
        dtype = torch.bfloat16
        x, w = make_block(t_len, h, cin, ci, cout, kt, proj, CLIPS_PER_REQUEST,
                          dtype, gen)
        split = plan(x.shape[0], h, h, cin, ci, cout, kt, 2, proj)
        smem = lib.fused_bottleneck_tc_smem_bytes(h, h, ci, split.rows,
                                                  split.ring // 2)
        if smem != split.smem or smem != smem_bytes(2, h, h, ci, split.rows,
                                                    split.ring):
            raise AssertionError(f"{label}: shared memory {split.smem} B in "
                                 f"the wrapper, {smem} B in the kernel")
        resident = lib.fused_bottleneck_tc_max_clusters(ci, split.cluster,
                                                        split.smem)
        if resident <= 0:
            raise AssertionError(f"{label}: no cluster of the split fits "
                                 f"(CUDA error {-resident})")
        resident *= split.cluster  # blocks
        args = (x, t_len, w["wa"], w["ba"], w["wb"], w["bb"], w["wc"], w["bc"],
                w["wp"], w["bp"])
        k_ms = cuda_ms(lambda: fused_bottleneck(*args))
        p_ms = cuda_ms(lambda: bottleneck_reference(*args), iters=3, reps=3)
        blk = ResBlock(cin, cout, kt, 1, dim_inner=ci, dtype=dtype).to(
            "cuda", memory_format=torch.channels_last_3d).eval()
        xb = x.view(CLIPS_PER_REQUEST, t_len, h, h, cin).permute(0, 4, 1, 2, 3)
        with torch.inference_mode():
            lib_ms = cuda_ms(lambda: blk(xb))
        flops, nbytes = block_cost(x.shape[0], h, cin, ci, cout, kt, proj, 2)
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        log("kernels", f"{label:18s} bf16 x{count} per request | kernel "
            f"{k_ms:.4f} ms | plain {p_ms:.4f} ms | cuDNN unfused {lib_ms:.4f}"
            f" ms | kernel/bound {k_ms / bound:.2f}, kernel/cuDNN "
            f"{k_ms / lib_ms:.2f} | bound {bound:.5f} ms ({by}; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) | split: "
            f"cluster {split.cluster}, strip rows {split.rows}"
            f"{'' if h % split.rows == 0 else ' (ragged)'}, CTAs "
            f"{split.ctas} ({-(-split.ctas // resident)} wave(s) of "
            f"{resident} resident), output pixels per CTA {split.pixels}, "
            f"shared memory {split.smem} B (ring {split.ring} B) | {smi}")
        record.append(dict(label=label, count=count, ms=k_ms, plain_ms=p_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by,
                           flops=flops, bytes=nbytes))
    log("kernels", f"worst max_abs_err at the request and test batches: f32 "
        f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e}")
    return record, worst[torch.bfloat16]


# ---------------------------------------------------------------------------
def jax_layout_weights(cfg, model, seed):
    """Seeded weights in the JAX package's variable layout (numpy): MSRA
    fan-out normal convs, normal(0.01) classifier, BN scale 1 and bias 0,
    with running statistics jittered as the repo's engine tests do; for
    CMDA, ECA's Conv1d normal(1/sqrt(fan-in)) and every attention γ 0.5
    (at its zero init the attention would never reach the output)."""
    from efficient_slowfast_tpu_torch.utils.weights import \
        state_dict_to_jax_variables

    rs = np.random.RandomState(seed)
    shapes = state_dict_to_jax_variables(model.state_dict(), cfg)
    key = [0]

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel" and v.ndim == 5:  # DHWIO
                fan_out = int(np.prod(v.shape[:3])) * v.shape[4]
                out[k] = (rs.randn(*v.shape) * np.sqrt(2.0 / fan_out)).astype(
                    np.float32)
            elif k == "kernel" and v.ndim == 3:  # (k, I, O)
                out[k] = (rs.randn(*v.shape) / np.sqrt(v.shape[0] * v.shape[1])
                          ).astype(np.float32)
            elif k == "kernel":
                out[k] = (rs.randn(*v.shape) * 0.01).astype(np.float32)
            elif k == "gamma":
                out[k] = np.full(v.shape, 0.5, np.float32)
            elif k == "scale":
                out[k] = np.ones(v.shape, np.float32)
            elif k == "bias":
                out[k] = np.zeros(v.shape, np.float32)
            elif k == "mean":
                key[0] += 1
                out[k] = np.full(v.shape, 0.05 * (key[0] % 7 - 3), np.float32)
            elif k == "var":
                key[0] += 1
                out[k] = np.full(v.shape, 1.0 + 0.1 * (key[0] % 5), np.float32)
        return out

    return fill(shapes)


def serving_model(cfg, seed):
    from efficient_slowfast_tpu_torch.models import build_model
    from efficient_slowfast_tpu_torch.utils.weights import \
        jax_variables_to_state_dict

    model = build_model(cfg, device="cuda")
    variables = jax_layout_weights(cfg, model, seed)
    model.load_state_dict(jax_variables_to_state_dict(variables, cfg),
                          strict=True)
    return model.eval()


def clips(cfg, batch, gen, dtype):
    """Seeded clips at NUM_FRAMES and TEST_CROP_SIZE: [slow, fast], or one
    pathway for the single-pathway ResNets."""
    t, s, a = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE, cfg.SLOWFAST.ALPHA
    fast = torch.randn(batch, t, s, s, 3, generator=gen).to("cuda", dtype)
    if cfg.MODEL.MODEL_NAME == "ResNet":
        return [fast]
    return [torch.randn(batch, t // a, s, s, 3, generator=gen).to("cuda", dtype),
            fast]


def probabilities(cfg):
    """Whether the model's eval scores are probabilities: GhostNet's head
    takes the mean of ReLU(logits) (the reference's act reassigned,
    head_helper.py:665)."""
    return cfg.MODEL.MODEL_NAME != "SlowFastGhostNet"


def check_scores(out, batch, classes, what, probs=True):
    """Finite scores of shape (batch, classes); rows summing to 1 where they
    are probabilities, else non-negative (GhostNet)."""
    if out.shape != (batch, classes):
        raise AssertionError(f"{what}: shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite scores")
    if not probs:
        if out.min().item() < 0:
            raise AssertionError(f"{what}: negative scores")
        return
    row_err = (out.sum(-1) - 1).abs().max().item()
    if row_err > 1e-3:
        raise AssertionError(f"{what}: rows sum to 1 ± {row_err}")


def serve(fwd, requests):
    """Answer each request; (outputs, wall seconds) on the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for req in requests:
        outs.append(fwd(req))
        torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def serve_and_compare(phase, cfg, fwd, ref, names, expect, tol, seed, smi):
    """Answer REQUESTS requests of bf16 clips through ``fwd`` with every
    launch count set to 0 just before and read just after, check the counts
    against ``expect``, and hold the scores against those of ``ref`` (which
    launches no kernel) on the same requests, within ``tol`` of the scores'
    scale (max(1, max |score|): 1 for probabilities). ``names`` labels the
    two paths. Returns the counts of ``fwd``'s run and its seconds per
    request."""
    gen = torch.Generator().manual_seed(seed)
    requests = [clips(cfg, CLIPS_PER_REQUEST, gen, torch.bfloat16)
                for _ in range(REQUESTS)]
    serve(fwd, requests[:1])  # warm-up: cuDNN plans, allocator
    serve(ref, requests[:1])

    reset_counts()
    outs, dt = serve(fwd, requests)
    counts = read_counts()
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} for {REQUESTS} "
                             f"requests, expected {expect}")
    reset_counts()
    refs, dt_ref = serve(ref, requests)
    if any(read_counts().values()):
        raise AssertionError(f"the {names[1]} launched {read_counts()}")
    err, scale = 0.0, 1.0
    for i, (o, r) in enumerate(zip(outs, refs)):
        for out, name in ((o, names[0]), (r, names[1])):
            check_scores(out, CLIPS_PER_REQUEST, cfg.MODEL.NUM_CLASSES,
                         f"{name} request {i}", probabilities(cfg))
        err = max(err, (o - r).abs().max().item())
        scale = max(scale, r.abs().max().item())
    top1 = float(np.mean([(o.argmax(-1) == r.argmax(-1)).float().mean().item()
                          for o, r in zip(outs, refs)]))
    pmax = max(o.max().item() for o in outs)
    n_clips = REQUESTS * CLIPS_PER_REQUEST
    per_request = ", ".join(f"{n} {c // REQUESTS}" for n, c in counts.items())
    log(phase, f"bf16: {REQUESTS} requests x {CLIPS_PER_REQUEST} clips, "
        f"kernel launches {counts} (per request: {per_request})")
    log(phase, f"bf16: {names[0]} vs {names[1]} max |dp| {err:.3e} (tol "
        f"{tol * scale:.3e}: {tol} of the scale {scale:.4g}), top-1 "
        f"agreement {top1:.3f}, max p {pmax:.3f}")
    log(phase, f"bf16: {names[0]} {n_clips / dt:.2f} clips/s | {names[1]} "
        f"{n_clips / dt_ref:.2f} clips/s | {smi}")
    if err > tol * scale:
        raise AssertionError(f"{phase} bf16: {names[0]} vs {names[1]} {err}")
    return counts, dt / REQUESTS


def compare_one_clip(phase, cfg, fwd, ref, names, tol, seed, smi):
    """Hold ``fwd`` against ``ref`` on one seeded float32 clip, within
    ``tol`` of the scores' scale."""
    req = clips(cfg, 1, torch.Generator().manual_seed(seed), torch.float32)
    out, expected = fwd(req), ref(req)
    torch.cuda.synchronize()
    check_scores(out, 1, cfg.MODEL.NUM_CLASSES, f"{names[0]} f32",
                 probabilities(cfg))
    err = (out - expected).abs().max().item()
    scale = max(1.0, expected.abs().max().item())
    log(phase, f"f32, 1 clip: {names[0]} vs {names[1]} max |dp| {err:.3e} "
        f"(tol {tol * scale:.3e}: {tol} of the scale {scale:.4g}) | {smi}")
    if err > tol * scale:
        raise AssertionError(f"{phase} f32: {names[0]} vs {names[1]} {err}")


def phase_serving(cfg, model, k1_ms, smi):
    """k1_ms: K1's kernel time per request (phase 3)."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    cfg_module = cfg.clone()
    cfg_module.TPU.FUSED_EVAL = False
    counts, request_s = serve_and_compare(
        "serving", cfg, make_forward(cfg, model),
        make_forward(cfg_module, model), ("fused engine", "module forward"),
        {"fused_bottleneck": 26 * REQUESTS, "flash_attention": 0,
         "flash_attention_backward": 0, "int8_conv": 0},
        SERVE_BF16_ATOL, SEED + 1, smi)
    log("serving", f"bf16: fused engine {request_s * 1e3:.2f} ms per request,"
        f" of which K1's 26 launches {k1_ms:.2f} ms (phase 3); the rest "
        f"{request_s * 1e3 - k1_ms:.2f} ms | {smi}")
    return counts["fused_bottleneck"]


def phase_serving_f32(smi):
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    cfg = serving_cfg("float32")
    model = serving_model(cfg, SEED)
    cfg_module = cfg.clone()
    cfg_module.TPU.FUSED_EVAL = False
    compare_one_clip("serving", cfg, make_forward(cfg, model),
                     make_forward(cfg_module, model),
                     ("fused engine", "module forward"), SERVE_F32_ATOL,
                     SEED + 2, smi)


# ---------------------------------------------------------------------------
def cmda_cfg(dtype="bfloat16", flash=True):
    """SlowFastDualAttention-R50 8x8 serving at the 30-view test shape, the
    shapes of configs/Kinetics/SLOWFAST_DUALATTENTION_8x8_R50.yaml (the
    module forward serves it: the fused engine does not cover CMDA)."""
    cfg = serving_cfg(dtype)
    cfg.MODEL.MODEL_NAME = "SlowFastDualAttention"
    cfg.TPU.FUSED_EVAL = False
    cfg.TPU.FLASH_ATTENTION = flash
    return cfg


def fusions(model):
    """The CMDA fusions' SpatialAttention modules in the forward's order:
    [(fusion name, module)]."""
    return [(n[:-len(".attention_spatial_s2f")], m)
            for n, m in model.named_modules()
            if n.endswith(".attention_spatial_s2f")]


def calibrate_attention(cfg, model, seed, phase="cmda", run=None):
    """Scale each fusion's query and key convs (weight and bias, by one
    factor each) so that its logits have ATTN_LOGIT_STD on a seeded clip
    (or in the forward that ``run()`` makes), fusion by fusion, as each
    scale moves the fusions after it."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    if run is None:
        fwd = make_forward(cfg, model)
        req = clips(cfg, 1, torch.Generator().manual_seed(seed),
                    torch.float32)
        run = lambda: fwd(req)  # noqa: E731
    stds = []
    for _, att in fusions(model):
        seen = {}
        hook = att.register_forward_hook(
            lambda m, inp, out: seen.update(x=inp[0]))
        run()
        hook.remove()
        with torch.inference_mode():
            q = att.query_conv(seen["x"]).flatten(2).float()  # (1, D, N)
            k = att.key_conv(seen["x"]).flatten(2).float()
            std = torch.einsum("bdn,bdm->bnm", q[:, :, ::64], k).std().item()
            f = (ATTN_LOGIT_STD / std) ** 0.5
            for conv in (att.query_conv, att.key_conv):
                conv.weight.mul_(f)
                conv.bias.mul_(f)
        stds.append(std)
    log(phase, "attention logit std before calibration, " + ", ".join(
        f"{n} {x:.4g}" for (n, _), x in zip(fusions(model), stds))
        + f" -> {ATTN_LOGIT_STD}")


def attention_rows(cfg, model, frames=None, crop=None):
    """The SpatialAttention of each lateral fusion of one forward at
    NUM_FRAMES and TEST_CROP_SIZE (or ``frames`` and ``crop``):
    [(label, N, M, D, C, launches per request)]."""
    frames = frames or cfg.DATA.NUM_FRAMES
    crop = crop or cfg.DATA.TEST_CROP_SIZE
    t_len = frames // cfg.SLOWFAST.ALPHA
    # the stem's two stride-2 ops and each stride-2 stage round up (158 → 40)
    h = -(-crop // 4)
    strides = [1] + [s[0] for s in cfg.RESNET.SPATIAL_STRIDES]
    tag = "" if (frames, crop) == (cfg.DATA.NUM_FRAMES,
                                   cfg.DATA.TEST_CROP_SIZE) else \
        f"T{frames} S{crop} "
    rows = []
    for i in range(4):
        h = -(-h // strides[i])
        att = getattr(model, f"s{i + 1}_fuse").attention_spatial_s2f
        n = t_len * h * h
        rows.append((f"{tag}s{i + 1}_fuse", n, n,
                     att.query_conv.out_channels,
                     att.value_conv.out_channels, 1))
    return rows


def sdpa_backend(q, k, v):
    """The backend that scaled_dot_product_attention picks for these
    (B, 1, N, D) inputs at scale 1 (PyTorch's own dispatch: its flash
    backend stops at D = 256)."""
    from torch.nn.attention import SDPBackend

    choice = torch._fused_sdp_choice(q, k, v, None, 0.0, False, scale=1.0)
    return SDPBackend(choice).name.lower()


def attention_cost(b, n, m, d, c):
    """(FLOPs, bf16 bytes, exponentials) of one call: q, k, v read once and
    out written once."""
    return (2 * b * n * m * (d + c), 2 * b * (n * d + m * d + m * c + n * c),
            b * n * m)


def logit_scale(d, logit_std):
    """The factor for q and k (each) that gives unit-normal q and k of
    width ``d`` logits of std ``logit_std`` (1 where None)."""
    return (logit_std / d ** 0.5) ** 0.5 if logit_std else 1.0


def phase_attention(rows, smi, recipe_rows=(), off_path=ATTN_OFF_PATH,
                    path_batch=None, logit_std=None):
    """K2 against its plain version at the serving rows, the ``off_path``
    shapes and ``recipe_rows`` (phase 10's shapes, each with its largest
    batch); returns (per-shape record, worst bf16 error on the path, the
    largest bf16 batch held at each (N, M, D, C)). With ``path_batch``
    (phase 11's rows, each carrying its path's batch as its last entry,
    the off-path shapes taking ``path_batch``) it holds float32 and bf16 at
    1 clip and at that batch and times there; a row's second batch (phase
    14's training batch) is held in bf16 too. With ``logit_std`` q and k
    are scaled so that the logits have that std (at D = 2 unit normals give
    std 1.4, a softmax so flat that a wrong key weight would hardly move
    the output)."""
    import torch.nn.functional as F

    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import (
        chunked_attention, flash_attention)

    gen = torch.Generator().manual_seed(SEED + 3)
    card_gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rn = lambda *shape, dtype: torch.randn(*shape, generator=gen).to(
        "cuda", dtype)
    rn_card = lambda *shape, dtype: torch.randn(
        *shape, generator=card_gen, device="cuda").to(dtype)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_recipe = 0.0
    record, held = [], {}
    extra_rows = [r + (0,) + ((path_batch,) if path_batch else ())
                  for r in off_path]
    for label, n, m, d, c, count, *big in (
            rows + extra_rows + list(recipe_rows)):
        time_b = big[0] if path_batch else CLIPS_PER_REQUEST
        # the path's shapes also at the 30-view test batch (phase 8), and
        # phase 10's at their largest batch, in bf16
        cases = [(dtype, tol, b) for dtype, tol in (
            (torch.float32, ATTN_F32_TOL), (torch.bfloat16, ATTN_BF16_TOL))
            for b in (1, time_b)]
        extra = big[-1] if big else (TEST_CLIPS if count else None)
        if extra and extra not in (1, time_b):
            cases.append((torch.bfloat16, ATTN_BF16_TOL, extra))
        for dtype, tol, b in cases:
            draw = rn_card if b > CLIPS_PER_REQUEST else rn
            f = logit_scale(d, logit_std)
            q, k, v = (draw(b, n, d, dtype=dtype) * f,
                       draw(b, m, d, dtype=dtype) * f,
                       draw(b, m, c, dtype=dtype))
            out = flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = chunked_attention(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = max(1.0, ref.float().abs().max().item())
            finite = bool(torch.isfinite(out).all())
            log("attention", f"{label:16s} {str(dtype)[6:]:8s} clips {b} "
                f"max_abs_err {err:.3e} (scale {scale:.3g}, tol "
                f"{tol * scale:.3e})")
            if out.dtype != dtype or not finite or err > tol * scale:
                raise AssertionError(f"{label} {dtype} clips {b}: "
                                     f"err {err} > {tol * scale}")
            if b != 1 and count:
                worst[dtype] = max(worst[dtype], err)
            if big and dtype == torch.bfloat16:
                worst_recipe = max(worst_recipe, err)
            if dtype == torch.bfloat16:
                held[(n, m, d, c)] = max(held.get((n, m, d, c), 0), b)
            del q, k, v, out, ref
        torch.cuda.empty_cache()
        # timing at the request batch (phase 11: the path's), in bf16
        b, dtype = time_b, torch.bfloat16
        draw = rn_card if b > CLIPS_PER_REQUEST else rn
        f = logit_scale(d, logit_std)
        q, k, v = (draw(b, n, d, dtype=dtype) * f,
                   draw(b, m, d, dtype=dtype) * f,
                   draw(b, m, c, dtype=dtype))
        big = b * n * m > 2 ** 30  # the 32768-token rows: few repetitions
        k_ms = cuda_ms(lambda: flash_attention(q, k, v),
                       iters=2 if big else 10, reps=3 if big else 5)
        p_ms = cuda_ms(lambda: chunked_attention(q, k, v), iters=1, reps=3)
        backend = sdpa_backend(q[:, None], k[:, None], v[:, None])
        lib_ms = None  # SDPA's math backend would hold the whole b·n·m
        if backend != "math" or b * n * m * 4 < 2 ** 34:
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], scale=1.0),
                iters=2 if big else 10, reps=3 if big else 5)
        lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        ratio = "n/a" if lib_ms is None else f"{k_ms / lib_ms:.2f}"
        flops, nbytes, exps = attention_cost(b, n, m, d, c)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_exp = exps / EXP_RATE * 1e3
        bound = max(t_ops, t_bytes, t_exp)
        by = "bytes" if t_bytes == bound else "operations"
        log("attention", f"{label:16s} bf16 N {n} M {m} D {d} C {c} x{count}"
            f" per request, {b} clips | kernel {k_ms:.4f} ms | plain "
            f"{p_ms:.4f} ms | sdpa ({backend}) {lib_txt} | "
            f"kernel/bound {k_ms / bound:.2f}, "
            f"kernel/sdpa {ratio} | bound {bound:.5f} ms ({by}; tensor "
            f"cores {t_ops:.5f} ms for {flops / 1e9:.3f} GFLOP, exp "
            f"{t_exp:.5f} ms for {exps:.3e}, memory {t_bytes:.5f} ms for "
            f"{nbytes / 1e6:.3f} MB) | {smi}")
        record.append(dict(label=label, count=count, ms=k_ms, plain_ms=p_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by))
        del q, k, v
        torch.cuda.empty_cache()
    log("attention", f"worst max_abs_err at the path's batches: "
        f"f32 {worst[torch.float32]:.3e}, bf16 "
        f"{worst[torch.bfloat16]:.3e}; bf16 at phase 10's {len(recipe_rows)} "
        f"multigrid shapes: {worst_recipe:.3e}")
    return record, max(worst[torch.bfloat16], worst_recipe), held


def model_with(cfg, state):
    """The model of ``cfg`` in eval mode with the weights ``state``."""
    from efficient_slowfast_tpu_torch.models import build_model

    model = build_model(cfg, device="cuda")
    model.load_state_dict(state, strict=True)
    return model.eval()


def phase_cmda(cfg, model, smi):
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    cfg_plain = cmda_cfg(flash=False)
    counts, _ = serve_and_compare(
        "cmda", cfg, make_forward(cfg, model),
        make_forward(cfg_plain, model_with(cfg_plain, model.state_dict())),
        ("flash kernel", "plain attention"),
        {"fused_bottleneck": 0, "flash_attention": 4 * REQUESTS,
         "flash_attention_backward": 0, "int8_conv": 0},
        CMDA_BF16_ATOL, SEED + 4, smi)
    return counts["flash_attention"]


def phase_cmda_f32(state, smi):
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    cfg, cfg_plain = cmda_cfg("float32"), cmda_cfg("float32", flash=False)
    compare_one_clip("cmda", cfg, make_forward(cfg, model_with(cfg, state)),
                     make_forward(cfg_plain, model_with(cfg_plain, state)),
                     ("flash kernel", "plain attention"), CMDA_F32_ATOL,
                     SEED + 5, smi)


def attention_backward_cost(b, n, m, d, c):
    """(FLOPs, bytes, exponentials) of one backward call: the five products
    2 N M (3D + 2C) per clip; q, k, v, out and dO read once and dq, dk, dv
    written once in bf16, lse read once in float32."""
    return (2 * b * n * m * (3 * d + 2 * c),
            2 * b * 2 * (n * d + m * d + m * c + n * c) + 4 * b * n,
            b * n * m)


def phase_attention_backward(rows, smi, recipe_rows=(),
                             off_path=ATTN_BWD_OFF_PATH, batch=TRAIN_CLIPS,
                             logit_std=None):
    """K2-bwd against attention_backward at the training shapes ``rows``,
    off-path shapes and ``recipe_rows`` (phase 10's training shapes, each
    with its largest batch, in bf16); returns (per-shape record, worst bf16
    error on the path at the training batch, the largest bf16 batch held at
    each (N, M, D, C)). ``batch`` is the training batch it holds and
    times at; ``logit_std`` scales q and k as phase_attention does."""
    import torch.nn.functional as F

    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import (
        _forward, attention_backward, backward_split, chunked_attention,
        flash_attention_backward)

    gen = torch.Generator().manual_seed(SEED + 7)
    rn = lambda *shape, dtype: torch.randn(*shape, generator=gen).to(
        "cuda", dtype)
    smallest = min(r[1] for r in rows)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_recipe = 0.0
    record, held = [], {}
    for label, n, m, d, c, count, *big in (
            rows + [r + (0,) for r in off_path] + list(recipe_rows)):
        for dtype, tol in ((torch.float32, ATTN_BWD_F32_TOL),
                           (torch.bfloat16, ATTN_BWD_BF16_TOL)):
            batches = [1, batch]
            if big and dtype == torch.bfloat16 and big[0] not in batches:
                batches.append(big[0])
            for b in batches:
                f = logit_scale(d, logit_std)
                q, k, v, dout = (rn(b, n, d, dtype=dtype) * f,
                                 rn(b, m, d, dtype=dtype) * f,
                                 rn(b, m, c, dtype=dtype),
                                 rn(b, n, c, dtype=dtype))
                out, lse = _forward(q, k, v, with_lse=True)
                if not torch.equal(out, _forward(q, k, v, False)[0]):
                    raise AssertionError(f"{label} {dtype} clips {b}: K2's "
                                         "output moved with its lse store")
                grads = flash_attention_backward(q, k, v, out, lse, dout)
                again = flash_attention_backward(q, k, v, out, lse, dout)
                torch.cuda.synchronize()
                # dK and dV are sums in a fixed order; bf16 dQ is summed
                # over key blocks by float32 atomic adds in any order
                exact = [torch.equal(g, a) for g, a in zip(grads, again)]
                dq_moved = (grads[0].float() - again[0].float()).abs().max(
                    ).item()
                if not all(exact[1:]) or (dtype == torch.float32
                                          and not exact[0]):
                    raise AssertionError(f"{label} {dtype} clips {b}: two "
                                         "calls differ (dq/dk/dv "
                                         f"bit-identical {exact})")
                dq_scale = max(1.0, grads[0].float().abs().max().item())
                if dq_moved > tol * dq_scale:
                    raise AssertionError(f"{label} {dtype} clips {b}: dq "
                                         f"moved {dq_moved} between calls")
                del again
                refs = [("plain", attention_backward(q, k, v, out, lse,
                                                     dout))]
                if not big and b == 1 and n == smallest:
                    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                    refs.append(("autograd", torch.autograd.grad(
                        chunked_attention(*leaves), leaves, dout)))
                torch.cuda.synchronize()
                for name, ref in refs:
                    errs = []
                    for g, r in zip(grads, ref):
                        err = (g.float() - r.float()).abs().max().item()
                        scale = max(1.0, r.float().abs().max().item())
                        if (g.dtype != dtype or not bool(
                                torch.isfinite(g).all()) or err > tol * scale):
                            raise AssertionError(
                                f"{label} {dtype} clips {b} vs {name}: "
                                f"err {err} > {tol * scale}")
                        errs.append((err, scale))
                        if b == batch and count:
                            worst[dtype] = max(worst[dtype], err)
                        if big and dtype == torch.bfloat16:
                            worst_recipe = max(worst_recipe, err)
                    log("attention_backward",
                        f"{label:16s} {str(dtype)[6:]:8s} clips {b} vs "
                        f"{name}: max_abs_err dq/dk/dv " +
                        " / ".join(f"{e:.3e} (scale {s_:.3g})"
                                   for e, s_ in errs) + f", tol {tol} of "
                        "the scale; K2's output bit-identical with its lse "
                        "store on and off; a second call: dk, dv "
                        f"bit-identical, dq {'bit-identical' if exact[0] else f'moved {dq_moved:.3e}'}")
                if dtype == torch.bfloat16:
                    held[(n, m, d, c)] = max(held.get((n, m, d, c), 0), b)
                del q, k, v, dout, out, lse, grads, refs
        # timing at the training batch, in the training dtype
        b, dtype = batch, torch.bfloat16
        f = logit_scale(d, logit_std)
        q, k, v, dout = (rn(b, n, d, dtype=dtype) * f,
                         rn(b, m, d, dtype=dtype) * f,
                         rn(b, m, c, dtype=dtype), rn(b, n, c, dtype=dtype))
        out, lse = _forward(q, k, v, with_lse=True)
        big = b * n * m > 2 ** 30
        reps = dict(iters=2 if big else 10, reps=3 if big else 5)
        k_ms = cuda_ms(lambda: flash_attention_backward(q, k, v, out, lse,
                                                        dout), **reps)
        p_ms = cuda_ms(lambda: attention_backward(q, k, v, out, lse, dout),
                       iters=1, reps=3)
        q4, k4, v4 = (t[:, None].detach().requires_grad_()
                      for t in (q, k, v))
        backend = sdpa_backend(q4, k4, v4)
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), dout[:, None], retain_graph=True), **reps)
        del o4
        flops, nbytes, exps = attention_backward_cost(b, n, m, d, c)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_exp = exps / EXP_RATE * 1e3
        bound = max(t_ops, t_bytes, t_exp)
        by = "bytes" if t_bytes == bound else "operations"
        split = backward_split(b, n, m, d, c)
        log("attention_backward", f"{label:16s} bf16 N {n} M {m} D {d} C {c}"
            f" x{count} per train step | kernels {k_ms:.4f} ms (PR 5 "
            f"two-pass: {ATTN_BWD_PR5_MS.get(label, 'not measured')}) | "
            f"plain {p_ms:.4f} ms | sdpa ({backend}) backward {lib_ms:.4f} "
            "ms | "
            f"kernels/bound {k_ms / bound:.2f}, kernels/sdpa "
            f"{k_ms / lib_ms:.2f} | bound "
            f"{bound:.5f} ms ({by}; tensor cores {t_ops:.5f} ms for "
            f"{flops / 1e9:.3f} GFLOP, exp {t_exp:.5f} ms for {exps:.3e}, "
            f"memory {t_bytes:.5f} ms for {nbytes / 1e6:.3f} MB) | split: "
            f"Bc {split['keys']} keys, Br {split['queries']} queries, "
            f"{split['stages']} stages, {split['blocks']} CTAs "
            f"({split['per_sm']} an SM), {split['smem']} B shared memory, "
            f"width {split['width']}, {split['slices']} column slices | "
            f"{smi}")
        record.append(dict(label=label, count=count, ms=k_ms, plain_ms=p_ms,
                           library_ms=lib_ms, bound_ms=bound, bound_by=by))
        del q, k, v, dout, out, lse, q4, k4, v4
        torch.cuda.empty_cache()
    log("attention_backward", f"worst max_abs_err at the training batch on "
        f"the path: f32 {worst[torch.float32]:.3e}, bf16 "
        f"{worst[torch.bfloat16]:.3e}; bf16 at phase 10's "
        f"{len(recipe_rows)} multigrid training shapes: {worst_recipe:.3e}")
    return record, max(worst[torch.bfloat16], worst_recipe), held


# ---------------------------------------------------------------------------
def train_cfg(model_name="SlowFast", dtype="bfloat16", flash=True):
    """SlowFast-R50 8x8 (or CMDA-R50) trained as
    configs/Kinetics/SLOWFAST_8x8_R50.yaml (and
    SLOWFAST_DUALATTENTION_8x8_R50.yaml) train it: the 224² crop (the
    inputs are made at the test crop, set to it), final BNs
    zero-initialised, SGD lr 0.1 with nesterov momentum 0.9, weight decay
    1e-4 and none on BN, dropout 0.5."""
    cfg = serving_cfg(dtype)
    cfg.MODEL.MODEL_NAME = model_name
    cfg.DATA.TEST_CROP_SIZE = cfg.DATA.CROP_SIZE
    cfg.TPU.FUSED_EVAL = False
    cfg.TPU.FLASH_ATTENTION = flash
    cfg.RESNET.ZERO_INIT_FINAL_BN = True
    cfg.MODEL.DROPOUT_RATE = 0.5
    cfg.SOLVER.BASE_LR = 0.1
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.NESTEROV = True
    cfg.SOLVER.WEIGHT_DECAY = 1e-4
    cfg.BN.WEIGHT_DECAY = 0.0
    return cfg


def train_model(cfg, seed):
    """``serving_model``'s seeded weights with each block's final BN
    zero-initialised, as the model is built for training."""
    model = serving_model(cfg, seed)
    with torch.no_grad():
        for m in model.modules():
            if getattr(m, "zero_init_gamma", False):
                m.weight.zero_()
    return model


def train_batches(cfg, count, batch, seed, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    return [(clips(cfg, batch, gen, dtype),
             torch.randint(0, cfg.MODEL.NUM_CLASSES, (batch,),
                           generator=gen).cuda()) for _ in range(count)]


def watched_bn(model):
    """(name, module) of the BN whose running mean the train phases watch:
    the ResNets' s2 res0 a_bn, else the first BN of s2 (the efficient
    families)."""
    from efficient_slowfast_tpu_torch.ops.norm import BatchNorm3d

    for name, m in model.named_modules():
        if name == "s2.pathway0_res0.branch2.a_bn":
            return name, m
    return next((n, m) for n, m in model.named_modules()
                if n.startswith("s2.") and isinstance(m, BatchNorm3d))


def train_steps(phase, cfg, model, expect, smi, batch=TRAIN_CLIPS):
    """TRAIN_WARMUP then TRAIN_STEPS steps of ``batch`` bf16 clips through
    create_train_state and make_train_step, every launch count set to 0
    just before the timed steps and read just after; checks the counts
    against ``expect``, the losses and that the running statistics moved.
    Returns (state, step, counts)."""
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)

    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state.model, state.optimizer)
    batches = train_batches(cfg, TRAIN_WARMUP + TRAIN_STEPS, batch,
                            SEED + 8)
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    lr = cfg.SOLVER.BASE_LR
    bn_name, bn = watched_bn(model)
    before = bn.running_mean.clone()
    for x, y in batches[:TRAIN_WARMUP]:
        step(state, x, y, lr, drop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    mets = [step(state, x, y, lr, drop) for x, y in batches[TRAIN_WARMUP:]]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack([m["loss"] for m in mets]).tolist()
    moved = (bn.running_mean - before).abs().max().item()
    log(phase, f"bf16, {batch} clips a step: {TRAIN_STEPS} steps "
        f"after {TRAIN_WARMUP} warm-up | losses " +
        ", ".join(f"{x:.4f}" for x in losses) + f" | top1_err "
        f"{mets[-1]['top1_err'].item():.1f} | kernel launches {counts} | "
        f"running mean of {bn_name} moved {moved:.3e}")
    log(phase, f"bf16: {batch / dt:.2f} train clips/s, {dt * 1e3:.2f} "
        f"ms per step, peak memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated) | {smi}")
    if counts != expect:
        raise AssertionError(f"{phase}: kernel launches {counts} for "
                             f"{TRAIN_STEPS} steps, expected {expect}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss {losses}")
    if not moved > 0:
        raise AssertionError(f"{phase}: BN running statistics did not move")
    share, window_ms, _, _ = trace_window(phase, lambda: [
        step(state, x, y, lr, drop)
        for x, y in batches[TRAIN_WARMUP:TRAIN_WARMUP + PROFILE_STEPS]])
    untraced = PROFILE_STEPS * dt * 1e3
    log(phase, f"profiled {PROFILE_STEPS} more steps: {window_ms:.2f} ms "
        f"traced (the tracer's host cost included) against {untraced:.2f} ms"
        f" for as many timed steps untraced; the kernels' union in the trace "
        f"{share * window_ms:.2f} ms, {share * window_ms / untraced * 100:.1f}%"
        f" of the untraced steps' time | {smi}")
    return state, step, counts, batch / dt


def phase_train(smi):
    """SlowFast-R50 training; then one step with stage remat on s2."""
    from efficient_slowfast_tpu_torch.models.slowfast import remat_stage

    cfg = train_cfg()
    model = train_model(cfg, SEED)
    state, step, _, _ = train_steps(
        "train", cfg, model, {"fused_bottleneck": 0, "flash_attention": 0,
                              "flash_attention_backward": 0, "int8_conv": 0}, smi)
    remat = cfg.clone()
    remat.TPU.REMAT = True
    remat.TPU.REMAT_STAGES = [2]
    for idx, name in enumerate(("s2", "s3", "s4", "s5")):
        getattr(model, name).remat = remat_stage(remat, idx)
    (x0, y0), (x, y) = train_batches(cfg, 2, TRAIN_CLIPS, SEED + 10)
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    step(state, x0, y0, cfg.SOLVER.BASE_LR, drop)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = step(state, x, y, cfg.SOLVER.BASE_LR, drop)["loss"].item()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log("train", f"bf16, TPU.REMAT True, TPU.REMAT_STAGES [2]: one step "
        f"after one warm-up {dt * 1e3:.2f} ms, loss {loss:.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {smi}")
    if not np.isfinite(loss):
        raise AssertionError(f"train with remat: non-finite loss {loss}")


def one_step(cfg, state_dict, batch, seed, with_loss=False):
    """The model of ``cfg`` loaded with ``state_dict``, after one train
    step on ``batch``: {name: tensor} of its parameters and buffers (and
    with ``with_loss`` the step's loss)."""
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)

    model = model_with(cfg, state_dict)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state.model, state.optimizer)
    mets = step(state, *batch, cfg.SOLVER.BASE_LR,
                torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    after = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return (after, mets["loss"].item()) if with_loss else after


def hold_one_clip_steps(phase, cfg_of, state_dict, smi, batch_of=None,
                        one=None):
    """One train step of one clip from ``state_dict`` in float32 and in
    bfloat16 (``cfg_of(dtype name, flash)``), each with the attention
    kernels against the same step with the plain attention
    (TPU.FLASH_ATTENTION False), held to CMDA_TRAIN_F32_TOL,
    CMDA_TRAIN_BF16_RATIO and CMDA_STATS_TOL: the two paths differ only in
    the attention, whatever model carries it. ``batch_of(cfg, dtype)``
    and ``one`` (``one_step``'s arguments) give another step's batch and
    step (detection's)."""
    one = one or one_step
    stats = [k for k in state_dict
             if k.endswith(("running_mean", "running_var"))]
    params = [k for k in state_dict if k not in stats
              and not k.endswith("num_batches_tracked")]
    dist = lambda a, b: sum((a[k].double() - b[k].double()).norm().item() ** 2
                            for k in params) ** 0.5
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        batch = (train_batches(cfg_of(name, True), 1, 1, SEED + 11, dtype)[0]
                 if batch_of is None else batch_of(cfg_of(name, True), dtype))
        after = {flash: one(cfg_of(name, flash), state_dict, batch, SEED)
                 for flash in (True, False)}
        if dtype == torch.float32:
            ref = after[False]  # the float32 step, plain attention
        steps = {k: (after[False][k].double() - state_dict[k].double()
                     ).norm().item() for k in params}
        floor = 1e-3 * max(steps.values())
        worst_p, where_p = max(
            ((after[True][k].double() - after[False][k].double()).norm()
             .item() / max(steps[k], floor), k) for k in params)
        worst_s, where_s = max(
            ((after[True][k] - after[False][k]).abs().max().item() / max(
                1.0, after[False][k].abs().max().item()), k) for k in stats)
        step = dist(ref, state_dict)
        e_kernel, e_plain = dist(after[True], ref), dist(after[False], ref)
        log(phase, f"{name}, 1 clip, one step: attention kernels vs "
            f"plain attention: worst |dp| / |step| {worst_p:.3e} ({where_p}),"
            f" worst running statistic {worst_s:.3e} ({where_s}; tol "
            f"{CMDA_STATS_TOL[dtype]}); all parameters, distance from the f32 "
            f"plain step over that step: kernels {e_kernel / step:.3e}, plain "
            f"{e_plain / step:.3e}, kernels vs plain "
            f"{dist(after[True], after[False]) / step:.3e} | {smi}")
        bad = (worst_p > CMDA_TRAIN_F32_TOL if dtype == torch.float32
               else e_kernel > CMDA_TRAIN_BF16_RATIO * e_plain)
        if bad or worst_s > CMDA_STATS_TOL[dtype]:
            raise AssertionError(
                f"{phase} {name}: kernels vs plain {worst_p} (f32 tol "
                f"{CMDA_TRAIN_F32_TOL}); from the f32 step kernels "
                f"{e_kernel / step}, plain {e_plain / step} (bf16 ratio "
                f"{CMDA_TRAIN_BF16_RATIO}); statistics {worst_s}")
        del after
        torch.cuda.empty_cache()


def phase_cmda_train(cfg, model, smi):
    """CMDA-R50 training; then one step of one clip in f32 and bf16, each
    with the attention kernels against the plain attention. Returns the
    timed steps' launch counts and train clips/s."""
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL

    cmda = cfg.MODEL.MODEL_NAME
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    _, _, counts, clips_per_s = train_steps(
        "cmda_train", cfg, model,
        {"fused_bottleneck": 0, "flash_attention": 4 * TRAIN_STEPS,
         "flash_attention_backward":
             4 * BACKWARD_LAUNCHES_PER_CALL * TRAIN_STEPS, "int8_conv": 0}, smi)
    del model
    torch.cuda.empty_cache()
    hold_one_clip_steps("cmda_train",
                        lambda name, flash: train_cfg(cmda, name, flash),
                        state_dict, smi)
    return counts, clips_per_s


# ---------------------------------------------------------------------------
def yaml_cfg(name, opts):
    """configs/Kinetics/``name`` through the port's config loader, with the
    synthetic backend, bf16 and ``opts``."""
    from efficient_slowfast_tpu_torch.config import load_cfg

    return load_cfg(os.path.join(ROOT, "configs", "Kinetics", name), [
        "TPU.COMPUTE_DTYPE", "bfloat16", "TEST.DATASET", "synthetic",
        "TRAIN.DATASET", "synthetic",
        "DATA_LOADER.NUM_WORKERS", LOADER_WORKERS] + list(opts))


def smoke_dir():
    """A git-ignored directory of the checkout for the smoke's files."""
    path = os.path.join(ROOT, "build", "smoke")
    os.makedirs(path, exist_ok=True)
    return path


def test_meter(cfg, loader):
    """The port's TestMeter for ``loader``'s split, holding every clip's
    probabilities (finite, each row summing to 1 within TEST_ROW_TOL; for
    GhostNet's scores finite and non-negative) before it ensembles them."""
    from efficient_slowfast_tpu_torch.utils.meters import TestMeter

    probs = probabilities(cfg)

    class Checked(TestMeter):
        worst_row = 0.0
        clips = 0

        def update_stats(self, preds, labels, clip_ids):
            if not np.isfinite(preds).all():
                raise AssertionError("thirty_view: non-finite scores")
            if not probs:
                if preds.min() < 0:
                    raise AssertionError("thirty_view: negative scores")
                self.clips += len(preds)
                return super().update_stats(preds, labels, clip_ids)
            err = float(np.abs(preds.sum(1) - 1.0).max())
            self.worst_row = max(self.worst_row, err)
            if err > TEST_ROW_TOL:
                raise AssertionError(f"thirty_view: rows sum to 1 ± {err}")
            self.clips += len(preds)
            super().update_stats(preds, labels, clip_ids)

    views = cfg.TEST.NUM_ENSEMBLE_VIEWS * cfg.TEST.NUM_SPATIAL_CROPS
    return Checked(len(loader.dataset) // views, views, cfg.MODEL.NUM_CLASSES,
                   len(loader), ensemble_method=cfg.DATA.ENSEMBLE_METHOD,
                   topk=cfg.TRAIN.TOPK)


def check_preprocess(cfg, batch):
    """The first batch's pathways, preprocessed in float32 on the card,
    against the same preprocess on the CPU (8 clips at a time), returning
    the largest difference."""
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_test_preprocess

    pre = make_test_preprocess(cfg, torch.float32)
    keys = ("width", "spatial_idx", "portrait")
    on_card = pre(batch["frames"], *(batch[k] for k in keys))
    err = 0.0
    for i in range(0, batch["frames"].shape[0], 8):
        part = slice(i, i + 8)
        on_cpu = pre(batch["frames"][part].cpu(), *(batch[k][part] for k in keys))
        for a, b in zip(on_card, on_cpu):
            err = max(err, (a[part].cpu() - b).abs().max().item())
    return err


def phase_thirty_view(name, fused, expect_per_batch, smi):
    """One model's 30-view test on the synthetic test split, through the
    loader, the pinned host→GPU copy, the preprocess and the forward.
    Returns (kernel launches of the timed run, video_preds, cfg, model)."""
    from efficient_slowfast_tpu_torch.data.loader import (construct_loader,
                                                          prefetch_to_device)
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_test_preprocess
    from efficient_slowfast_tpu_torch.engine.state import make_forward
    from efficient_slowfast_tpu_torch.engine.test import perform_test
    from efficient_slowfast_tpu_torch.ops.kernels import fused_bottleneck as fb
    from efficient_slowfast_tpu_torch.utils.meters import StageTimes

    cfg = yaml_cfg(name, ["TPU.FUSED_EVAL", fused])
    label = cfg.MODEL.MODEL_NAME + (" fused" if fused else "")
    model = serving_model(cfg, SEED)
    if fusions(model):
        calibrate_attention(cfg, model, SEED + 6, "thirty_view")
    if nonlocal_blocks(model):  # γ 1 from serving_model's BN scales
        calibrate_nonlocal(cfg, model, SEED + 6)
    if nonlocal_blocks(model) or cfg.MODEL.MODEL_NAME in EFFICIENT_YAMLS:
        calibrate_head(cfg, model, SEED + 6, "thirty_view")
    loader = construct_loader(cfg, "test")
    n_clips, batch = len(loader.dataset), loader.batch_size
    if batch != TEST_CLIPS:
        raise AssertionError(f"thirty_view: {name} batches {batch} clips, "
                             f"phases 3 and 3b hold the kernels at {TEST_CLIPS}")
    real_tail = n_clips - (len(loader) - 1) * batch
    log("thirty_view", f"{label}: {name}, {n_clips} clips (8 videos x "
        f"{cfg.TEST.NUM_ENSEMBLE_VIEWS} x {cfg.TEST.NUM_SPATIAL_CROPS} views)"
        f" in {len(loader)} batches of {batch}, the last {real_tail} real + "
        f"{batch - real_tail} padded, {cfg.DATA_LOADER.NUM_WORKERS} loader "
        f"threads, canvas {loader.dataset.frames_shape()} uint8")

    # untimed: one batch (cuDNN plans, the kernels' plans, the pinned ring)
    plans = fb.plan.cache_info().misses
    pre = make_test_preprocess(cfg, torch.bfloat16)
    fwd = make_forward(cfg, model)
    for first in prefetch_to_device(loader, "cuda"):
        inputs = pre(first["frames"], first["width"], first["spatial_idx"],
                     first["portrait"])
        fwd(inputs)
        torch.cuda.synchronize()
        pre_err = check_preprocess(cfg, first)
        break
    warm_plans = fb.plan.cache_info().misses - plans
    # the forward alone on a resident preprocessed batch
    reps = len(loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fwd(inputs)
    torch.cuda.synchronize()
    fwd_alone = reps * batch / (time.perf_counter() - t0)
    del inputs, first

    times = StageTimes()
    meter = test_meter(cfg, loader)
    plans = fb.plan.cache_info().misses
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    stats = perform_test(cfg, model, loader, meter, times=times)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    timed_plans = fb.plan.cache_info().misses - plans

    split = times.summary()
    rows = (f"rows of every clip sum to 1 within {meter.worst_row:.2e}"
            if probabilities(cfg) else "every clip's scores finite and "
            "non-negative (the mean of ReLU(logits))")
    log("thirty_view", f"{label}: kernel launches {counts} ({len(loader)} "
        f"batches) | K1 plans made: {warm_plans} in the untimed batch, "
        f"{timed_plans} in the timed run (every shape was planned and held "
        f"at {TEST_CLIPS} clips in phase 3) | {stats} | {rows} | "
        f"preprocess on the card vs the "
        f"CPU, f32, first batch: max |d| {pre_err:.3e} (tol {PRE_TOL})")
    for i in range(len(split["forward"])):
        log("thirty_view", f"{label}: batch {i}: waiting on the loader "
            f"{split['wait'][i]:.2f} ms (host) | copy {split['copy'][i]:.2f}"
            f" ms | preprocess {split['preprocess'][i]:.2f} ms | forward "
            f"{split['forward'][i]:.2f} ms (CUDA events)")
    means = {k: statistics.mean(v) for k, v in split.items()}
    log("thirty_view", f"{label}: end to end {meter.clips / dt:.2f} clips/s "
        f"({dt:.3f} s for {meter.clips} clips: loader, copy, preprocess, "
        f"forward, meter) | forward alone on a resident {batch}-clip batch "
        f"{fwd_alone:.2f} clips/s | per batch mean: wait {means['wait']:.2f},"
        f" copy {means['copy']:.2f}, preprocess {means['preprocess']:.2f}, "
        f"forward {means['forward']:.2f} ms | peak memory "
        f"{peak / 2 ** 30:.2f} GiB | {smi}")

    expect = {k: v * len(loader) for k, v in expect_per_batch.items()}
    if counts != expect:
        raise AssertionError(f"thirty_view {label}: kernel launches {counts}"
                             f", expected {expect}")
    if meter.clips != n_clips:
        raise AssertionError(f"thirty_view {label}: {meter.clips} clips "
                             f"scored, expected {n_clips}")
    if warm_plans or timed_plans:
        raise AssertionError(f"thirty_view {label}: K1 planned {warm_plans} "
                             f"shapes in the untimed batch and {timed_plans} "
                             "in the timed run, which phase 3 did not hold "
                             "against the plain version")
    if pre_err > PRE_TOL:
        raise AssertionError(f"thirty_view {label}: preprocess on the card "
                             f"vs the CPU {pre_err}")

    # one batch traced, the second (its copy made behind the first's
    # forward, as in the test)
    batches = prefetch_to_device(loader, "cuda")
    try:
        for i in range(2):
            batch = next(batches)
            work = lambda b=batch: fwd(pre(  # noqa: E731
                b["frames"], b["width"], b["spatial_idx"], b["portrait"]))
            if i == 0:
                work()
            else:
                trace_window(f"thirty_view_{label.replace(' ', '_')}", work)
    finally:
        batches.close()
    return counts, meter.video_preds / meter.num_clips, cfg, model


def centred_log(means):
    """Per-video log mean probabilities less their mean over the classes:
    for one clip, the logits less theirs."""
    lp = np.log(np.maximum(means, 1e-30))
    return lp - lp.mean(1, keepdims=True)


def phase_thirty_view_reference(cfg, model, kernel_means, opts, what, smi):
    """The test again through ``test()`` with ``opts`` (the path without
    the kernels), its weights from a .pyth of the kernel run's, holding
    each video's centred log mean probabilities within TEST_LOGIT_TOL of
    their scale and printing top-1 agreement."""
    from efficient_slowfast_tpu_torch.engine.test import test

    label = cfg.MODEL.MODEL_NAME
    path = os.path.join(smoke_dir(), f"{label.lower()}.pyth")
    torch.save({"model_state": model.state_dict()}, path)
    ref_cfg = cfg.clone()
    ref_cfg.merge_from_list(list(opts) + [
        "TEST.CHECKPOINT_FILE_PATH", path, "OUTPUT_DIR", smoke_dir()])
    reset_counts()
    meter = test(ref_cfg)
    if any(read_counts().values()):
        raise AssertionError(f"the path without kernels launched "
                             f"{read_counts()}")
    ref_means = meter.video_preds / meter.num_clips
    if probabilities(cfg):
        ref_c, got_c = centred_log(ref_means), centred_log(kernel_means)
    else:  # GhostNet: mean ReLU(logits), compared as they are
        ref_c, got_c = ref_means, kernel_means
    scale = float(np.abs(ref_c).max())
    err = float(np.abs(got_c - ref_c).max())
    top1 = float((ref_means.argmax(1) == kernel_means.argmax(1)).mean())
    kind = ("centred log mean probabilities" if probabilities(cfg)
            else "mean scores")
    log("thirty_view", f"{label}: {what} vs test() from the .pyth with "
        f"{' '.join(map(str, opts))}: per-video {kind} "
        f"max |d| {err:.3e} of scale {scale:.3e} (tol "
        f"{TEST_LOGIT_TOL * scale:.3e}), mean probabilities max |d| "
        f"{float(np.abs(kernel_means - ref_means).max()):.3e} (max p "
        f"{float(ref_means.max()):.3e}), top-1 agreement {top1:.3f} | "
        f"{meter.stats} | {smi}")
    if not err <= TEST_LOGIT_TOL * scale:
        raise AssertionError(f"thirty_view {label}: {what} vs reference "
                             f"{err} > {TEST_LOGIT_TOL} x {scale}")


def phase_epochs(step_clips_per_s, smi):
    """CMDA-R50 as phase 7 trains it: an untimed train and val epoch (the
    loaders' first buffers and pinned canvases, the eval shapes' cuDNN
    plans), then a timed train epoch and val epoch through the synthetic
    loaders. Returns the timed epochs' launch counts."""
    from efficient_slowfast_tpu_torch.data.loader import construct_loader
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_train_preprocess
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_eval_step,
                                                           make_train_step)
    from efficient_slowfast_tpu_torch.engine.train import (eval_epoch,
                                                           train_epoch)
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL
    from efficient_slowfast_tpu_torch.utils.lr_policy import get_lr_at_epoch
    from efficient_slowfast_tpu_torch.utils.meters import TrainMeter, ValMeter

    cfg = yaml_cfg("SLOWFAST_DUALATTENTION_8x8_R50.yaml",
                   ["TRAIN.BATCH_SIZE", TRAIN_CLIPS])
    model = train_model(cfg, SEED)
    calib = cfg.clone()
    calib.DATA.TEST_CROP_SIZE = cfg.DATA.TRAIN_CROP_SIZE  # as in phase 7
    calibrate_attention(calib, model, SEED + 9)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state.model, state.optimizer)
    eval_step = make_eval_step(cfg, state.model)
    lrs, losses = [], []

    def recorded(state, inputs, labels, lr, generator):
        lrs.append(lr)
        mets = step(state, inputs, labels, lr, generator)
        losses.append(mets["loss"])
        return mets

    pre = make_train_preprocess(cfg, dtype=torch.bfloat16)
    train_loader = construct_loader(cfg, "train")
    val_loader = construct_loader(cfg, "val")
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    bn = model.s2.pathway0_res0.branch2.a_bn
    before = bn.running_mean.clone()

    def epochs(epoch):
        """(train seconds, val seconds, val meter) of one epoch each."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_loader.set_epoch(epoch)
        train_epoch(cfg, state, recorded, pre, train_loader,
                    TrainMeter(len(train_loader), cfg), epoch, generator=drop)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        val = ValMeter(len(val_loader), cfg)
        eval_epoch(cfg, state, eval_step, pre, val_loader, val, epoch)
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1, val

    cold = epochs(0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_train, t_val, val = epochs(1)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    moved = (bn.running_mean - before).abs().max().item()
    steps = len(train_loader)
    expect_lr = [get_lr_at_epoch(cfg, e + i / steps)
                 for e in (0, 1) for i in range(steps)]
    n_train = steps * train_loader.batch_size
    n_val = len(val_loader.dataset)
    log("epochs", f"CMDA-R50 train epochs 0 and 1: {steps} steps of "
        f"{train_loader.batch_size} clips each ({cfg.DATA.TRAIN_CROP_SIZE}² "
        f"crops from the {cfg.DATA.TRAIN_JITTER_SCALES[1]}-short-side canvas,"
        f" jitter {list(cfg.DATA.TRAIN_JITTER_SCALES)}) | losses "
        + ", ".join(f"{x:.4f}" for x in losses) + " | lr "
        + ", ".join(f"{x:.5f}" for x in lrs) + f" | running mean of s2 res0 "
        f"a_bn moved {moved:.3e}")
    log("epochs", f"CMDA-R50 val epoch 1: {len(val_loader)} batches, {n_val} "
        f"clips | top1_err {val.min_top1_err:.2f} top{cfg.TRAIN.TOPK}_err "
        f"{val.min_top_k_err:.2f} | kernel launches (epoch 1, train and val) "
        f"{counts}")
    log("epochs", f"bf16, epoch 1: train {n_train / t_train:.2f} clips/s "
        f"through the loader ({t_train:.3f} s; phase 7's steps alone "
        f"{step_clips_per_s:.2f}) | val {n_val / t_val:.2f} clips/s "
        f"({t_val:.3f} s) | peak memory {peak / 2 ** 30:.2f} GiB | epoch 0 "
        f"(the loaders' first epoch): train {n_train / cold[0]:.2f}, val "
        f"{n_val / cold[1]:.2f} clips/s | {smi}")

    expect = {"fused_bottleneck": 0,
              "flash_attention": 4 * steps + 4 * len(val_loader),
              "flash_attention_backward":
                  4 * BACKWARD_LAUNCHES_PER_CALL * steps, "int8_conv": 0}
    if counts != expect:
        raise AssertionError(f"epochs: kernel launches {counts}, expected "
                             f"{expect}")
    if len(losses) != 2 * steps or not all(np.isfinite(losses)):
        raise AssertionError(f"epochs: losses {losses}")
    if not moved > 0:
        raise AssertionError("epochs: BN running statistics did not move")
    if lrs != expect_lr:
        raise AssertionError(f"epochs: lr {lrs}, expected {expect_lr}")
    for v in (cold[2], val):
        if not (0 <= v.min_top1_err <= 100 and 0 <= v.min_top_k_err <= 100):
            raise AssertionError(f"epochs: val errors {v.min_top1_err}, "
                                 f"{v.min_top_k_err}")
    return counts


# ---------------------------------------------------------------------------
# phase 10: the paper's multigrid recipe through the CLI
RECIPE_YAML = os.path.join(ROOT, "configs", "Kinetics",
                           "SLOWFAST_DUAL_8x8_R50_stepwise_multigrid.yaml")
# train videos of the recipe's synthetic split: the first long-cycle phase
# (64 clips a step at 158²) takes 128 + 64 + 64 clips for one short cycle
RECIPE_TRAIN_CLIPS = 256
# the cuts, each with why
RECIPE_CUTS = [
    (["TRAIN.BATCH_SIZE", TRAIN_CLIPS],
     "the schedule's default batch B (the yaml's 64 is the reference's over "
     "8 GPUs): the long-cycle phases run 64, 32 and 8 clips a step, the "
     "short cycle's batches up to 128"),
    (["TRAIN.DATASET", "recipe_synthetic", "TEST.DATASET", "synthetic"],
     f"seeded synthetic clips in place of Kinetics and its decode: "
     f"{RECIPE_TRAIN_CLIPS} train videos (a full short cycle an epoch at "
     "B 64), 64 val clips, the 240-clip 30-view test split"),
    (["SOLVER.STEPS", "[0, 2]", "SOLVER.MAX_EPOCH", 3],
     "the schedule compressed from [0, 80, 100, 120, 140] / 150 to 4 epochs "
     "over 3 long-cycle shapes: [8, 8, 158] (sub-BN, 8 splits) twice, "
     "[4, 16, 158] (sub-BN, 4) and the final [1, 32, 224] (plain BN)"),
    (["BN.NUM_BATCHES_PRECISE", 2], "precise BN over 2 batches (yaml: 200)"),
    (["TENSORBOARD.ENABLE", False],
     "no TensorBoard: the CPU tests hold it (the card's machine has "
     "tensorboard but not the matplotlib its plots need)"),
    (["TPU.FLASH_MIN_TOKENS", 0],
     "every fusion through K2 and K2-bwd (the default 1024 sends fusions "
     "of at most 1024 tokens, 11 of the 24 shapes here, to the dense path)"),
    (["DATA_LOADER.NUM_WORKERS", LOADER_WORKERS, "LOG_PERIOD", 1000],
     "the yaml's 8 loader threads; iteration logs every 1000 steps"),
]


def recipe_argv(out_dir, *extra):
    opts = [str(o) for cut, _ in RECIPE_CUTS for o in cut]
    return ["--cfg", RECIPE_YAML] + opts + ["OUTPUT_DIR", out_dir] + [
        str(o) for o in extra]


def recipe_cfg():
    """The recipe's config through the CLI's loader."""
    from efficient_slowfast_tpu_torch.config.parser import (load_config,
                                                            parse_args)

    return load_config(parse_args(recipe_argv(os.path.join(
        smoke_dir(), "recipe"))))


def register_recipe_dataset():
    """``TRAIN.DATASET recipe_synthetic``: the synthetic dataset with
    RECIPE_TRAIN_CLIPS train videos."""
    from efficient_slowfast_tpu_torch.data.build import DATASET_REGISTRY
    from efficient_slowfast_tpu_torch.data.datasets import Synthetic

    if "Recipe_synthetic" in DATASET_REGISTRY:
        return

    class RecipeSynthetic(Synthetic):
        def _construct_loader(self):
            super()._construct_loader()
            if self.mode == "train":
                n = RECIPE_TRAIN_CLIPS
                self._path_to_videos = [f"synthetic://{i}" for i in range(n)]
                self._labels = [i % self.cfg.MODEL.NUM_CLASSES
                                for i in range(n)]
                self._spatial_temporal_idx = [0] * n

    DATASET_REGISTRY.register(RecipeSynthetic, name="Recipe_synthetic")


def recipe_epochs():
    """Per epoch of the recipe's schedule: (B, T, S, BN type, splits, the
    short cycle's crops, its batches)."""
    from efficient_slowfast_tpu_torch.ops.norm import effective_num_splits
    from efficient_slowfast_tpu_torch.utils.multigrid import (
        MultigridSchedule, short_cycle_batch_sizes, short_cycle_shapes)

    cfg = recipe_cfg()
    mg = MultigridSchedule()
    cfg = mg.init_multigrid(cfg)
    out = []
    for e in range(cfg.SOLVER.MAX_EPOCH):
        cfg, _ = mg.update_long_cycle(cfg, e)
        sub = cfg.BN.NORM_TYPE == "sub_batchnorm"
        out.append((cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES,
                    cfg.DATA.TRAIN_CROP_SIZE, cfg.BN.NORM_TYPE,
                    effective_num_splits(cfg) if sub else 1,
                    tuple(short_cycle_shapes(cfg)),
                    tuple(short_cycle_batch_sizes(cfg))))
    return cfg, mg.schedule, out


def recipe_attention_rows(model):
    """Phase 10's attention shapes, each with its largest batch: (forward
    rows, training rows), from the schedule: the short cycle's steps, the
    precise-BN and val batches at the long cycle's crop, the model-info
    forward (1 clip at DATA.CROP_SIZE) and the 30-view test."""
    cfg, _, epochs = recipe_epochs()
    fwd, bwd = {}, {}
    for b, t, s, _, _, crops, sizes in epochs:
        for crop, size in zip(crops, sizes):
            for shapes in (fwd, bwd):
                shapes[(t, crop)] = max(shapes.get((t, crop), 0), size)
        fwd[(t, s)] = max(fwd.get((t, s), 0), max(sizes[:2]), b)
    fwd[(epochs[0][1], cfg.DATA.CROP_SIZE)] = max(
        fwd.get((epochs[0][1], cfg.DATA.CROP_SIZE), 0), 1)
    fwd[(cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE)] = cfg.TEST.BATCH_SIZE

    def rows(shapes):
        best = {}
        for (t, crop), batch in sorted(shapes.items()):
            for label, n, m, d, c, _ in attention_rows(cfg, model, t, crop):
                key = (n, m, d, c)
                if batch > best.get(key, (None, 0))[1]:
                    best[key] = (label, batch)
        return [(label, n, m, d, c, 0, batch)
                for (n, m, d, c), (label, batch) in best.items()]

    return rows(fwd), rows(bwd)


class Observed:
    """Replaces ``module.name`` with ``wrap(original)`` while the block
    runs: the smoke's view into the CLI's run."""

    def __init__(self, *patches):
        self.patches = patches

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in self.patches]
        for (mod, name, wrap), (_, _, orig) in zip(self.patches, self.saved):
            setattr(mod, name, wrap(orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def host_tree(obj):
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [host_tree(v) for v in obj]
    return obj


def plain_view(sd):
    """A state dict with each split BN shown by its aggregated statistics
    (``bn.*``, the split step count) under the plain names, copied as they
    are: the form a checkpoint holds, with no arithmetic."""
    out = {}
    for k, v in sd.items():
        head, _, stat = k.rpartition(".")
        owner, _, inner = head.rpartition(".")
        if f"{owner}.split_bn.{stat}" in sd and inner in ("bn", "split_bn"):
            if inner == "bn":
                out[f"{owner}.{stat}"] = sd[
                    f"{owner}.split_bn.{stat}" if stat == "num_batches_tracked"
                    else k]
            continue
        out[k] = v
    return out


def tree_mismatch(a, b, where=""):
    """The first path where ``a`` and ``b`` differ (tensors bit for bit,
    dtype included), or None."""
    if torch.is_tensor(b):
        ok = (torch.is_tensor(a) and a.dtype == b.dtype
              and a.shape == b.shape and torch.equal(a, b))
        return None if ok else where or "/"
    if isinstance(b, dict):
        if not isinstance(a, dict) or set(a) != set(b):
            return where or "/"
        for k in b:
            bad = tree_mismatch(a[k], b[k], f"{where}/{k}")
            if bad:
                return bad
        return None
    if isinstance(b, list):
        if not isinstance(a, list) or len(a) != len(b):
            return where or "/"
        for i, (x, y) in enumerate(zip(a, b)):
            bad = tree_mismatch(x, y, f"{where}/{i}")
            if bad:
                return bad
        return None
    return None if a == b else where or "/"


class RecipeRun:
    """What one CLI run did, seen through its engine's functions: each
    epoch's shape, BN and steps (lr, loss, clips, phase), its time and peak
    memory; the val and precise-BN batches; each checkpoint's payload as
    saved and its seconds and bytes; K2's call shapes; the test's seconds.
    ``snapshot`` keeps the state the first epoch starts from."""

    def __init__(self):
        self.epochs, self.val_batches, self.precise = [], 0, []
        self.saves, self.k2_shapes, self.test_s = [], set(), None
        self.start = None

    def train_epoch(self, orig):
        def run(cfg, state, step, pre, loader, meter, epoch, **kw):
            bn = state.model.s1.pathway0_stem.bn
            rec = dict(epoch=epoch, b=cfg.TRAIN.BATCH_SIZE,
                       t=cfg.DATA.NUM_FRAMES, s=cfg.DATA.TRAIN_CROP_SIZE,
                       bn=cfg.BN.NORM_TYPE, splits=getattr(bn, "num_splits", 1),
                       module=type(bn).__name__, iters=len(loader), steps=[],
                       lr_expect=[])
            if self.start is None:
                self.start = dict(epoch=epoch, model=host_tree(
                    plain_view(state.model.state_dict())),
                    optimizer=host_tree(state.optimizer.state_dict()))

            def recorded(state, inputs, labels, lr, generator):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mets = step(state, inputs, labels, lr, generator)
                torch.cuda.synchronize()
                rec["steps"].append((lr, mets["loss"], labels.shape[0],
                                     inputs[0].shape[2],
                                     time.perf_counter() - t0))
                return mets

            from efficient_slowfast_tpu_torch.utils.lr_policy import \
                get_lr_at_epoch

            rec["lr_expect"] = [get_lr_at_epoch(cfg, epoch + i / len(loader))
                                for i in range(len(loader))]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = orig(cfg, state, recorded, pre, loader, meter, epoch, **kw)
            torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t0
            rec["peak"] = torch.cuda.max_memory_allocated()
            rec["losses"] = [float(x[1]) for x in rec["steps"]]
            self.epochs.append(rec)
            return out

        return run

    def eval_epoch(self, orig):
        def run(cfg, state, step, pre, loader, meter, epoch, **kw):
            self.val_batches += len(loader)
            return orig(cfg, state, step, pre, loader, meter, epoch, **kw)

        return run

    def precise_bn(self, orig):
        def run(cfg, state, loader, pre, num_batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(cfg, state, loader, pre, num_batches)
            torch.cuda.synchronize()
            self.precise.append((num_batches, time.perf_counter() - t0))
            return out

        return run

    def save(self, orig):
        from efficient_slowfast_tpu_torch.utils.checkpoint import \
            checkpoint_payload

        def run(path_to_job, state, epoch, cfg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = orig(path_to_job, state, epoch, cfg)
            dt = time.perf_counter() - t0
            self.saves.append(dict(path=path, epoch=epoch, seconds=dt,
                                   bytes=os.path.getsize(path),
                                   payload=checkpoint_payload(state, epoch,
                                                              cfg)))
            return path

        return run

    def attention(self, orig):
        def run(q, k, v):
            self.k2_shapes.add((q.shape[1], k.shape[1], q.shape[2], v.shape[2],
                                q.shape[0], torch.is_grad_enabled()
                                and q.requires_grad))
            return orig(q, k, v)

        return run

    def test(self, orig):
        def run(cfg, device=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(cfg, device=device)
            torch.cuda.synchronize()
            self.test_s = time.perf_counter() - t0
            return out

        return run

    def patches(self):
        from efficient_slowfast_tpu_torch.engine import train
        from efficient_slowfast_tpu_torch.ops import attention
        from efficient_slowfast_tpu_torch.tools import run_net
        from efficient_slowfast_tpu_torch.utils import checkpoint

        return Observed(
            (train, "train_epoch", self.train_epoch),
            (train, "eval_epoch", self.eval_epoch),
            (train, "calculate_and_update_precise_bn", self.precise_bn),
            (checkpoint, "save_checkpoint", self.save),
            (attention, "flash_attention", self.attention),
            (run_net, "test", self.test))


def recipe_main(rec, argv):
    from efficient_slowfast_tpu_torch.tools.run_net import main

    with rec.patches():
        return main(argv)


def phase_recipe(held_fwd, held_bwd, smi):
    """The paper's training recipe through the port's CLI, then an
    auto-resumed second run; returns the first run's kernel launches."""
    import shutil

    from efficient_slowfast_tpu_torch.engine.test import test
    from efficient_slowfast_tpu_torch.models import build_model
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL
    from efficient_slowfast_tpu_torch.utils import checkpoint

    out_dir = os.path.join(smoke_dir(), "recipe")
    shutil.rmtree(out_dir, ignore_errors=True)
    register_recipe_dataset()
    log("recipe", f"{os.path.relpath(RECIPE_YAML, ROOT)} (CMDA-R50, full "
        "width and depth, 400 classes, bf16, random weights from RNG_SEED) "
        "through python -m efficient_slowfast_tpu_torch.tools.run_net, "
        "train then the 30-view test; cuts:")
    for cut, why in RECIPE_CUTS:
        log("recipe", f"cut: {' '.join(map(str, cut))}: {why}")
    final_cfg, schedule, expect = recipe_epochs()
    log("recipe", f"schedule (step index, [B factor, T, S], end epoch): "
        f"{schedule}; solver STEPS {list(final_cfg.SOLVER.STEPS)} LRS "
        f"{[round(x, 6) for x in final_cfg.SOLVER.LRS]} MAX_EPOCH "
        f"{final_cfg.SOLVER.MAX_EPOCH}")

    # run 1: train from the seeded init, then test
    run1 = RecipeRun()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    out = recipe_main(run1, recipe_argv(out_dir))
    run_s = time.perf_counter() - t0
    counts = read_counts()
    steps = sum(len(e["steps"]) for e in run1.epochs)
    precise = sum(n for n, _ in run1.precise)
    meter = out["test"]
    n_test = int(meter.clip_count.sum())
    test_batches = -(-n_test // final_cfg.TEST.BATCH_SIZE)
    forwards = steps + precise + run1.val_batches + test_batches + 1
    bad = []
    for e, want in zip(run1.epochs, expect):
        b, t, s, bn, k, crops, sizes = want
        got = (e["b"], e["t"], e["s"], e["bn"], e["splits"])
        clips = sum(x[2] for x in e["steps"])
        log("recipe", f"epoch {e['epoch']}: (B, T, S, BN, splits) {got} "
            f"(schedule: {(b, t, s, bn, k)}), {e['module']}; short cycle "
            f"crops {list(crops)} batches {list(sizes)}; {len(e['steps'])} "
            f"steps, clips {[x[2] for x in e['steps']]} at crops "
            f"{[x[3] for x in e['steps']]}; losses "
            + ", ".join(f"{x:.4f}" for x in e["losses"]) + "; lr "
            + ", ".join(f"{x[0]:.6f}" for x in e["steps"]))
        step_s = [x[4] for x in e["steps"]]
        log("recipe", f"epoch {e['epoch']} [{b // TRAIN_CLIPS}, {t}, {s}]: "
            f"train {clips / e['seconds']:.2f} clips/s through the loader "
            f"({clips} clips, {e['seconds']:.3f} s) | the steps alone "
            f"{sum(step_s):.3f} s (ms each, synchronised: "
            + ", ".join(f"{x * 1e3:.1f}" for x in step_s) + f"), the rest "
            f"(loader, preprocess) {e['seconds'] - sum(step_s):.3f} s | peak "
            f"memory {e['peak'] / 2 ** 30:.2f} GiB | {smi}")
        cycle = [(sizes[i % 3], crops[i % 3]) for i in range(len(e["steps"]))]
        if got != (b, t, s, bn, k):
            bad.append(f"epoch {e['epoch']} trained {got}, schedule "
                       f"{(b, t, s, bn, k)}")
        if [(x[2], x[3]) for x in e["steps"]] != cycle or len(cycle) < 3:
            bad.append(f"epoch {e['epoch']}: steps "
                       f"{[(x[2], x[3]) for x in e['steps']]}, short cycle "
                       f"{cycle}")
        if not all(np.isfinite(e["losses"])):
            bad.append(f"epoch {e['epoch']}: losses {e['losses']}")
        if [x[0] for x in e["steps"]] != e["lr_expect"][:len(e["steps"])]:
            bad.append(f"epoch {e['epoch']}: lr {[x[0] for x in e['steps']]}"
                       f", policy {e['lr_expect']}")
    if len(run1.epochs) != len(expect):
        bad.append(f"{len(run1.epochs)} epochs, schedule {len(expect)}")
    for n, s_ in run1.precise:
        log("recipe", f"precise BN: {n} batches in {s_:.3f} s")
    expect_counts = {"fused_bottleneck": 0,
                     "flash_attention": 4 * forwards,
                     "flash_attention_backward":
                         4 * BACKWARD_LAUNCHES_PER_CALL * steps, "int8_conv": 0}
    log("recipe", f"kernel launches {counts}; forwards: {steps} train steps "
        f"+ {precise} precise-BN + {run1.val_batches} val + {test_batches} "
        f"test batches + 1 model-info forward; expected {expect_counts}")
    if counts != expect_counts:
        bad.append(f"kernel launches {counts}, expected {expect_counts}")
    unheld = [sh for sh in run1.k2_shapes
              if held_fwd.get(sh[:4], 0) < sh[4]
              or (sh[5] and held_bwd.get(sh[:4], 0) < sh[4])]
    log("recipe", f"K2 shapes (N, M, D, C, clips, with backward): "
        f"{len(run1.k2_shapes)}, each held against the plain version in "
        f"phases 3b/3c at its batch or larger: {not unheld}")
    if unheld:
        bad.append(f"K2 shapes not held in 3b/3c: {sorted(unheld)}")

    # checkpoints: each file as saved, and back into a model of its form
    for sv in run1.saves:
        t0 = time.perf_counter()
        payload = torch.load(sv["path"], map_location="cpu",
                             weights_only=True)
        load_s = time.perf_counter() - t0
        where = tree_mismatch(payload, sv["payload"])
        log("recipe", f"checkpoint {os.path.basename(sv['path'])} (epoch "
            f"{sv['epoch']}): saved in {sv['seconds']:.3f} s, "
            f"{sv['bytes'] / 1e6:.2f} MB; torch.load {load_s:.3f} s; "
            f"bit-identical to what was saved: {where is None}")
        if where:
            bad.append(f"{sv['path']} differs from what was saved at {where}")
    for sv, e in ((run1.saves[0], expect[0]), (run1.saves[-1], expect[-1])):
        cfg = recipe_cfg()
        cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = e[3], e[4]
        cfg.DATA.NUM_FRAMES = e[1]
        model = build_model(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.load_checkpoint(sv["path"], model)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        back = host_tree(plain_view(model.state_dict()))
        where = tree_mismatch(back, sv["payload"]["model_state"])
        log("recipe", f"{os.path.basename(sv['path'])} into a {e[3]} model "
            f"({e[4]} splits): load_checkpoint {load_s:.3f} s, its state "
            f"bit-identical to the file's: {where is None}")
        if where:
            bad.append(f"{sv['path']} loads back different at {where}")
        del model

    # the test read the last checkpoint: test() given it by path agrees
    last = run1.saves[-1]["path"]
    if checkpoint.get_last_checkpoint(out_dir) != last:
        bad.append(f"last checkpoint {checkpoint.get_last_checkpoint(out_dir)}"
                   f", saved {last}")
    ref_cfg = recipe_cfg()
    ref_cfg.merge_from_list(["TEST.CHECKPOINT_FILE_PATH", last,
                             "TRAIN.ENABLE", False])
    ref = test(ref_cfg)
    diff = float(np.abs(ref.video_preds - meter.video_preds).max())
    log("recipe", f"30-view test: {n_test} clips in {run1.test_s:.3f} s, "
        f"{n_test / run1.test_s:.2f} clips/s end to end (the model's build "
        f"and the checkpoint's load included) | {meter.stats} | per-video "
        f"scores against test() given {os.path.basename(last)} by path: max "
        f"|d| {diff:.3e} | whole run {run_s:.1f} s | {smi}")
    if diff != 0.0:
        bad.append(f"the test's scores differ from test() of {last}: {diff}")

    # run 2: the CLI again with AUTO_RESUME after the last two checkpoints
    for sv in run1.saves[2:]:
        os.remove(sv["path"])
    resume_from = run1.saves[1]
    run2 = RecipeRun()
    recipe_main(run2, recipe_argv(out_dir, "TEST.ENABLE", False))
    first = run2.epochs[0] if run2.epochs else {}
    same = [(tree_mismatch(run2.start[k], resume_from["payload"][s]))
            for k, s in (("model", "model_state"),
                         ("optimizer", "optimizer_state"))]
    lrs1 = [x[0] for e in run1.epochs if e["epoch"] >= 2 for x in e["steps"]]
    lrs2 = [x[0] for e in run2.epochs for x in e["steps"]]
    log("recipe", f"resume: AUTO_RESUME from "
        f"{os.path.basename(resume_from['path'])} (epoch "
        f"{resume_from['epoch']}): first epoch {first.get('epoch')} "
        f"({first.get('b')}, {first.get('t')}, {first.get('s')}, "
        f"{first.get('bn')}, {first.get('splits')}); model (plain form) and "
        f"optimizer state at its start bit-identical to the file's: "
        f"{same == [None, None]}; its {len(lrs2)} steps' lr the policy's and "
        f"run 1's: {lrs2 == lrs1}")
    if first.get("epoch") != resume_from["epoch"] + 1 or same != [None, None]:
        bad.append(f"resume: first epoch {first.get('epoch')}, state "
                   f"mismatch at {same}")
    for e in run2.epochs:
        if [x[0] for x in e["steps"]] != e["lr_expect"][:len(e["steps"])]:
            bad.append(f"resume epoch {e['epoch']}: lr off the policy")
    if lrs2 != lrs1:
        bad.append(f"resume: lr {lrs2}, run 1's {lrs1}")
    if bad:
        raise AssertionError("recipe: " + "; ".join(bad))
    return counts


def recipe_split_bn_cost(smi):
    """One train step of the recipe's model at its first long-cycle shape
    (64 clips, 8 frames, 158²) with that phase's 8-split BN and with plain
    BN: each untraced (3 steps after 2 warm-up) and traced."""
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)
    from efficient_slowfast_tpu_torch.models import build_model

    ms = {}
    for norm, splits in (("sub_batchnorm", 8), ("batchnorm", 1)):
        cfg = recipe_cfg()
        cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE = 8, 158
        cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS = norm, splits
        torch.manual_seed(SEED)
        state = create_train_state(cfg, build_model(cfg))
        step = make_train_step(cfg, state.model, state.optimizer)
        gen = torch.Generator().manual_seed(SEED + 12)
        x = clips(cfg, 64, gen, torch.bfloat16)
        y = torch.randint(0, cfg.MODEL.NUM_CLASSES, (64,), generator=gen).cuda()
        drop = torch.Generator(device="cuda").manual_seed(SEED)
        for _ in range(2):
            step(state, x, y, 0.01, drop)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, x, y, 0.01, drop)
        torch.cuda.synchronize()
        ms[norm] = (time.perf_counter() - t0) / 3 * 1e3
        share, window, _, _ = trace_window(
            f"recipe_step_{norm}", lambda: step(state, x, y, 0.01, drop))
        log("recipe", f"one step at [8, 8, 158] (64 clips, 158², 8 frames), "
            f"{norm} ({splits} splits): {ms[norm]:.1f} ms untraced; traced "
            f"{window:.1f} ms, its kernels' union {share * window:.1f} ms | "
            f"{smi}")
        del state, step, x
        torch.cuda.empty_cache()
    log("recipe", f"the 8-split BN adds {ms['sub_batchnorm'] - ms['batchnorm']:.1f}"
        f" ms to a [8, 8, 158] step ({ms['sub_batchnorm'] / ms['batchnorm']:.2f}x"
        f" plain BN's) | {smi}")


# ---------------------------------------------------------------------------
# phase 11: the non-local networks
NLN_YAML = "I3D_NLN_8x8_R50.yaml"
SLOWFAST_NLN_YAML = "SLOWFAST_NLN_8x8_R50.yaml"
# K2 shapes beside the I3D-NLN path, held at its training batch: widths
# that are not multiples of 16 and D != C, above 128 (the wide kernels),
# N and M ragged against their row blocks and key tiles
NLN_OFF_PATH = [("ragged 200", 1000, 250, 200, 200),
                ("ragged 384/320", 777, 190, 384, 320)]


def nonlocal_cfg(dtype="bfloat16", flash=True, train=False):
    """configs/Kinetics/I3D_NLN_8x8_R50.yaml at full width and depth (400
    classes, 8 frames, softmax non-local blocks after blocks 1, 3 of s3
    and 1, 3, 5 of s4) through the port's config loader: served and tested
    at its 256² test crop; with ``train``, its 224² crop (the inputs made
    at it) and its solver (SGD lr 0.1, nesterov momentum 0.9, weight decay
    1e-4 and none on BN, dropout 0.5)."""
    cfg = yaml_cfg(NLN_YAML, ["TPU.COMPUTE_DTYPE", dtype,
                              "TPU.FLASH_ATTENTION", flash])
    if train:
        cfg.DATA.TEST_CROP_SIZE = cfg.DATA.CROP_SIZE
    return cfg


def nonlocal_blocks(model):
    from efficient_slowfast_tpu_torch.models.nonlocal_block import Nonlocal

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, Nonlocal)]


def nonlocal_rows(cfg, model, crop, batch):
    """The non-local blocks of one forward at NUM_FRAMES and ``crop``,
    grouped by stage: [(label, N, M, D, C, K2 launches a forward, batch)];
    the blocks at or below TPU.FLASH_MIN_TOKENS queries take the dense
    branch and launch nothing (s4's at the default 1024)."""
    from efficient_slowfast_tpu_torch.models.slowfast import _POOL1

    t = cfg.DATA.NUM_FRAMES // _POOL1[cfg.MODEL.ARCH][0][0]
    h = -(-crop // 4)  # the stem's two stride-2 ops
    rows = []
    for i, stage in enumerate(("s2", "s3", "s4", "s5")):
        h = -(-h // cfg.RESNET.SPATIAL_STRIDES[i][0])
        blocks = [m for n, m in nonlocal_blocks(model)
                  if n.startswith(stage + ".")]
        if not blocks:
            continue
        pool = blocks[0].pool_size or [1, 1, 1]
        n, d = t * h * h, blocks[0].dim_inner
        m = (t // pool[0]) * (h // pool[1]) * (h // pool[2])
        flash = n > cfg.TPU.FLASH_MIN_TOKENS
        rows.append((f"nln {stage} {crop}", n, m, d, d,
                     len(blocks) if flash else 0, batch))
    return rows


def calibrate_nonlocal(cfg, model, seed):
    """Scale each non-local block's θ and φ convs (weight and bias, by one
    factor each) so that its scaled logits θφᵀ/√D have ATTN_LOGIT_STD on a
    seeded clip, block by block in the forward's order: phase 5's rule
    (calibrate_attention) for the non-local blocks, whose logits on random
    weights are not of a trained model's order either (std 3-1.5e4 in
    I3D-NLN's blocks, up to 1e16 in SlowFast-NLN's dot_product blocks,
    which take the same scale)."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward
    from efficient_slowfast_tpu_torch.ops.pool import max_pool3d

    fwd = make_forward(cfg, model)
    req = clips(cfg, 1, torch.Generator().manual_seed(seed), torch.float32)
    stds = []
    for _, blk in nonlocal_blocks(model):
        seen = {}
        hook = blk.register_forward_hook(
            lambda m, inp, out: seen.update(x=inp[0]))
        fwd(req)
        hook.remove()
        with torch.inference_mode():
            x = seen["x"]
            # float64: uncalibrated dot-product logits overflow float32
            q = blk.conv_theta(x).flatten(2).double()  # (1, D, N)
            if blk.pool_size is not None:
                x = max_pool3d(x, blk.pool_size, blk.pool_size)
            k = blk.conv_phi(x).flatten(2).double()
            std = (torch.einsum("bdn,bdm->bnm", q[:, :, ::16], k)
                   * blk.dim_inner ** -0.5).std().item()
            f = (ATTN_LOGIT_STD / std) ** 0.5
            for conv in (blk.conv_theta, blk.conv_phi):
                conv.weight.mul_(f)
                conv.bias.mul_(f)
        stds.append(std)
    log("nonlocal", "scaled logit std before calibration, "
        + ", ".join(f"{n} {x:.4g}" for (n, _), x in
                    zip(nonlocal_blocks(model), stds))
        + f" -> {ATTN_LOGIT_STD}")


def calibrate_head(cfg, model, seed, phase="nonlocal"):
    """Scale the classifier (weight and bias) so that its logits have
    HEAD_LOGIT_STD on a seeded clip (eval mode)."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    seen = {}
    proj = getattr(model.head, "projection", None)
    if proj is None:  # the efficient heads' classifier (Dropout, Linear)
        proj = model.head.classifier[1]
    hook = proj.register_forward_hook(lambda m, inp, out: seen.update(y=out))
    make_forward(cfg, model)(
        clips(cfg, 1, torch.Generator().manual_seed(seed), torch.float32))
    hook.remove()
    std = seen["y"].float().std().item()
    with torch.no_grad():
        proj.weight.mul_(HEAD_LOGIT_STD / std)
        proj.bias.mul_(HEAD_LOGIT_STD / std)
    log(phase, f"classifier logit std before calibration {std:.4g} -> "
        f"{HEAD_LOGIT_STD}")


# One I3D-NLN train step on one clip with every non-local γ 1 (phase 11) is
# chaotic on random weights: a relative 1e-6 perturbation of the plain
# path's attention output moves its whole step by 30-220% (float32, on
# an H100 over 1 and 8 clips; the phase prints it again), so no two
# float32 runs of it agree and phase 7's whole-step gate cannot hold for
# any implementation. Phase 11 holds what is well conditioned: the step's
# loss with the kernels against the plain step's (float32 1e-4, bf16 2e-2
# of it, the serving tolerances), and every attention call of the kernel
# step, forward output and gradients, against the plain versions on that
# call's own inputs (ATTN_*_TOL, ATTN_BWD_*_TOL); the whole steps'
# distances are printed beside the perturbation's.
NLN_LOSS_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


class BackwardCalls:
    """Every ``flash_attention_backward`` call while the block runs, with
    its inputs and gradients; its launches stay on the wrapper's count."""

    def __enter__(self):
        from efficient_slowfast_tpu_torch.ops.kernels import \
            flash_attention as fa

        self.fa, self.orig, self.calls = fa, fa.flash_attention_backward, []

        def recorded(q, k, v, out, lse, dout):
            grads = self.orig(q, k, v, out, lse, dout)
            self.calls.append((q, k, v, out, lse, dout, grads))
            return grads

        recorded.launches = 0  # the wrapper counts on the module's name
        self.recorded = recorded
        fa.flash_attention_backward = recorded
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_backward = self.orig
        self.orig.launches += self.recorded.launches

    def held(self, floor=1.0):
        """Each call's dQ, dK and dV against attention_backward on its
        inputs: [[(largest absolute error over max(``floor``, scale),
        scale)] * 3] a call, the scale the reference gradient's largest
        magnitude."""
        return [[(relative_error(g, r, floor), r.float().abs().max().item())
                 for g, r in zip(grads, self.fa.attention_backward(
                     q, k, v, out, lse, dout))]
                for q, k, v, out, lse, dout, grads in self.calls]

    def worst(self, floor=1.0):
        """The largest error of any call's gradients (``held``)."""
        return max((e for row in self.held(floor) for e, _ in row),
                   default=0.0)


def relative_error(x, ref, floor):
    """The largest absolute difference of ``x`` from ``ref`` over
    max(``floor``, ``ref``'s largest magnitude)."""
    return ((x.float() - ref.float()).abs().max().item()
            / max(floor, ref.float().abs().max().item()))


def hold_one_clip_attention(phase, cfg_of, state_dict, expect_calls, smi):
    """One train step of one clip from ``state_dict`` in float32 and in
    bfloat16 with the kernels and with the plain attention (``cfg_of(dtype
    name, flash)``): the losses within NLN_LOSS_TOL, and each of the
    ``expect_calls`` kernel calls of the kernel step within the attention
    tolerances of the plain versions on its own inputs."""
    from efficient_slowfast_tpu_torch.ops.kernels import \
        flash_attention as fa

    for dtype, f_tol, b_tol in (
            (torch.float32, ATTN_F32_TOL, ATTN_BWD_F32_TOL),
            (torch.bfloat16, ATTN_BF16_TOL, ATTN_BWD_BF16_TOL)):
        name = str(dtype)[6:]
        batch = train_batches(cfg_of(name, True), 1, 1, SEED + 11, dtype)[0]
        with BackwardCalls() as rec:
            kernel, loss_k = one_step(cfg_of(name, True), state_dict, batch,
                                      SEED, with_loss=True)
        plain, loss_p = one_step(cfg_of(name, False), state_dict, batch,
                                 SEED, with_loss=True)
        worst_f, worst_b = 0.0, rec.worst()
        for q, k, v, out, _, _, _ in rec.calls:
            ref = fa.chunked_attention(q, k, v)
            worst_f = max(worst_f, (out.float() - ref.float()).abs().max()
                          .item() / max(1.0, ref.float().abs().max().item()))
        count = len(rec.calls)
        del rec
        # the plain step again, its attention output perturbed by 1e-6
        chunked = fa.chunked_attention_lse
        fa.chunked_attention_lse = lambda *a: (
            lambda o, l: (o * (1 + 1e-6 * torch.randn_like(o)), l))(
                *chunked(*a))
        try:
            perturbed = one_step(cfg_of(name, False), state_dict, batch, SEED)
        finally:
            fa.chunked_attention_lse = chunked
        params = [k for k in state_dict
                  if not k.endswith(("running_mean", "running_var",
                                     "num_batches_tracked"))]
        dist = lambda a, b: sum((a[k].double() - b[k].double()).norm()
                                .item() ** 2 for k in params) ** 0.5
        step = dist(plain, state_dict)
        loss_err = abs(loss_k - loss_p) / max(1.0, abs(loss_p))
        log(phase, f"{name}, 1 clip, one step: loss kernels {loss_k:.6f} vs "
            f"plain {loss_p:.6f} (rel {loss_err:.3e}, tol "
            f"{NLN_LOSS_TOL[dtype]}); the kernel step's {count} attention "
            f"calls against the plain versions "
            f"on their inputs: forward {worst_f:.3e} (tol {f_tol}), "
            f"backward {worst_b:.3e} (tol {b_tol}) of the scale; whole "
            f"steps, distance over the plain step: kernels vs plain "
            f"{dist(kernel, plain) / step:.3e}, plain vs plain with its "
            f"attention output perturbed by 1e-6 "
            f"{dist(perturbed, plain) / step:.3e} | {smi}")
        if (loss_err > NLN_LOSS_TOL[dtype] or worst_f > f_tol
                or worst_b > b_tol or count != expect_calls):
            raise AssertionError(
                f"{phase} {name}: loss {loss_err}, attention forward "
                f"{worst_f}, backward {worst_b}, {count} calls (expected "
                f"{expect_calls})")
        del kernel, plain, perturbed
        torch.cuda.empty_cache()


def phase_nonlocal_kernels(smi):
    """3b and 3c at I3D-NLN's shapes: K2 at the 224² training shapes (8
    clips) and the 256² test shapes (64 clips), K2-bwd at the training
    batch, with the ragged wide shapes beside them. Returns (worst bf16
    error forward, backward, the largest bf16 batch held forward)."""
    from efficient_slowfast_tpu_torch.models import build_model

    cfg = nonlocal_cfg()
    model = build_model(cfg, device="cuda")
    train = nonlocal_rows(cfg, model, cfg.DATA.CROP_SIZE, TRAIN_CLIPS)
    test = nonlocal_rows(cfg, model, cfg.DATA.TEST_CROP_SIZE, TEST_CLIPS)
    del model
    _, fwd_err, held = phase_attention(train + test, smi,
                                       off_path=NLN_OFF_PATH,
                                       path_batch=TRAIN_CLIPS)
    _, bwd_err, _ = phase_attention_backward(
        [r[:6] for r in train + test], smi, off_path=NLN_OFF_PATH)
    return fwd_err, bwd_err, held


def phase_nonlocal(smi):
    """Phase 11: I3D-NLN-R50 served, tested (30 views) and trained on the
    card through the port's entry points, K2 in the forward and K2-bwd in
    the backward at D = C = 256; SlowFast-NLN (dot_product) served beside
    it. Returns the launch counts of its main-path runs, summed."""
    from efficient_slowfast_tpu_torch.engine.inference import supports
    from efficient_slowfast_tpu_torch.engine.state import make_forward
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL

    none = {"fused_bottleneck": 0, "flash_attention": 0,
            "flash_attention_backward": 0, "int8_conv": 0}
    totals = dict(none)

    def add(counts):
        for key, value in counts.items():
            totals[key] += value

    # serving: three 4-clip requests at the 30-view shape, against the
    # same model under TPU.FLASH_ATTENTION False; then f32 on one clip
    cfg = nonlocal_cfg()
    model = serving_model(cfg, SEED + 20)
    calibrate_nonlocal(cfg, model, SEED + 21)
    calibrate_head(cfg, model, SEED + 21)
    rows = nonlocal_rows(cfg, model, cfg.DATA.TEST_CROP_SIZE,
                         CLIPS_PER_REQUEST)
    per_request = sum(r[5] for r in rows)
    log("nonlocal", f"{NLN_YAML}: non-local blocks {len(nonlocal_blocks(model))}"
        f", final BN γ 1 (the seeded weights' BN scale); K2 launches a "
        f"forward {per_request} at " + ", ".join(
            f"{r[0]} N {r[1]} M {r[2]} D {r[3]} x{r[5]}" for r in rows))
    cfg_plain = nonlocal_cfg(flash=False)
    counts, request_s = serve_and_compare(
        "nonlocal", cfg, make_forward(cfg, model),
        make_forward(cfg_plain, model_with(cfg_plain, model.state_dict())),
        ("flash kernel", "plain attention"),
        {**none, "flash_attention": per_request * REQUESTS},
        CMDA_BF16_ATOL, SEED + 22, smi)
    add(counts)
    log("nonlocal", f"bf16 serving: {request_s * 1e3:.2f} ms a "
        f"{CLIPS_PER_REQUEST}-clip request, "
        f"{CLIPS_PER_REQUEST / request_s:.2f} clips/s | {smi}")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    cfg32, cfg32_plain = nonlocal_cfg("float32"), nonlocal_cfg("float32",
                                                               flash=False)
    compare_one_clip("nonlocal", cfg32,
                     make_forward(cfg32, model_with(cfg32, state)),
                     make_forward(cfg32_plain, model_with(cfg32_plain, state)),
                     ("flash kernel", "plain attention"), CMDA_F32_ATOL,
                     SEED + 23, smi)
    del state
    torch.cuda.empty_cache()

    # the 30-view test, against test() without the kernels
    counts, means, cfg, model = phase_thirty_view(
        NLN_YAML, False, {**none, "flash_attention": per_request}, smi)
    add(counts)
    phase_thirty_view_reference(cfg, model, means,
                                ["TPU.FLASH_ATTENTION", False],
                                "flash attention", smi)
    del model
    torch.cuda.empty_cache()

    # training as the yaml trains (each non-local γ at its zero init: K2
    # and K2-bwd run, and the gradients reach γ alone), then one clip's
    # step in f32 and bf16 from the same weights with γ 1 against the
    # plain attention. With γ 1 the steps at lr 0.1 diverge: on an H100
    # every timed loss was NaN after the two warm-up steps.
    cfg = nonlocal_cfg(train=True)
    model = train_model(cfg, SEED + 24)
    calibrate_nonlocal(cfg, model, SEED + 25)
    rows = nonlocal_rows(cfg, model, cfg.DATA.CROP_SIZE, TRAIN_CLIPS)
    per_step = sum(r[5] for r in rows)
    # γ 1 in the one-clip steps' weights: at its zero init a block adds
    # exactly nothing, and any affinity would pass a comparison
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for name, _ in nonlocal_blocks(model):
        state[name + ".bn.weight"].fill_(1.0)
    _, _, counts, _ = train_steps(
        "nonlocal", cfg, model,
        {**none, "flash_attention": per_step * TRAIN_STEPS,
         "flash_attention_backward":
             per_step * BACKWARD_LAUNCHES_PER_CALL * TRAIN_STEPS, "int8_conv": 0}, smi)
    add(counts)
    del model
    torch.cuda.empty_cache()
    hold_one_clip_attention(
        "nonlocal", lambda name, flash: nonlocal_cfg(name, flash, True),
        state, per_step, smi)
    del state
    torch.cuda.empty_cache()

    # SlowFast-NLN: two pathways, dot_product blocks (no K2), which the
    # fused engine refuses as JAX's supports() does (no K1)
    cfg = yaml_cfg(SLOWFAST_NLN_YAML, ["TPU.FUSED_EVAL", True])
    if supports(cfg):
        raise AssertionError("the fused engine takes SlowFast-NLN")
    model = serving_model(cfg, SEED + 26)
    # θ(φᵀg)/M grows as the cube of its input on random weights (non-
    # finite scores in bf16 uncalibrated): the same calibration of θ and φ
    calibrate_nonlocal(cfg, model, SEED + 27)
    fwd = make_forward(cfg, model)
    requests = [clips(cfg, CLIPS_PER_REQUEST,
                      torch.Generator().manual_seed(SEED + 28 + i),
                      torch.bfloat16) for i in range(REQUESTS)]
    serve(fwd, requests[:1])
    reset_counts()
    outs, dt = serve(fwd, requests)
    counts = read_counts()
    for i, out in enumerate(outs):
        check_scores(out, CLIPS_PER_REQUEST, cfg.MODEL.NUM_CLASSES,
                     f"SlowFast-NLN request {i}")
    log("nonlocal", f"{SLOWFAST_NLN_YAML} (dot_product, {cfg.DATA.NUM_FRAMES}"
        f" frames, {cfg.DATA.TEST_CROP_SIZE}², TPU.FUSED_EVAL True, refused"
        f"): {REQUESTS} requests x {CLIPS_PER_REQUEST} clips, kernel "
        f"launches {counts}, rows sum to 1 | "
        f"{REQUESTS * CLIPS_PER_REQUEST / dt:.2f} clips/s, "
        f"{dt / REQUESTS * 1e3:.2f} ms a request | {smi}")
    if counts != none:
        raise AssertionError(f"SlowFast-NLN launched {counts}")
    del model, outs
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# Phase 12: the efficient families (configs/Kinetics/*_16x2_112.yaml)
EFFICIENT_YAMLS = {
    "SlowFastShuffleNetV2": "SLOWFAST_SHUFFLENETV2_16x2_112.yaml",
    "SlowFastShuffleNet": "SLOWFAST_SHUFFLENET_16x2_112.yaml",
    "SlowFastMoibleNetV2": "SLOWFAST_MOBILENETV2_16x2_112.yaml",
    "SlowFastGhostNet": "SLOWFAST_GHOSTNET_16x2_112.yaml",
}
# K2 launches a forward at the yamls' 16x2 112² shape: the fusions above
# TPU.FLASH_MIN_TOKENS (1024) slow tokens, D = C = 3, 6, 3 and (2, 3)
EFFICIENT_K2 = {"SlowFastShuffleNetV2": 1, "SlowFastShuffleNet": 1,
                "SlowFastMoibleNetV2": 1, "SlowFastGhostNet": 2}
# trained in phase 12, at 64 clips a step (the yamls' TRAIN.BATCH_SIZE 512
# over 8 cards)
EFFICIENT_TRAINED = ("SlowFastShuffleNetV2", "SlowFastGhostNet")
EFFICIENT_TRAIN_CLIPS = 64


def efficient_cfg(name, dtype="bfloat16", flash=True):
    """The zoo yaml of ``name`` at full width and depth (400 classes, 16
    frames, α 4, β 8, 112² for training and test) through the port's config
    loader, with its solver (SGD from lr 0.01, nesterov momentum 0.9,
    weight decay 1e-4 and none on BN, dropout 0.5)."""
    return yaml_cfg(EFFICIENT_YAMLS[name], ["TPU.COMPUTE_DTYPE", dtype,
                                            "TPU.FLASH_ATTENTION", flash])


def efficient_rows(cfg, model, batch):
    """Each fusion's attention in one forward: [(label, N, M, D, C, K2
    launches a forward, batch)], a launch where the slow tokens exceed
    TPU.FLASH_MIN_TOKENS."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    seen = []
    hooks = [att.register_forward_hook(
        lambda m, inp, out, name=name: seen.append((name, inp[0].shape)))
        for name, att in fusions(model)]
    make_forward(cfg, model)(clips(cfg, 1, torch.Generator().manual_seed(
        SEED), torch.bfloat16))
    for hook in hooks:
        hook.remove()
    short = cfg.MODEL.MODEL_NAME[len("SlowFast"):].lower()
    rows = []
    for name, shape in seen:
        c, n = shape[1], int(np.prod(shape[2:]))
        rows.append((f"{short} {name}", n, n, c, c,
                     int(n > cfg.TPU.FLASH_MIN_TOKENS), batch))
    return rows


def kernel_ops(events):
    """Each CUDA kernel of a trace with the innermost host op around the
    runtime call that launched it: [(kernel event, op event or None)]."""
    import bisect

    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op":
            ops.setdefault(e.get("tid"), []).append(e)
    starts = {}
    for tid, lst in ops.items():
        lst.sort(key=lambda e: e["ts"])
        starts[tid] = [e["ts"] for e in lst]
    out = []
    for k in (e for e in events if e.get("cat") == "kernel"):
        launch = launches.get(k.get("args", {}).get("correlation"))
        op = None
        if launch is not None and launch.get("tid") in ops:
            lst, t = ops[launch["tid"]], launch["ts"]
            i = bisect.bisect_right(starts[launch["tid"]], t) - 1
            while i >= 0:  # the latest-starting op that still holds t
                if lst[i]["ts"] + lst[i]["dur"] >= t:
                    op = lst[i]
                    break
                i -= 1
        out.append((k, op))
    return out


def _depthwise(op):
    """Whether ``op`` is a convolution (or its backward) with a depthwise
    weight: a 5-D input of shape (O, 1, kT, kH, kW)."""
    if op is None or "conv" not in op["name"]:
        return False
    dims = op.get("args", {}).get("Input Dims") or []
    return any(isinstance(d, list) and len(d) == 5 and d[1] == 1
               and d[0] > 1 for d in dims)


def op_breakdown(name, blocks):
    """Device time of the traced window ``name`` by the op that launched
    each kernel (depthwise convolutions, the other convolutions, batch
    norm, the attention kernels, copies, the rest) and the host's copy ops
    (aten::copy_, aten::contiguous, aten::clone) against the model's
    ``blocks``."""
    from efficient_slowfast_tpu_torch.utils import profiler

    log_dir = os.path.join(smoke_dir(), f"profile_{name}")
    with open(os.path.join(log_dir, profiler.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    groups, total = {}, 0.0
    dw_kernels = {}
    for k, op in kernel_ops(events):
        kname, dur = k["name"], k["dur"]
        opname = op["name"] if op else ""
        if "flash_attention" in kname or "attention_bwd" in kname:
            group = "attention kernels (K2, K2-bwd)"
        elif _depthwise(op):
            group = "depthwise convolutions"
            total_k, calls = dw_kernels.get(kname, (0.0, 0))
            dw_kernels[kname] = (total_k + dur, calls + 1)
        elif "conv" in opname:
            group = "other convolutions"
        elif "batch_norm" in opname:
            group = "batch norm"
        elif "copy" in opname or "contiguous" in opname or "cat" in opname \
                or "stack" in opname or "clone" in opname:
            group = "copies, cat, stack"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + dur
        total += dur
    log("profile", f"{name}: device time by launching op, of {total / 1e3:.3f}"
        " ms of kernels: " + ", ".join(
            f"{g} {t / 1e3:.3f} ms ({t / total * 100:.1f}%)"
            for g, t in sorted(groups.items(), key=lambda kv: -kv[1])))
    for kname, (t, calls) in sorted(dw_kernels.items(),
                                    key=lambda kv: -kv[1][0])[:3]:
        log("profile", f"{name}: depthwise conv kernel {t / 1e3:.3f} ms "
            f"({t / total * 100:.1f}%, {calls} calls): {kname[:140]}")
    counts = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"] in (
                "aten::copy_", "aten::contiguous", "aten::clone"):
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    log("profile", f"{name}: host copy ops {counts or 'none'} for {blocks} "
        "blocks")


def efficient_blocks(model):
    from efficient_slowfast_tpu_torch.models import (ghostnet, mobilenetv2,
                                                     shufflenet, shufflenetv2)

    kinds = (shufflenetv2.InvertedResidual, shufflenet.Bottleneck,
             mobilenetv2.InvertedResidual, ghostnet.GhostBottleneck)
    return sum(isinstance(m, kinds) for m in model.modules())


def phase_efficient_kernels(smi):
    """3b and 3c at the families' fusion shapes: K2 at every fusion above
    TPU.FLASH_MIN_TOKENS at the 30-view batch (64 clips), K2-bwd at the
    trained families' at their training batch (64 clips), q and k scaled to
    logits of std ATTN_LOGIT_STD. Returns (rows per family, worst bf16
    error forward, backward)."""
    from efficient_slowfast_tpu_torch.models import build_model

    rows = {}
    for name in EFFICIENT_YAMLS:
        cfg = efficient_cfg(name)
        model = build_model(cfg, device="cuda")
        rows[name] = efficient_rows(cfg, model, TEST_CLIPS)
        launches = sum(r[5] for r in rows[name])
        log("efficient", f"{name} ({EFFICIENT_YAMLS[name]}): "
            f"{efficient_blocks(model)} blocks, "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
            f"parameters; fusions " + ", ".join(
                f"{r[0]} N {r[1]} D {r[3]}{' (K2)' if r[5] else ''}"
                for r in rows[name]) + f"; K2 launches a forward {launches}")
        if launches != EFFICIENT_K2[name]:
            raise AssertionError(f"{name}: {launches} K2 launches a forward,"
                                 f" expected {EFFICIENT_K2[name]}")
        del model
    unique = {}
    for name in EFFICIENT_YAMLS:
        for r in rows[name]:
            if r[5]:
                unique.setdefault(r[1:5], r)
    _, fwd_err, _ = phase_attention(list(unique.values()), smi, off_path=(),
                                    path_batch=TEST_CLIPS,
                                    logit_std=ATTN_LOGIT_STD)
    trained = {}
    for name in EFFICIENT_TRAINED:
        for r in rows[name]:
            if r[5]:
                trained.setdefault(r[1:5], r[:6])
    _, bwd_err, _ = phase_attention_backward(
        list(trained.values()), smi, off_path=(),
        batch=EFFICIENT_TRAIN_CLIPS, logit_std=ATTN_LOGIT_STD)
    torch.cuda.empty_cache()
    return rows, fwd_err, bwd_err


def phase_efficient(smi):
    """Phase 12: the four efficient families served (three 4-clip requests
    against TPU.FLASH_ATTENTION False, then f32 on one clip), 30-view
    tested, and ShuffleNetV2 and GhostNet trained (64 clips a step), K2 in
    every forward and K2-bwd in every backward. Returns the launch counts
    of its main-path runs, summed."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL

    none = {"fused_bottleneck": 0, "flash_attention": 0,
            "flash_attention_backward": 0, "int8_conv": 0}
    totals = dict(none)

    def add(counts):
        for key, value in counts.items():
            totals[key] += value

    for name in EFFICIENT_YAMLS:
        short = name[len("SlowFast"):].lower()
        per_request = EFFICIENT_K2[name]
        cfg = efficient_cfg(name)
        model = serving_model(cfg, SEED + 30)
        calibrate_attention(cfg, model, SEED + 31, "efficient")
        calibrate_head(cfg, model, SEED + 31, "efficient")
        cfg_plain = efficient_cfg(name, flash=False)
        log("efficient", f"{name}: serving {REQUESTS} requests of "
            f"{CLIPS_PER_REQUEST} clips ({cfg.DATA.NUM_FRAMES} frames, "
            f"{cfg.DATA.TEST_CROP_SIZE}², bf16), scores "
            + ("probabilities" if probabilities(cfg)
               else "mean ReLU(logits)"))
        fwd = make_forward(cfg, model)
        counts, request_s = serve_and_compare(
            "efficient", cfg, fwd,
            make_forward(cfg_plain, model_with(cfg_plain,
                                               model.state_dict())),
            ("flash kernel", "plain attention"),
            {**none, "flash_attention": per_request * REQUESTS},
            CMDA_BF16_ATOL, SEED + 32, smi)
        add(counts)
        log("efficient", f"{name} bf16 serving: {request_s * 1e3:.2f} ms a "
            f"{CLIPS_PER_REQUEST}-clip request, "
            f"{CLIPS_PER_REQUEST / request_s:.2f} clips/s, K2 launches a "
            f"request {counts['flash_attention'] // REQUESTS} | {smi}")
        req = clips(cfg, CLIPS_PER_REQUEST,
                    torch.Generator().manual_seed(SEED + 36), torch.bfloat16)
        trace_window(f"efficient_serve_{short}", lambda: fwd(req), top_n=8)
        op_breakdown(f"efficient_serve_{short}", efficient_blocks(model))
        state = {k: v.clone() for k, v in model.state_dict().items()}
        del model, fwd
        torch.cuda.empty_cache()
        cfg32, cfg32_plain = (efficient_cfg(name, "float32"),
                              efficient_cfg(name, "float32", flash=False))
        compare_one_clip("efficient", cfg32,
                         make_forward(cfg32, model_with(cfg32, state)),
                         make_forward(cfg32_plain,
                                      model_with(cfg32_plain, state)),
                         ("flash kernel", "plain attention"), CMDA_F32_ATOL,
                         SEED + 33, smi)
        del state
        torch.cuda.empty_cache()

        # the 30-view test, against test() without the kernels
        counts, means, cfg, model = phase_thirty_view(
            EFFICIENT_YAMLS[name], False,
            {**none, "flash_attention": per_request}, smi)
        add(counts)
        op_breakdown(f"thirty_view_{name}", efficient_blocks(model))
        phase_thirty_view_reference(cfg, model, means,
                                    ["TPU.FLASH_ATTENTION", False],
                                    "flash attention", smi)
        del model
        torch.cuda.empty_cache()

        if name not in EFFICIENT_TRAINED:
            continue
        # training as the yaml trains, 64 clips a step; then one clip's
        # step in f32 and bf16 with every attention call held against the
        # plain versions on its inputs (phase 11's rule)
        phase = f"efficient_{short}"
        cfg = efficient_cfg(name)
        model = serving_model(cfg, SEED + 34)
        calibrate_attention(cfg, model, SEED + 35, phase)
        state = {k: v.clone() for k, v in model.state_dict().items()}
        _, _, counts, _ = train_steps(
            phase, cfg, model,
            {**none, "flash_attention": per_request * TRAIN_STEPS,
             "flash_attention_backward":
                 per_request * BACKWARD_LAUNCHES_PER_CALL * TRAIN_STEPS, "int8_conv": 0},
            smi, batch=EFFICIENT_TRAIN_CLIPS)
        add(counts)
        log(phase, f"K2-bwd launches a train step "
            f"{counts['flash_attention_backward'] // TRAIN_STEPS} "
            f"({per_request} calls of {BACKWARD_LAUNCHES_PER_CALL} launches)")
        op_breakdown(phase, efficient_blocks(model))
        del model
        torch.cuda.empty_cache()
        hold_one_clip_attention(
            phase, lambda dtype, flash, name=name: efficient_cfg(
                name, dtype, flash), state, per_request, smi)
        del state
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 13: AVA detection
AVA_YAML = os.path.join(ROOT, "configs", "AVA", "SLOWFAST_32x2_R50_SHORT.yaml")
AVA_SLOW_YAML = os.path.join(ROOT, "configs", "AVA", "SLOW_8x8_R50_SHORT.yaml")
# the split the smoke writes: videos a split, 8 labelled keyframes each (64
# train, 32 val), at seconds that are multiples of 4, so that the val
# epoch's every-fourth-second rule keeps them all
AVA_VIDEOS = {"train": 8, "val": 4}
AVA_SECONDS = [904 + 4 * i for i in range(8)]
AVA_FRAME_HW = (320, 568)  # 16:9, as AVA's movies
AVA_JPEGS = 64  # distinct JPEGs a video: frame i shows JPEG i % 64
# one excluded val keyframe (the evaluator drops it from GT and detections)
AVA_EXCLUDED = ("val00", AVA_SECONDS[-1])


def write_ava_split(root):
    """AVA's files for a seeded split under ``root``, in the shape of
    tests/test_ava.py::make_ava_fixture: JPEG frames at AVA_FRAME_HW,
    frame lists, train boxes with 1-3 of the 80 action labels each (2-6
    people a keyframe), val person boxes as a detector gives them (scored,
    some below AVA.DETECTION_SCORE_THRESH, one false positive a keyframe),
    val ground truth, a label map of the 80 ids and one exclusion."""
    from PIL import Image

    rs = np.random.RandomState(SEED + 13)
    dirs = {k: os.path.join(root, k) for k in ("frames", "lists", "ann")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    h, w = AVA_FRAME_HW
    n_frames = (AVA_SECONDS[-1] - 900) * 30 + 64  # past the last window
    csv = {"train_gt": [], "val_gt": [], "val_pred": []}
    for split, count in AVA_VIDEOS.items():
        lines = ["original_vido_id video_id frame_id path labels"]
        for v in range(count):
            name = f"{split}{v:02d}"
            os.makedirs(os.path.join(dirs["frames"], name), exist_ok=True)
            # smooth seeded content (16-pixel cells), moving a cell a frame
            cells = rs.randint(0, 256, (h // 16 + 5, w // 16 + 5, 3), np.uint8)
            big = np.repeat(np.repeat(cells, 16, 0), 16, 1)
            for j in range(AVA_JPEGS):
                y, x = 16 * (j % 4), 16 * (j // 16)
                Image.fromarray(big[y:y + h, x:x + w]).save(
                    os.path.join(dirs["frames"], name, f"{j:03d}.jpg"),
                    quality=90)
            lines += [f"{name} {v} {i} {name}/{i % AVA_JPEGS:03d}.jpg \"\""
                      for i in range(n_frames)]
            for sec in AVA_SECONDS:
                for person in range(rs.randint(2, 7)):
                    x1, y1 = rs.uniform(0.0, 0.6, 2)
                    x2 = min(1.0, x1 + rs.uniform(0.1, 0.4))
                    y2 = min(1.0, y1 + rs.uniform(0.25, 0.6))
                    box = f"{x1:.3f},{y1:.3f},{x2:.3f},{y2:.3f}"
                    for act in rs.choice(np.arange(1, 81), rs.randint(1, 4),
                                         replace=False):
                        csv[f"{split}_gt"].append(
                            f"{name},{sec},{box},{act},{person}")
                    if split == "val":
                        j = np.clip(np.array([x1, y1, x2, y2])
                                    + rs.uniform(-0.02, 0.02, 4), 0, 1)
                        csv["val_pred"].append(
                            f"{name},{sec}," + ",".join(f"{c:.3f}" for c in j)
                            + f",,{rs.uniform(0.85, 1.0):.3f}")
                if split == "val":
                    csv["val_pred"] += [
                        f"{name},{sec},0.700,0.100,0.950,0.600,,0.900",
                        f"{name},{sec},0.050,0.050,0.300,0.400,,0.300"]
        with open(os.path.join(dirs["lists"], f"{split}.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    for key, rows in csv.items():
        with open(os.path.join(dirs["ann"], f"{key}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(dirs["ann"], "labels.pbtxt"), "w") as f:
        f.write("".join(f'item {{\n  name: "action{i}"\n  id: {i}\n}}\n'
                        for i in range(1, 81)))
    with open(os.path.join(dirs["ann"], "excl.csv"), "w") as f:
        f.write(f"{AVA_EXCLUDED[0]},{AVA_EXCLUDED[1]}\n")
    return dirs


def ava_opts(dirs):
    """The split's locations (the yamls name AVA's own files)."""
    return ["AVA.FRAME_DIR", dirs["frames"],
            "AVA.FRAME_LIST_DIR", dirs["lists"],
            "AVA.ANNOTATION_DIR", dirs["ann"],
            "AVA.TRAIN_LISTS", "['train.csv']", "AVA.TEST_LISTS", "['val.csv']",
            "AVA.TRAIN_GT_BOX_LISTS", "['train_gt.csv']",
            "AVA.TRAIN_PREDICT_BOX_LISTS", "[]",
            "AVA.TEST_PREDICT_BOX_LISTS", "['val_pred.csv']",
            "AVA.GROUNDTRUTH_FILE", "val_gt.csv",
            "AVA.LABEL_MAP_FILE", "labels.pbtxt",
            "AVA.EXCLUSION_FILE", "excl.csv",
            "DATA_LOADER.NUM_WORKERS", LOADER_WORKERS]


def ava_cfg(yaml, dirs, dtype="bfloat16", *opts):
    from efficient_slowfast_tpu_torch.config import load_cfg

    return load_cfg(yaml, ava_opts(dirs) + ["TPU.COMPUTE_DTYPE", dtype]
                    + list(opts))


def detection_rows(cfg, model, hw, batch):
    """The CMDA fusions' attention over the slow frames at input size
    ``hw`` (the stem's two stride-2 ops and s3's and s4's): [(label, N, M,
    D, C, K2 launches a forward, batch)]; a fusion of at most
    TPU.FLASH_MIN_TOKENS tokens takes the dense branch (none at the yaml's
    sizes: N >= 1568)."""
    t = cfg.DATA.NUM_FRAMES // cfg.SLOWFAST.ALPHA
    h, w = -(-hw[0] // 4), -(-hw[1] // 4)
    rows = []
    for i, (name, att) in enumerate(fusions(model)):
        if i:
            s = cfg.RESNET.SPATIAL_STRIDES[i - 1][0]
            h, w = -(-h // s), -(-w // s)
        n = t * h * w
        rows.append((f"det {name} {hw[0]}x{hw[1]}", n, n,
                     att.query_conv.out_channels, att.value_conv.out_channels,
                     int(n > cfg.TPU.FLASH_MIN_TOKENS), batch))
    return rows


class Spans:
    """Device time of the kernels launched inside named spans of a traced
    window: ``wrap(name, fn)`` gives ``fn`` under ``profiler.annotate``."""

    @staticmethod
    def wrap(name, fn):
        from efficient_slowfast_tpu_torch.utils import profiler

        def run(*a, **k):
            with profiler.annotate(name):
                return fn(*a, **k)
        return run

    @staticmethod
    def shares(trace_name, names):
        """{name: (kernel ms inside its spans, share of all kernel time)}."""
        from efficient_slowfast_tpu_torch.utils import profiler

        with open(os.path.join(smoke_dir(), f"profile_{trace_name}",
                               profiler.TRACE_FILE)) as f:
            events = json.load(f)["traceEvents"]
        spans = {n: [(e["ts"], e["ts"] + e["dur"], e.get("tid"))
                     for e in events if e.get("name") == n
                     and e.get("cat") == "user_annotation"] for n in names}
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") == "cuda_runtime"
                    and "correlation" in e.get("args", {})}
        inside = dict.fromkeys(names, 0.0)
        total = 0.0
        for k in (e for e in events if e.get("cat") == "kernel"):
            total += k["dur"]
            launch = launches.get(k.get("args", {}).get("correlation"))
            if launch is None:
                continue
            for n in names:
                if any(a <= launch["ts"] <= b and tid == launch.get("tid")
                       for a, b, tid in spans[n]):
                    inside[n] += k["dur"]
        return {n: (t / 1e3, t / max(total, 1e-9)) for n, t in inside.items()}


def first_batches(loader, count):
    """The first ``count`` batches of ``loader`` on the card (pinned ring,
    side-stream copy)."""
    from efficient_slowfast_tpu_torch.data.loader import prefetch_to_device

    out = []
    batches = prefetch_to_device(loader, "cuda")
    try:
        for batch in batches:
            out.append(batch)
            if len(out) == count:
                break
    finally:
        batches.close()
    torch.cuda.synchronize()
    return out


def detection_scores_check(scores, rows, what):
    if scores.shape != (rows, 80) or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"{what}: scores {tuple(scores.shape)} not "
                             f"finite or not ({rows}, 80)")
    if scores.min().item() < 0 or scores.max().item() > 1:
        raise AssertionError(f"{what}: sigmoid scores outside [0, 1]")


def head_logits(fwd, model, inputs, boxes):
    """(``fwd``'s scores, the RoI head's logits: its projection's output
    in float32)."""
    seen = {}
    hook = model.head.projection.register_forward_hook(
        lambda m, i, o: seen.update(x=o.float()))
    try:
        scores = fwd(inputs, boxes)
    finally:
        hook.remove()
    return scores, seen["x"]


def phase_detection_serving(dirs, smi):
    """SlowFast-R50 32x2 AVA served through perform_detection_test and
    test(); SLOW 8x8 served beside it. Returns the launch counts."""
    from efficient_slowfast_tpu_torch.data.ava_dataset import MAX_BOXES
    from efficient_slowfast_tpu_torch.data.loader import construct_loader
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_detection_preprocess
    from efficient_slowfast_tpu_torch.engine.state import \
        make_detection_forward
    from efficient_slowfast_tpu_torch.engine.test import (
        perform_detection_test, test)
    from efficient_slowfast_tpu_torch.models import detection
    from efficient_slowfast_tpu_torch.utils.meters import AVAMeter, StageTimes

    cfg = ava_cfg(AVA_YAML, dirs)
    model = serving_model(cfg, SEED)
    loader = construct_loader(cfg, "test")
    n_clips = len(loader.dataset)
    log("detection", f"SlowFast-R50 32x2 AVA ({os.path.relpath(AVA_YAML, ROOT)}"
        f", 80 classes, bf16, seeded weights): {n_clips} val keyframes in "
        f"{len(loader)} batches of {loader.batch_size}, {MAX_BOXES} box slots "
        f"a clip, "
        f"canvas {loader.dataset.frames_shape()} uint8, "
        f"{cfg.DATA_LOADER.NUM_WORKERS} loader threads")
    pre = make_detection_preprocess(cfg, torch.bfloat16)
    fwd = make_detection_forward(cfg, model)
    (first,) = first_batches(loader, 1)
    inputs = pre(first["frames"])
    rows = first["boxes"].shape[0] * first["boxes"].shape[1]
    reset_counts()
    out = fwd(inputs, first["boxes"])
    torch.cuda.synchronize()
    counts = read_counts()
    detection_scores_check(out, rows, "detection serving")
    if any(counts.values()):
        raise AssertionError(f"detection serving launched {counts}")
    # the forward alone on the resident batch
    fwd_ms = cuda_ms(lambda: fwd(inputs, first["boxes"]), iters=3, reps=3)

    times = StageTimes()
    meter = AVAMeter(len(loader), cfg, mode="test")
    meter.video_idx_to_name = loader.dataset._video_idx_to_name
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    perform_detection_test(cfg, model, loader, meter, times=times)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    run_counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    boxes = sum(len(p) for p in meter.all_preds)
    mAP = meter.finalize_metrics()
    split = {k: statistics.mean(v) for k, v in times.summary().items()}
    b = loader.batch_size
    log("detection", f"serving, {len(loader)} batches of {b} clips, "
        f"{rows} box slots a batch, {boxes} real boxes: end to end "
        f"{dt / len(loader) * 1e3:.2f} ms a batch, {n_clips / dt:.2f} clips/s"
        f", {boxes / dt:.2f} boxes/s | forward alone on a resident batch "
        f"{fwd_ms:.2f} ms, {b / fwd_ms * 1e3:.2f} clips/s, "
        f"{boxes / len(loader) / fwd_ms * 1e3:.2f} boxes/s | per batch "
        f"mean: wait {split['wait']:.2f}, copy {split['copy']:.2f}, "
        f"preprocess {split['preprocess']:.2f}, forward "
        f"{split['forward']:.2f} ms | kernel launches {run_counts} | peak "
        f"memory {peak / 2 ** 30:.2f} GiB | mAP {mAP:.4f} | {smi}")
    if any(run_counts.values()):
        raise AssertionError(f"detection serving launched {run_counts}")
    if not 0.0 <= mAP <= 1.0:
        raise AssertionError(f"detection serving mAP {mAP}")

    # one batch traced, the RoI head and its ROIAlign calls in spans
    orig_head, orig_roi = model.head.forward, detection.roi_align
    model.head.forward = Spans.wrap("smoke_roi_head", orig_head)
    detection.roi_align = Spans.wrap("smoke_roi_align", orig_roi)
    try:
        share, window_ms, _, _ = trace_window(
            "detection_serving", lambda: fwd(pre(first["frames"]),
                                             first["boxes"]))
    finally:
        model.head.forward, detection.roi_align = orig_head, orig_roi
    parts = Spans.shares("detection_serving",
                         ["smoke_roi_head", "smoke_roi_align"])
    log("detection", f"serving, one traced batch: device busy "
        f"{share * 100:.1f}% of {window_ms:.2f} ms | the RoI head "
        f"{parts['smoke_roi_head'][0]:.3f} ms "
        f"({parts['smoke_roi_head'][1] * 100:.2f}% of the device time), of "
        f"which ROIAlign {parts['smoke_roi_align'][0]:.3f} ms "
        f"({parts['smoke_roi_align'][1] * 100:.2f}%) | {smi}")

    # one clip in bf16 against float32, the same weights and boxes; held
    # on the real boxes' logits, not their scores: the RoI head's sigmoid
    # scores sit near 0.5, where bf16 roundings through the ~50 layers
    # (TEST_LOGIT_TOL's estimate: a few % of the logits' spread) move a
    # score by a quarter of its logit's change, far more than they move a
    # softmax probability over 400 classes (CMDA_BF16_ATOL's unit)
    cfg32 = ava_cfg(AVA_YAML, dirs, "float32")
    m32 = model_with(cfg32, model.state_dict())
    x32 = make_detection_preprocess(cfg32)(first["frames"][:1])
    p32, l32 = head_logits(make_detection_forward(cfg32, m32), m32, x32,
                           first["boxes"][:1])
    p16, l16 = head_logits(fwd, model, [x[:1] for x in inputs],
                           first["boxes"][:1])
    real = first["box_mask"][0].cuda() > 0
    p32, p16, l32, l16 = p32[real], p16[real], l32[real], l16[real]
    err = (l16 - l32).abs().max().item()
    scale = l32.abs().max().item()
    log("detection", f"one clip, bf16 vs float32 on the same weights and "
        f"{int(real.sum())} boxes: logits max |d| {err:.3e} (tol "
        f"{TEST_LOGIT_TOL * scale:.3e}: {TEST_LOGIT_TOL} of their scale "
        f"{scale:.3f}), scores max |d| "
        f"{(p16 - p32).abs().max().item():.3e} | {smi}")
    if not err <= TEST_LOGIT_TOL * scale:
        raise AssertionError(f"detection bf16 vs f32 {err}")
    del m32, x32

    # test(), the entry point, from a .pyth of the same weights
    path = os.path.join(smoke_dir(), "ava_slowfast.pyth")
    torch.save({"model_state": model.state_dict()}, path)
    tcfg = cfg.clone()
    tcfg.merge_from_list(["TEST.CHECKPOINT_FILE_PATH", path,
                          "OUTPUT_DIR", smoke_dir()])
    reset_counts()
    t0 = time.perf_counter()
    tmeter = test(tcfg)
    dt_test = time.perf_counter() - t0
    test_counts = read_counts()
    log("detection", f"test() from the .pyth: mAP {tmeter.full_map:.4f} "
        f"(perform_detection_test's {mAP:.4f}) in {dt_test:.2f} s with the "
        f"model's build and load, kernel launches {test_counts} | {smi}")
    if not 0.0 <= tmeter.full_map <= 1.0 or any(test_counts.values()):
        raise AssertionError(f"test(): mAP {tmeter.full_map}, launches "
                             f"{test_counts}")
    del model, inputs, first
    torch.cuda.empty_cache()

    # SLOW 8x8: the single-pathway branch, a forward and its time
    scfg = ava_cfg(AVA_SLOW_YAML, dirs)
    smodel = serving_model(scfg, SEED)
    (sb,) = first_batches(construct_loader(scfg, "test"), 1)
    sx = make_detection_preprocess(scfg, torch.bfloat16)(sb["frames"])
    sfwd = make_detection_forward(scfg, smodel)
    reset_counts()
    sout = sfwd(sx, sb["boxes"])
    torch.cuda.synchronize()
    slow_counts = read_counts()
    detection_scores_check(sout, rows, "SLOW 8x8 detection")
    s_ms = cuda_ms(lambda: sfwd(sx, sb["boxes"]), iters=3, reps=3)
    log("detection", f"SLOW-R50 8x8 AVA ({os.path.relpath(AVA_SLOW_YAML, ROOT)}"
        f", one pathway of {scfg.DATA.NUM_FRAMES} frames): forward of "
        f"{sb['frames'].shape[0]} clips {s_ms:.2f} ms on a resident batch, "
        f"kernel launches {slow_counts} | {smi}")
    if any(slow_counts.values()):
        raise AssertionError(f"SLOW detection launched {slow_counts}")
    del smodel, sx, sb
    torch.cuda.empty_cache()
    return run_counts


def calibrate_detection_attention(cfg, model, inputs, boxes, phase):
    """calibrate_attention for a detection model: its logits measured on
    one clip of ``inputs`` with its ``boxes``."""
    from efficient_slowfast_tpu_torch.engine.state import \
        make_detection_forward

    fwd = make_detection_forward(cfg, model)
    calibrate_attention(cfg, model, None, phase,
                        run=lambda: fwd([x[:1] for x in inputs], boxes[:1]))


def k2_shapes_of(run, calls=None):
    """(result of ``run()``, the (B, N, M, D, C) of each K2 call in it);
    ``calls``, where given, gets each call's (q, k, v, output)."""
    from efficient_slowfast_tpu_torch.ops import attention

    orig, seen = attention.flash_attention, []

    def recorded(q, k, v):
        seen.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                     v.shape[2]))
        out = orig(q, k, v)
        if calls is not None:
            calls.append((q, k, v, out))
        return out

    attention.flash_attention = recorded
    try:
        return run(), seen
    finally:
        attention.flash_attention = orig


def detection_train_batches(cfg, loader, count, dtype):
    """``count`` train batches of ``loader`` through the detection train
    preprocess on the card: [(inputs, boxes, labels, mask)]."""
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_detection_train_preprocess
    from efficient_slowfast_tpu_torch.engine.state import step_generator

    pre = make_detection_train_preprocess(cfg, dtype)
    out = []
    for i, b in enumerate(first_batches(loader, count)):
        x, boxes = pre(step_generator(cfg.RNG_SEED, i, "cuda"), b["frames"],
                       b["width"], b["boxes"])
        out.append((x, boxes, b["box_labels"].cuda(), b["box_mask"].cuda()))
    return out


def one_detection_step(cfg, state_dict, batch, seed):
    """``one_step`` for the detection train step."""
    from efficient_slowfast_tpu_torch.engine.state import (
        create_train_state, make_detection_train_step)

    model = model_with(cfg, state_dict)
    state = create_train_state(cfg, model)
    step = make_detection_train_step(cfg, state.model, state.optimizer)
    step(state, *batch, cfg.SOLVER.BASE_LR,
         torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_detection_cmda(dirs, smi):
    """CMDA detection: 3b at its serving shapes and 3c at its training
    shapes, then served (8 clips, K2 4 a forward) against the plain
    attention and trained (16 clips, 224²: K2 4 and K2-bwd 12 a step).
    Returns (K2 record, K2 error, K2-bwd record, K2-bwd error, counts)."""
    from efficient_slowfast_tpu_torch.data.loader import construct_loader
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_detection_preprocess
    from efficient_slowfast_tpu_torch.engine.state import (
        create_train_state, make_detection_forward, make_detection_train_step)
    from efficient_slowfast_tpu_torch.ops.kernels import \
        flash_attention as fa

    cmda = ["MODEL.MODEL_NAME", "SlowFastDualAttention"]
    cfg = ava_cfg(AVA_YAML, dirs, "bfloat16", *cmda)
    model = serving_model(cfg, SEED)
    canvas = construct_loader(cfg, "test").dataset.frames_shape()[1:3]
    train_hw = (cfg.DATA.TRAIN_CROP_SIZE,) * 2
    # the yaml's batches: TEST.BATCH_SIZE 8, TRAIN.BATCH_SIZE 16 on its
    # NUM_GPUS 1
    test_b, train_b = cfg.TEST.BATCH_SIZE, cfg.TRAIN.BATCH_SIZE
    serve_rows = detection_rows(cfg, model, canvas, test_b)
    train_rows = detection_rows(cfg, model, train_hw, train_b)
    k2_record, k2_err, _ = phase_attention(serve_rows, smi, off_path=(),
                                           path_batch=test_b)
    bwd_record, bwd_err, _ = phase_attention_backward(
        [r[:6] for r in train_rows], smi, off_path=(), batch=train_b)
    torch.cuda.empty_cache()
    totals = {"fused_bottleneck": 0, "flash_attention": 0,
              "flash_attention_backward": 0, "int8_conv": 0}

    # serving: one val batch, against TPU.FLASH_ATTENTION False
    loader = construct_loader(cfg, "test")
    (batch,) = first_batches(loader, 1)
    inputs = make_detection_preprocess(cfg, torch.bfloat16)(batch["frames"])
    boxes = batch["boxes"]
    calibrate_detection_attention(cfg, model, inputs, boxes, "detection")
    fwd = make_detection_forward(cfg, model)
    fwd(inputs, boxes)  # warm-up
    reset_counts()
    out, shapes = k2_shapes_of(lambda: fwd(inputs, boxes))
    torch.cuda.synchronize()
    counts = read_counts()
    want = [(test_b,) + r[1:5] for r in serve_rows if r[5]]
    if counts["flash_attention"] != len(want) or shapes != want:
        raise AssertionError(f"CMDA detection forward: K2 {counts}, shapes "
                             f"{shapes}, expected {len(want)} at {want}")
    for k, v in counts.items():
        totals[k] += v
    detection_scores_check(out, boxes.numel() // 4, "CMDA detection")
    k_ms = cuda_ms(lambda: fwd(inputs, boxes), iters=2, reps=3)
    # each K2 call of the forward against the plain version on its inputs
    calls = []
    _, shapes = k2_shapes_of(lambda: fwd(inputs, boxes), calls)
    worst = max((o.float() - fa.chunked_attention(q, k, v).float()).abs()
                .max().item() / max(1.0, o.float().abs().max().item())
                for q, k, v, o in calls)
    del calls
    # the whole forward: with calibrated attention over 65536 keys this
    # random-weight network carries one bf16 rounding of an attention
    # output to the head's logits at their own scale (on an H100 the plain
    # path's logits moved by 11.7 of 27.6 when one bf16 rounding was added
    # to its attention outputs, as far as the kernel's differ), so no
    # bf16 path matches another element for element. As phase 7 holds a
    # bf16 step: the kernel's bf16 logits no farther from the float32 plain
    # path's than the bf16 plain path's are, in L2 over the real boxes,
    # within CMDA_TRAIN_BF16_RATIO
    state = model.state_dict()
    paths = {}
    for name, dtype, flash in (("plain bf16", "bfloat16", False),
                               ("plain f32", "float32", False)):
        pcfg = ava_cfg(AVA_YAML, dirs, dtype, *cmda, "TPU.FLASH_ATTENTION",
                       flash)
        pmodel = model_with(pcfg, state)
        pfwd = make_detection_forward(pcfg, pmodel)
        x = inputs if dtype == "bfloat16" else make_detection_preprocess(
            pcfg)(batch["frames"])
        reset_counts()
        paths[name] = head_logits(pfwd, pmodel, x, boxes)
        torch.cuda.synchronize()
        if any(read_counts().values()):
            raise AssertionError(f"the plain attention launched "
                                 f"{read_counts()}")
        if name == "plain bf16":
            p_ms = cuda_ms(lambda: pfwd(inputs, boxes), iters=1, reps=2)
        del pmodel, pfwd, x
    _, lk = head_logits(fwd, model, inputs, boxes)
    real = (batch["box_mask"].reshape(-1) > 0).cuda()
    l32 = paths["plain f32"][1][real]
    d_k = (lk[real] - l32).norm().item()
    d_p = (paths["plain bf16"][1][real] - l32).norm().item()
    score_err = (out - paths["plain bf16"][0]).abs().max().item()
    log("detection", f"CMDA detection serving, {test_b} clips, "
        f"bf16: K2 launches {counts['flash_attention']} at (B, N, M, D, C) "
        f"{shapes} | each K2 call vs the plain version on its inputs "
        f"{worst:.3e} of the scale (tol {ATTN_BF16_TOL}) | the real boxes' "
        f"logits from the f32 plain path's, L2: with K2 {d_k:.4e}, plain "
        f"bf16 {d_p:.4e} (ratio {d_k / max(d_p, 1e-30):.3f}, tol "
        f"{CMDA_TRAIN_BF16_RATIO}; f32 plain logits' norm {l32.norm():.4e})"
        f" | scores vs the bf16 plain path max |d| {score_err:.3e} | "
        f"forward {k_ms:.2f} ms with K2, {p_ms:.2f} ms with the plain "
        f"(chunked) attention | {smi}")
    if worst > ATTN_BF16_TOL or d_k > CMDA_TRAIN_BF16_RATIO * d_p:
        raise AssertionError(f"CMDA detection bf16: K2 calls {worst}, "
                             f"logits {d_k} vs plain bf16's {d_p}")
    del paths
    cfg32 = ava_cfg(AVA_YAML, dirs, "float32", *cmda)
    pcfg32 = ava_cfg(AVA_YAML, dirs, "float32", *cmda,
                     "TPU.FLASH_ATTENTION", False)
    x32 = make_detection_preprocess(cfg32)(batch["frames"][:1])
    o32 = make_detection_forward(cfg32, model_with(cfg32, state))(
        x32, boxes[:1])
    r32 = make_detection_forward(pcfg32, model_with(pcfg32, state))(
        x32, boxes[:1])
    err32 = (o32 - r32).abs().max().item()
    log("detection", f"CMDA detection serving, f32, 1 clip: K2 vs plain "
        f"attention max |d| {err32:.3e} (tol {CMDA_F32_ATOL}) | {smi}")
    if err32 > CMDA_F32_ATOL:
        raise AssertionError(f"CMDA detection f32 vs plain {err32}")
    del model, x32, o32, r32, inputs, batch
    torch.cuda.empty_cache()

    # training: the yaml's 16 clips, 224², from the train split
    tcfg = ava_cfg(AVA_YAML, dirs, "bfloat16", *cmda)
    model = train_model(tcfg, SEED)
    tloader = construct_loader(tcfg, "train")
    batches = detection_train_batches(tcfg, tloader, len(tloader),
                                      torch.bfloat16)
    x0, b0 = batches[0][:2]
    calibrate_detection_attention(tcfg, model, x0, b0, "detection")
    state_dict = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(tcfg, model)
    step = make_detection_train_step(tcfg, state.model, state.optimizer)
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    lr = tcfg.SOLVER.BASE_LR
    pick = lambda i: batches[i % len(batches)]  # noqa: E731
    bn_name, bn = watched_bn(model)
    before = bn.running_mean.clone()
    for i in range(TRAIN_WARMUP):
        step(state, *pick(i), lr, drop)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    mets = [step(state, *pick(i), lr, drop) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_STEPS
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack([m["loss"] for m in mets]).tolist()
    moved = (bn.running_mean - before).abs().max().item()
    log("detection", f"CMDA detection training, bf16, {train_b} "
        f"clips a step at {train_hw[0]}², {TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-up | losses "
        + ", ".join(f"{x:.4f}" for x in losses) + f" | kernel launches "
        f"{counts} | running mean of {bn_name} moved {moved:.3e}")
    log("detection", f"CMDA detection training: {dt * 1e3:.2f} ms a step, "
        f"{train_b / dt:.2f} train clips/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB | {smi}")
    calls = sum(r[5] for r in train_rows)  # 4 at 224²
    expect = {"fused_bottleneck": 0, "flash_attention": calls * TRAIN_STEPS,
              "flash_attention_backward":
                  calls * fa.BACKWARD_LAUNCHES_PER_CALL * TRAIN_STEPS, "int8_conv": 0}
    if counts != expect:
        raise AssertionError(f"CMDA detection training: launches {counts}, "
                             f"expected {expect}")
    if not all(np.isfinite(losses)) or not moved > 0:
        raise AssertionError(f"CMDA detection training: losses {losses}, "
                             f"BN moved {moved}")
    for k, v in counts.items():
        totals[k] += v
    share, window_ms, _, _ = trace_window("detection_cmda_train", lambda: [
        step(state, *pick(i), lr, drop) for i in range(PROFILE_STEPS)])
    log("detection", f"CMDA detection training, {PROFILE_STEPS} steps "
        f"traced: the kernels' union {share * window_ms:.2f} ms, "
        f"{share * window_ms / (PROFILE_STEPS * dt * 1e3) * 100:.1f}% of as "
        f"many untimed steps | {smi}")
    op_breakdown("detection_cmda_train", "all")
    del state, step, model
    torch.cuda.empty_cache()

    def batch_of(cfg_, dtype):
        x, bx, lab, mask = batches[0]
        return ([v[:1].to(dtype) for v in x], bx[:1], lab[:1], mask[:1])

    hold_one_clip_steps(
        "detection", lambda name, flash: ava_cfg(
            AVA_YAML, dirs, name, *cmda, "TPU.FLASH_ATTENTION", flash),
        state_dict, smi, batch_of=batch_of, one=one_detection_step)
    del batches, state_dict
    torch.cuda.empty_cache()
    return k2_record, k2_err, bwd_record, bwd_err, totals


class DetectionRun:
    """What the CLI's AVA run did, seen through its engine's functions:
    each step's seconds and loss, the val and test meters, the
    checkpoints saved and loaded."""

    def __init__(self):
        self.steps, self.val, self.saved, self.loaded = [], [], [], []
        self.trace = None

    def make_step(self, orig):
        def build(cfg, model, optimizer):
            step = orig(cfg, model, optimizer)

            def timed(state, *args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if len(self.steps) == 2:  # the third step traced
                    out = {}
                    self.trace = trace_window(
                        "detection_cli_step",
                        lambda: out.update(step(state, *args)))
                    mets = out
                else:
                    mets = step(state, *args)
                torch.cuda.synchronize()
                self.steps.append((time.perf_counter() - t0,
                                   mets["loss"].item(),
                                   args[0][0].shape[0]))
                return mets
            return timed
        return build

    def perform(self, orig):
        def run(cfg, model, loader, meter, *a, **k):
            self.val.append(meter)
            return orig(cfg, model, loader, meter, *a, **k)
        return run

    def save(self, orig):
        def run(path, state, epoch, cfg):
            out = orig(path, state, epoch, cfg)
            self.saved.append(out)
            return out
        return run

    def load(self, orig):
        def run(path, *a, **k):
            self.loaded.append(path)
            return orig(path, *a, **k)
        return run


def phase_detection_cli(dirs, smi):
    """SlowFast-R50 32x2 AVA through tools/run_net.py: one epoch over the
    64 train keyframes at the yaml's batch, a val mAP and a checkpoint,
    then test() from that checkpoint."""
    import shutil

    from efficient_slowfast_tpu_torch.engine import train as train_engine
    from efficient_slowfast_tpu_torch.tools import run_net
    from efficient_slowfast_tpu_torch.utils import checkpoint as cu

    out_dir = os.path.join(smoke_dir(), "ava_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    batch = ava_cfg(AVA_YAML, dirs).TRAIN.BATCH_SIZE
    argv = ["--cfg", AVA_YAML] + [str(o) for o in ava_opts(dirs)] + [
        "SOLVER.MAX_EPOCH", "1", "OUTPUT_DIR", out_dir]
    rec = DetectionRun()
    patches = [(train_engine, "make_detection_train_step"),
               (train_engine, "perform_detection_test"),
               (cu, "save_checkpoint"), (cu, "load_checkpoint")]
    wraps = [rec.make_step, rec.perform, rec.save, rec.load]
    saved = [getattr(mod, name) for mod, name in patches]
    for (mod, name), wrap, orig in zip(patches, wraps, saved):
        setattr(mod, name, wrap(orig))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        result = run_net.main(argv)
    finally:
        for (mod, name), orig in zip(patches, saved):
            setattr(mod, name, orig)
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [s[1] for s in rec.steps]
    clips = [s[2] for s in rec.steps]
    untraced = [s for i, s in enumerate(rec.steps) if i not in (0, 2)]
    clips_per_s = (sum(s[2] for s in untraced)
                   / max(sum(s[0] for s in untraced), 1e-9))
    val_map = rec.val[0].full_map if rec.val else float("nan")
    test_map = result["test"].full_map
    share, window_ms = rec.trace[0], rec.trace[1]
    log("detection", f"CLI ({os.path.relpath(AVA_YAML, ROOT)}, "
        f"SOLVER.MAX_EPOCH 1): {len(rec.steps)} steps of {clips} clips, "
        f"losses " + ", ".join(f"{x:.4f}" for x in losses) + f" | ms a step "
        + ", ".join(f"{s[0] * 1e3:.1f}" for s in rec.steps)
        + f" (the first with cuDNN's plans, the third traced) | "
        f"{clips_per_s:.2f} train clips/s over the untraced steps after the "
        f"first | traced "
        f"step: device busy {share * 100:.1f}% of {window_ms:.2f} ms | peak "
        f"memory {peak / 2 ** 30:.2f} GiB | val mAP {val_map:.4f}, test mAP "
        f"{test_map:.4f} | checkpoints saved {rec.saved}, loaded "
        f"{rec.loaded} | kernel launches {counts} | {dt:.1f} s | {smi}")
    ckpt = rec.saved[-1] if rec.saved else None
    steps = len(AVA_SECONDS) * AVA_VIDEOS["train"] // batch
    if len(rec.steps) != steps or set(clips) != {batch} or not all(
            np.isfinite(losses)):
        raise AssertionError(f"detection CLI: steps {rec.steps}, expected "
                             f"{steps} of {batch} clips")
    if not (0.0 <= val_map <= 1.0 and 0.0 <= test_map <= 1.0):
        raise AssertionError(f"detection CLI: val mAP {val_map}, test mAP "
                             f"{test_map}")
    if ckpt is None or rec.loaded[-1:] != [ckpt] or any(counts.values()):
        raise AssertionError(f"detection CLI: saved {rec.saved}, test "
                             f"loaded {rec.loaded}, launches {counts}")


def phase_detection(smi):
    """Phase 13: AVA detection on the card. Returns (K2 record, K2 error,
    K2-bwd record, K2-bwd error, the main paths' launch counts)."""
    t0 = time.perf_counter()
    dirs = write_ava_split(os.path.join(smoke_dir(), "ava"))
    log("detection", f"AVA split written in {time.perf_counter() - t0:.1f} s:"
        f" {AVA_VIDEOS['train']} train and {AVA_VIDEOS['val']} val videos, "
        f"{len(AVA_SECONDS)} keyframes each, JPEG frames {AVA_FRAME_HW} read "
        f"with PIL, 80 action ids, exclusion {AVA_EXCLUDED}")
    counts = phase_detection_serving(dirs, smi)
    torch.cuda.empty_cache()
    k2_record, k2_err, bwd_record, bwd_err, cmda_counts = \
        phase_detection_cmda(dirs, smi)
    for k, v in cmda_counts.items():
        counts[k] += v
    torch.cuda.empty_cache()
    phase_detection_cli(dirs, smi)
    torch.cuda.empty_cache()
    log("detection", f"phase 13 in {time.perf_counter() - t0:.1f} s")
    return k2_record, k2_err, bwd_record, bwd_err, counts


# ---------------------------------------------------------------------------
# phase 14: the frame datasets
FATIGUE_CMDA_YAML = os.path.join(
    ROOT, "configs", "TIRED", "DUAL_TIRED_SLOWFAST_8x8_R50_112_GRAY.yaml")
FATIGUE_SF_YAML = os.path.join(ROOT, "configs", "TIRED",
                               "TIRED_SLOWFAST_8x8_R50.yaml")
CHARADES_YAML = os.path.join(ROOT, "configs", "Charades",
                             "SLOWFAST_16x8_R50.yaml")
SSV2_YAML = os.path.join(ROOT, "configs", "SSv2", "SLOWFAST_16x8_R50.yaml")
# the frames the phase writes (the datasets' own are not in the repo):
# JPEGs of 320 x 240, FRAME_JPEGS distinct ones in each of FRAME_FOLDERS
FRAME_HW = (240, 320)
FRAME_FOLDERS, FRAME_JPEGS = 32, 40
# the fatigue split: FATIGUE_STEPS train steps of the yaml's 128 clips, its
# val (and test) list FATIGUE_VIDEOS folders; precise BN cut from the yaml's
# 170 batches to PRECISE_BATCHES
FATIGUE_STEPS, FATIGUE_BATCH, FATIGUE_VIDEOS = 3, 128, 4
PRECISE_BATCHES = 1
# Charades and SSv2: (train videos, val and test videos, frames a video);
# train steps at the yamls' 16 clips
FRAME_LISTS = {"charades": (64, 4, 140), "ssv2": (64, 8, 48)}
FRAME_LIST_STEPS = 1
# the fatigue CMDA's fusions at 112², 16 frames (slow T 2): (N, D = C)
FATIGUE_K2 = [(1568, 8), (1568, 32), (1568, 64)]


def write_frame_split(root):
    """The phase's seeded split under ``root``: FRAME_FOLDERS folders of
    FRAME_JPEGS JPEGs (smooth seeded content, a 16-pixel cell moving a
    frame); the fatigue lists (``folder label`` lines: FATIGUE_STEPS x 128
    train, FATIGUE_VIDEOS val), and the Charades and SSv2 frame lists over
    the same JPEGs (Charades: 1-3 of its 157 labels a video, on every
    frame; SSv2: label jsons of its 174 templates)."""
    from PIL import Image

    rs = np.random.RandomState(SEED + 14)
    h, w = FRAME_HW
    folders = [os.path.join(root, "folders", f"f{k:02d}")
               for k in range(FRAME_FOLDERS)]
    for d in folders:
        os.makedirs(d, exist_ok=True)
        cells = rs.randint(0, 256, (h // 16 + 4, w // 16 + 4, 3), np.uint8)
        big = np.repeat(np.repeat(cells, 16, 0), 16, 1)
        for j in range(FRAME_JPEGS):
            y, x = 16 * (j % 4), 16 * (j // 10)
            Image.fromarray(big[y:y + h, x:x + w]).save(
                os.path.join(d, f"{j:03d}.jpg"), quality=90)
    split = {"root": root}
    fatigue = os.path.join(root, "fatigue")
    os.makedirs(fatigue, exist_ok=True)
    for name, lines in (
            ("train", [(folders[i % FRAME_FOLDERS], i % 3)
                       for i in range(FATIGUE_STEPS * FATIGUE_BATCH)]),
            ("val", [(folders[(16 + v) % FRAME_FOLDERS], v % 3)
                     for v in range(FATIGUE_VIDEOS)])):
        split[f"fatigue_{name}"] = os.path.join(fatigue, f"{name}.txt")
        with open(split[f"fatigue_{name}"], "w") as f:
            f.write("".join(f"{d} {y}\n" for d, y in lines))
    templates = [f"doing thing {k}" for k in range(174)]
    for name, (n_train, n_val, length) in FRAME_LISTS.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        meta = {}
        for part, count in (("train", n_train), ("val", n_val)):
            rows = ["original_vido_id video_id frame_id path labels"]
            meta[part] = []
            for v in range(count):
                vid = f"{name}_{part}{v:02d}"
                k = (v + (0 if part == "train" else n_train)) % FRAME_FOLDERS
                labels = ",".join(str(c) for c in sorted(rs.choice(
                    157, rs.randint(1, 4), replace=False)))
                rows += [f"{vid} {v} {i} folders/f{k:02d}/"
                         f"{i % FRAME_JPEGS:03d}.jpg \"{labels}\""
                         for i in range(length)]
                meta[part].append({"id": vid, "template":
                                   templates[rs.randint(174)].replace(
                                       "thing", "[thing]")})
            with open(os.path.join(d, f"{part}.csv"), "w") as f:
                f.write("\n".join(rows) + "\n")
        if name == "ssv2":
            for part, key in (("train", "train"), ("val", "validation")):
                with open(os.path.join(
                        d, f"something-something-v2-{key}.json"), "w") as f:
                    json.dump(meta[part], f)
            with open(os.path.join(d, "something-something-v2-labels.json"),
                      "w") as f:
                json.dump({t: str(k) for k, t in enumerate(templates)}, f)
    return split


def frame_opts(split, yaml):
    """The split's locations for ``yaml`` (the TIRED yamls name absolute
    lists on their authors' machine)."""
    if os.sep + "TIRED" + os.sep in yaml:
        return ["DATA.PATH_TO_TRAIN_DATA_TXT", split["fatigue_train"],
                "DATA.PATH_TO_VAL_DATA_TXT", split["fatigue_val"]]
    name = "charades" if "Charades" in yaml else "ssv2"
    return ["DATA.PATH_TO_DATA_DIR", os.path.join(split["root"], name),
            "DATA.PATH_PREFIX", split["root"]]


def frame_cfg(yaml, split, dtype="bfloat16", *opts):
    from efficient_slowfast_tpu_torch.config import load_cfg

    return load_cfg(yaml, frame_opts(split, yaml) + [
        "TPU.COMPUTE_DTYPE", dtype, "DATA_LOADER.NUM_WORKERS", LOADER_WORKERS,
        "OUTPUT_DIR", smoke_dir()] + list(opts))


def count_diff(after, before):
    return {k: after[k] - before[k] for k in after}


class FrameRun:
    """What a phase-14 run did, seen through its engine's functions: each
    train step's seconds, loss, clips and kernel launches (the third
    traced); each loop's waits on the loader; the seconds and launches of
    precise BN, the val epoch and the test (its per-batch stage times)."""

    def __init__(self, trace_name):
        self.trace_name = trace_name
        self.steps, self.loops, self.stages = [], [], {}
        self.trace = self.test_times = self.test_meter = None

    def make_step(self, orig):
        def build(cfg, model, optimizer):
            step = orig(cfg, model, optimizer)

            def timed(state, inputs, labels, lr, generator=None):
                torch.cuda.synchronize()
                before = read_counts()
                t0 = time.perf_counter()
                if len(self.steps) == 2:  # the third step traced
                    out = {}
                    self.trace = trace_window(self.trace_name, lambda: out.update(
                        step(state, inputs, labels, lr, generator)))
                    mets = out
                else:
                    mets = step(state, inputs, labels, lr, generator)
                torch.cuda.synchronize()
                self.steps.append(dict(
                    s=time.perf_counter() - t0, loss=mets["loss"].item(),
                    clips=labels.shape[0],
                    counts=count_diff(read_counts(), before)))
                return mets
            return timed
        return build

    def prefetch(self, orig):
        def run(loader, device, depth=2, times=None):
            from efficient_slowfast_tpu_torch.utils.meters import StageTimes

            self.loops.append(StageTimes())
            return orig(loader, device, depth=depth, times=self.loops[-1])
        return run

    def stage(self, name):
        def wrap(orig):
            def run(*a, **k):
                torch.cuda.synchronize()
                before = read_counts()
                t0 = time.perf_counter()
                out = orig(*a, **k)
                torch.cuda.synchronize()
                self.stages[name] = dict(s=time.perf_counter() - t0,
                                         counts=count_diff(read_counts(),
                                                           before))
                return out
            return run
        return wrap

    def perform(self, orig):
        from efficient_slowfast_tpu_torch.utils.meters import StageTimes

        def run(cfg, model, loader, meter, device=None, times=None):
            self.test_times, self.test_meter = StageTimes(), meter
            self.stages["test_batches"] = len(loader)
            return orig(cfg, model, loader, meter, device,
                        times=self.test_times)
        return self.stage("test")(run)

    def patches(self, train=True):
        from efficient_slowfast_tpu_torch.engine import test as test_engine
        from efficient_slowfast_tpu_torch.engine import train as train_engine

        out = [(test_engine, "perform_test", self.perform)]
        if train:
            out += [(train_engine, "make_train_step", self.make_step),
                    (train_engine, "prefetch_to_device", self.prefetch),
                    (train_engine, "calculate_and_update_precise_bn",
                     self.stage("precise_bn")),
                    (train_engine, "eval_epoch", self.stage("val"))]
        return Observed(*out)


def test_line(what, rec, clips, dt, fwd_ms, batch, share, peak, smi):
    """One line of a test run: clips/s end to end and of the forward on a
    resident batch, the per-batch stage means, the traced batch's device
    busy share and peak memory."""
    split = {k: statistics.mean(v) for k, v in rec.test_times.summary().items()}
    log("frames", f"{what} test(): {clips} clips in "
        f"{rec.stages['test_batches']} batches of {batch}, end to end "
        f"{clips / dt:.2f} clips/s ({dt:.2f} s with the model's build and "
        f"load) | forward alone on a resident batch {fwd_ms:.2f} ms, "
        f"{batch / fwd_ms * 1e3:.2f} clips/s | per batch mean: wait on the "
        f"loader {split['wait']:.2f}, copy {split['copy']:.2f}, preprocess "
        f"{split['preprocess']:.2f}, forward {split['forward']:.2f} ms | one "
        f"traced batch: device busy {share * 100:.1f}% | peak memory "
        f"{peak / 2 ** 30:.2f} GiB | {smi}")


def resident_forward(cfg, model, name):
    """(ms of the forward on a resident test batch of ``cfg``'s loader,
    the device-busy share of one traced preprocess + forward)."""
    from efficient_slowfast_tpu_torch.data.loader import construct_loader
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_test_preprocess
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    (b,) = first_batches(construct_loader(cfg, "test"), 1)
    pre = make_test_preprocess(cfg, torch.bfloat16)
    fwd = make_forward(cfg, model)
    inputs = pre(b["frames"], b["width"], b["spatial_idx"], b["portrait"])
    ms = cuda_ms(lambda: fwd(inputs), iters=2, reps=3)
    share, _, _, _ = trace_window(name, lambda: fwd(pre(
        b["frames"], b["width"], b["spatial_idx"], b["portrait"])))
    return ms, share


def resident_step(what, cfg, model, smi, inputs=None, labels=None):
    """The train step of ``model`` (a copy, with a fresh optimizer) alone
    on a resident batch of TRAIN.BATCH_SIZE clips (``inputs`` and
    ``labels``, else seeded ones at the train crop): its ms, clips/s,
    the device-busy share of one traced step and the launches a step."""
    import copy

    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)

    b = cfg.TRAIN.BATCH_SIZE
    model = copy.deepcopy(model)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state.model, state.optimizer)
    if inputs is None:
        crop = cfg.clone()
        crop.DATA.TEST_CROP_SIZE = cfg.DATA.TRAIN_CROP_SIZE
        inputs, labels = train_batches(crop, 1, b, SEED + 15)[0]
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    run = lambda: step(state, inputs, labels, cfg.SOLVER.BASE_LR, drop)  # noqa: E731
    reset_counts()
    run()
    torch.cuda.synchronize()
    counts = read_counts()
    ms = cuda_ms(run, iters=2, reps=3)
    share, window_ms, _, _ = trace_window(
        f"frames_{what.split()[0].lower()}_resident_step", run)
    log("frames", f"{what} train step alone on a resident batch of {b} "
        f"clips at {inputs[-1].shape[2]}²: {ms:.2f} ms, {b / ms * 1e3:.2f} "
        f"clips/s | one traced step: device busy {share * 100:.1f}% of "
        f"{window_ms:.2f} ms | launches a step {counts} | {smi}")
    del state, step, model
    torch.cuda.empty_cache()
    return ms


def run_test(cfg, rec=None):
    """test(cfg) (observed by ``rec`` where given): (meter, seconds,
    launches, peak memory)."""
    from efficient_slowfast_tpu_torch.engine.test import test

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    if rec is None:
        meter = test(cfg)
    else:
        with rec.patches(train=False):
            meter = test(cfg)
    torch.cuda.synchronize()
    return (meter, time.perf_counter() - t0, read_counts(),
            torch.cuda.max_memory_allocated())


def host_breakdown(cfg, clips=8, top=8):
    """Where one loader thread's time goes: ``clips`` train items of
    ``cfg``'s dataset filled on this thread under cProfile, the functions
    with the most time of their own."""
    import cProfile
    import pstats

    from efficient_slowfast_tpu_torch.data.build import build_dataset

    ds = build_dataset(cfg.TRAIN.DATASET, cfg, "train")
    out = np.empty(ds.frames_shape(), np.uint8)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(lambda: [ds.getitem_into(i, out) for i in range(clips)])
    dt = time.perf_counter() - t0
    own = sorted(((v[2], f"{os.path.basename(k[0])}:{k[1]}({k[2]})")
                  for k, v in pstats.Stats(prof).stats.items()),
                 reverse=True)[:top]
    log("frames", f"one loader thread, {clips} {cfg.TRAIN.DATASET} train "
        f"items: {dt / clips * 1e3:.1f} ms a clip under cProfile; own time "
        f"a clip by function: " + "; ".join(
            f"{name} {t / clips * 1e3:.1f} ms" for t, name in own))


def phase_frame_benchmark(split, smi):
    """benchmark_data_loading over the fatigue train split: the loader's
    clips/s alone, no device work. Returns the epoch's clips/s."""
    from efficient_slowfast_tpu_torch.utils import benchmark

    cfg = frame_cfg(FATIGUE_CMDA_YAML, split, "bfloat16",
                    "BENCHMARK.NUM_EPOCHS", 1, "BENCHMARK.LOG_PERIOD", 1)
    records, orig = [], benchmark.log_json_stats
    benchmark.log_json_stats = lambda s: (records.append(dict(s)), orig(s))
    try:
        (seconds,) = benchmark.benchmark_data_loading(cfg)
    finally:
        benchmark.log_json_stats = orig
    windows = [r["clips_per_s"] for r in records
               if r["_type"] == "benchmark_iter"]
    clips = FATIGUE_STEPS * FATIGUE_BATCH
    log("frames", f"benchmark_data_loading, fatigue train split "
        f"({cfg.TRAIN.DATASET}, {clips} clips of {cfg.DATA.NUM_FRAMES} JPEGs "
        f"in batches of {cfg.TRAIN.BATCH_SIZE}, {LOADER_WORKERS} threads on "
        f"{os.cpu_count()} host cores, gray style: read, grey, crop, resize "
        f"to {cfg.DATA.TRAIN_JITTER_SCALES[1]}², rotate, salt): "
        f"{clips / seconds:.2f} clips/s over the epoch ({seconds:.2f} s), by "
        f"batch " + ", ".join(f"{x:.1f}" for x in windows) + " clips/s | "
        f"records {[r['_type'] for r in records]}")
    host_breakdown(cfg)
    types = [r["_type"] for r in records]
    if types != ["benchmark_iter"] * FATIGUE_STEPS + [
            "benchmark_epoch", "benchmark_final"] or not all(
                x > 0 for x in windows):
        raise AssertionError(f"benchmark_data_loading records {records}")
    return clips / seconds


def phase_fatigue_cmda(split, loader_clips_per_s, smi):
    """The fatigue CMDA-R50: 3b and 3c at its fusions (N = M = 1568 at
    64 and 128 clips), then train() and test() through tools/run_net.py,
    and the test's scores against the plain attention. Returns (K2
    record, K2 error, K2-bwd record, K2-bwd error, launch counts)."""
    import shutil

    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL
    from efficient_slowfast_tpu_torch.tools import run_net
    from efficient_slowfast_tpu_torch.utils.checkpoint import \
        get_last_checkpoint

    cfg = frame_cfg(FATIGUE_CMDA_YAML, split)
    test_b, train_b = cfg.TEST.BATCH_SIZE, cfg.TRAIN.BATCH_SIZE
    if train_b != FATIGUE_BATCH:
        raise AssertionError(f"fatigue CMDA: TRAIN.BATCH_SIZE {train_b}")
    model = train_model(cfg, SEED)
    rows = efficient_rows(cfg, model, test_b)
    k2 = [(f"fatigue {r[0].split()[-1]}",) + r[1:] + (train_b,)
          for r in rows if r[5]]
    log("frames", f"fatigue CMDA-R50 ({os.path.relpath(FATIGUE_CMDA_YAML, ROOT)}"
        f", {cfg.TRAIN.DATASET}, {cfg.MODEL.NUM_CLASSES} classes, "
        f"{cfg.DATA.NUM_FRAMES} frames, {cfg.DATA.TEST_CROP_SIZE}², bf16, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.3f} M "
        f"parameters): fusions " + ", ".join(
            f"{r[0].split()[-1]} N {r[1]} D {r[3]}{' (K2)' if r[5] else ''}"
            for r in rows))
    if [(r[1], r[3]) for r in k2] != FATIGUE_K2:
        raise AssertionError(f"fatigue CMDA K2 shapes {k2}")
    k2_record, k2_err, _ = phase_attention(k2, smi, off_path=(),
                                           path_batch=test_b,
                                           logit_std=ATTN_LOGIT_STD)
    bwd_record, bwd_err, _ = phase_attention_backward(
        [r[:6] for r in k2], smi, off_path=(), batch=train_b,
        logit_std=ATTN_LOGIT_STD)
    torch.cuda.empty_cache()

    # train() and test() through the CLI from seeded, calibrated weights
    calibrate_attention(cfg, model, SEED + 14, "frames")
    init = os.path.join(smoke_dir(), "fatigue_cmda_init.pyth")
    torch.save({"model_state": model.state_dict()}, init)
    del model
    torch.cuda.empty_cache()
    out_dir = os.path.join(smoke_dir(), "fatigue_cli")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--cfg", FATIGUE_CMDA_YAML] + [str(o) for o in frame_opts(
        split, FATIGUE_CMDA_YAML)] + [
        "TPU.COMPUTE_DTYPE", "bfloat16", "DATA_LOADER.NUM_WORKERS",
        str(LOADER_WORKERS), "SOLVER.MAX_EPOCH", "1",
        "BN.NUM_BATCHES_PRECISE", str(PRECISE_BATCHES),
        "TRAIN.CHECKPOINT_FILE_PATH", init, "TRAIN.CHECKPOINT_TYPE",
        "pytorch", "OUTPUT_DIR", out_dir]
    rec = FrameRun("frames_fatigue_cmda_step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with rec.patches():
        result = run_net.main(argv)
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = rec.steps
    losses = [s["loss"] for s in steps]
    untraced = [i for i in range(len(steps)) if i not in (0, 2)]
    step_s = sum(steps[i]["s"] for i in untraced) / len(untraced)
    waits = rec.loops[0].summary()["wait"]  # ms, before each step
    e2e = sum(s["clips"] for s in steps) / (
        sum(s["s"] for s in steps) + sum(waits) / 1e3)
    share, window_ms = rec.trace[0], rec.trace[1]
    log("frames", f"fatigue CMDA CLI (train then test, SOLVER.MAX_EPOCH 1, "
        f"precise BN {PRECISE_BATCHES} batches): {len(steps)} steps of "
        f"{[s['clips'] for s in steps]} clips, losses " + ", ".join(
            f"{x:.4f}" for x in losses) + " | ms a step " + ", ".join(
            f"{s['s'] * 1e3:.1f}" for s in steps) + " (the first with cuDNN's"
        f" plans, the third traced) | the step alone {train_b / step_s:.2f} "
        f"clips/s in the pipeline over the untraced steps after the first; "
        f"end to end {e2e:.2f} clips/s over the epoch's steps and waits | "
        f"wait on the loader a step " + ", ".join(
            f"{w:.1f}" for w in waits) + f" ms (the loader alone "
        f"{loader_clips_per_s:.2f} clips/s: {train_b / loader_clips_per_s * 1e3:.0f}"
        f" ms a batch) | traced step: device busy {share * 100:.1f}% of "
        f"{window_ms:.2f} ms | precise BN {rec.stages['precise_bn']['s']:.2f}"
        f" s, val {rec.stages['val']['s']:.2f} s | peak memory "
        f"{peak / 2 ** 30:.2f} GiB | kernel launches {counts} | {dt:.1f} s | "
        f"{smi}")
    bwd = 3 * BACKWARD_LAUNCHES_PER_CALL
    bad = [s["counts"] for s in steps if s["counts"] != {
        "fused_bottleneck": 0, "flash_attention": 3,
        "flash_attention_backward": bwd, "int8_conv": 0}]
    per_forward = {"precise_bn": PRECISE_BATCHES, "val": 1,
                   "test": rec.stages["test_batches"]}
    for name, n in per_forward.items():
        if rec.stages[name]["counts"] != {"fused_bottleneck": 0,
                                          "flash_attention": 3 * n,
                                          "flash_attention_backward": 0, "int8_conv": 0}:
            bad.append((name, rec.stages[name]["counts"]))
    staged = len(steps) * 3 + 3 * sum(per_forward.values())
    # the one forward left is log_model_info's (a 1-clip FLOP count)
    if (bad or len(steps) != FATIGUE_STEPS or counts != {
            "fused_bottleneck": 0, "flash_attention": staged + 3,
            "flash_attention_backward": bwd * len(steps), "int8_conv": 0}
            or not all(np.isfinite(losses))):
        raise AssertionError(f"fatigue CMDA CLI: steps {steps}, stages "
                             f"{rec.stages}, launches {counts}")

    resident_step("fatigue CMDA", frame_cfg(FATIGUE_CMDA_YAML, split),
                  result["train"].model, smi)

    # the test: its line, then its scores against the plain attention
    meter = result["test"]
    clips = len(meter.clip_count) * meter.num_clips
    tcfg = frame_cfg(FATIGUE_CMDA_YAML, split)
    fwd_ms, fwd_share = resident_forward(tcfg, result["train"].model,
                                         "frames_fatigue_cmda_test")
    test_line("fatigue CMDA", rec, clips, rec.stages["test"]["s"], fwd_ms,
              test_b, fwd_share, peak, smi)
    if len(meter.clip_count) != FATIGUE_VIDEOS:
        raise AssertionError(f"fatigue CMDA test: {len(meter.clip_count)} "
                             f"videos, expected {FATIGUE_VIDEOS}")
    ckpt = get_last_checkpoint(out_dir)
    means = {"K2 bf16": meter.video_preds / meter.num_clips}
    for name, dtype in (("plain bf16", "bfloat16"), ("plain f32", "float32")):
        pcfg = frame_cfg(FATIGUE_CMDA_YAML, split, dtype,
                         "TPU.FLASH_ATTENTION", False,
                         "TEST.CHECKPOINT_FILE_PATH", ckpt)
        pmeter, _, pcounts, _ = run_test(pcfg)
        if any(pcounts.values()):
            raise AssertionError(f"the plain attention launched {pcounts}")
        means[name] = pmeter.video_preds / pmeter.num_clips
    ref = means["plain f32"]
    d_k = float(np.linalg.norm(means["K2 bf16"] - ref))
    d_p = float(np.linalg.norm(means["plain bf16"] - ref))
    log("frames", f"fatigue CMDA test scores ({len(ref)} videos x "
        f"{meter.num_clips} views, from {os.path.relpath(ckpt, ROOT)}), "
        f"from the f32 plain path's, L2: with K2 {d_k:.4e}, plain bf16 "
        f"{d_p:.4e} (ratio {d_k / max(d_p, 1e-30):.3f}, tol "
        f"{CMDA_TRAIN_BF16_RATIO}); max |d| K2 vs plain bf16 "
        f"{float(np.abs(means['K2 bf16'] - means['plain bf16']).max()):.3e};"
        f" stats {meter.stats} | {smi}")
    if not d_k <= CMDA_TRAIN_BF16_RATIO * d_p:
        raise AssertionError(f"fatigue CMDA test scores: K2 {d_k} vs plain "
                             f"bf16 {d_p}")
    del result
    torch.cuda.empty_cache()
    return k2_record, k2_err, bwd_record, bwd_err, counts


def phase_fatigue_slowfast(split, smi):
    """The fatigue SlowFast-R50 (TPU.FUSED_EVAL): K1 held at each block
    shape of the yaml, then its 30-view test through the fused engine,
    held against the module forward. Returns (K1 record, K1 error, the
    test's launch counts)."""
    cfg = frame_cfg(FATIGUE_SF_YAML, split, "bfloat16", "TPU.FUSED_EVAL", True)
    model = serving_model(cfg, SEED)
    log("frames", f"fatigue SlowFast-R50 ({os.path.relpath(FATIGUE_SF_YAML, ROOT)}"
        f", {cfg.TEST.DATASET}, {cfg.MODEL.NUM_CLASSES} classes, "
        f"{cfg.DATA.NUM_FRAMES} frames, α {cfg.SLOWFAST.ALPHA}, "
        f"{cfg.DATA.TEST_CROP_SIZE}², TPU.FUSED_EVAL): K1 at its block shapes")
    k1_record, k1_err = phase_kernels(cfg, model, smi, off_path=())
    path = os.path.join(smoke_dir(), "fatigue_slowfast.pyth")
    torch.save({"model_state": model.state_dict()}, path)
    tcfg = frame_cfg(FATIGUE_SF_YAML, split, "bfloat16", "TPU.FUSED_EVAL",
                     True, "TEST.CHECKPOINT_FILE_PATH", path)
    rec = FrameRun(None)
    meter, dt, counts, peak = run_test(tcfg, rec)
    batches = rec.stages["test_batches"]
    clips = len(meter.clip_count) * meter.num_clips
    fwd_ms, share = resident_forward(tcfg, model, "frames_fatigue_slowfast")
    test_line("fatigue SlowFast (fused, K1)", rec, clips, dt, fwd_ms,
              tcfg.TEST.BATCH_SIZE, share, peak, smi)
    expect = {"fused_bottleneck": 26 * batches, "flash_attention": 0,
              "flash_attention_backward": 0, "int8_conv": 0}
    if counts != expect or len(meter.clip_count) < 4:
        raise AssertionError(f"fatigue SlowFast test: launches {counts}, "
                             f"expected {expect}")
    ref_cfg = frame_cfg(FATIGUE_SF_YAML, split, "bfloat16",
                        "TEST.CHECKPOINT_FILE_PATH", path)
    ref, _, ref_counts, _ = run_test(ref_cfg)
    a = meter.video_preds / meter.num_clips
    b = ref.video_preds / ref.num_clips
    err = float(np.abs(a - b).max())
    rows = float(np.abs(a.sum(1) - 1).max())
    log("frames", f"fatigue SlowFast test: fused engine (K1) vs the module "
        f"forward, per-video mean probabilities max |d| {err:.3e} (tol "
        f"{SERVE_BF16_ATOL}), rows sum to 1 within {rows:.1e}, top-1 "
        f"agreement {float((a.argmax(1) == b.argmax(1)).mean()):.3f} | "
        f"module path launches {ref_counts} | stats {meter.stats} | {smi}")
    if err > SERVE_BF16_ATOL or any(ref_counts.values()) or rows > 1e-2:
        raise AssertionError(f"fatigue SlowFast test vs module {err}")
    del model
    torch.cuda.empty_cache()
    return k1_record, k1_err, counts


def phase_frame_list(name, yaml, split, smi):
    """Charades or SSv2 (SlowFast-R50 16x8, sync-BN as plain BN): test()
    at the yaml's views, then FRAME_LIST_STEPS train steps of its 16 clips
    through the train loader."""
    from efficient_slowfast_tpu_torch.data.loader import (construct_loader,
                                                          prefetch_to_device)
    from efficient_slowfast_tpu_torch.data.preprocess import \
        make_train_preprocess
    from efficient_slowfast_tpu_torch.engine.state import (
        create_train_state, make_train_step, step_generator)
    from efficient_slowfast_tpu_torch.utils.meters import StageTimes

    cfg = frame_cfg(yaml, split)
    model = serving_model(cfg, SEED)
    log("frames", f"{name} SlowFast-R50 ({os.path.relpath(yaml, ROOT)}, "
        f"{cfg.MODEL.NUM_CLASSES} classes, {cfg.MODEL.LOSS_FUNC}, "
        f"{cfg.MODEL.HEAD_ACT}, BN {cfg.BN.NORM_TYPE} "
        f"(NUM_SYNC_DEVICES {cfg.BN.NUM_SYNC_DEVICES}: one process, plain "
        f"BN), ensemble {cfg.DATA.ENSEMBLE_METHOD})")
    path = os.path.join(smoke_dir(), f"{name}.pyth")
    torch.save({"model_state": model.state_dict()}, path)
    tcfg = frame_cfg(yaml, split, "bfloat16", "TEST.CHECKPOINT_FILE_PATH",
                     path)
    rec = FrameRun(None)
    meter, dt, counts, peak = run_test(tcfg, rec)
    clips = len(meter.clip_count) * meter.num_clips
    fwd_ms, share = resident_forward(tcfg, model, f"frames_{name}_test")
    test_line(name, rec, clips, dt, fwd_ms, tcfg.TEST.BATCH_SIZE, share, peak,
              smi)
    stats = meter.stats
    if name == "charades":
        ok = np.isfinite(stats["map"]) and 0.0 <= stats["map"] <= 1.0
    else:
        ok = "top1_acc" in stats
    if not ok or any(counts.values()) or len(meter.clip_count) < 4:
        raise AssertionError(f"{name} test: stats {stats}, launches {counts}")

    # train steps through the train loader, on the model as tested
    loader = construct_loader(cfg, "train")
    pre = make_train_preprocess(cfg, torch.bfloat16)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, state.model, state.optimizer)
    drop = torch.Generator(device="cuda").manual_seed(SEED)
    times, steps, losses = StageTimes(), [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    batches = prefetch_to_device(loader, "cuda", times=times)
    t_loop = time.perf_counter()
    try:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            inputs = pre(step_generator(cfg.RNG_SEED, i, "cuda"),
                         batch["frames"], batch["width"],
                         batch.get("portrait"), batch.get("crop_u"))
            mets = step(state, inputs, batch["label"], cfg.SOLVER.BASE_LR,
                        drop)
            losses.append(mets["loss"].item())
            steps.append(time.perf_counter() - t0)
            if len(steps) == FRAME_LIST_STEPS:
                break
    finally:
        batches.close()
    loop_s = time.perf_counter() - t_loop
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    b = cfg.TRAIN.BATCH_SIZE
    label = batch["label"]
    log("frames", f"{name} training: {len(steps)} steps of {b} clips "
        f"(labels {tuple(label.shape)} {str(label.dtype)[6:]}), losses "
        + ", ".join(f"{x:.4f}" for x in losses) + " | ms a step "
        + ", ".join(f"{s * 1e3:.1f}" for s in steps) + " (the first with "
        f"cuDNN's plans) | end to end {len(steps) * b / loop_s:.2f} clips/s |"
        f" wait on the loader a step " + ", ".join(
            f"{w * 1e3:.1f}" for w in times.waits) + f" ms | peak memory "
        f"{peak / 2 ** 30:.2f} GiB | launches {counts} | {smi}")
    if (len(steps) != FRAME_LIST_STEPS or not all(np.isfinite(losses))
            or any(counts.values())):
        raise AssertionError(f"{name} training: losses {losses}, launches "
                             f"{counts}")
    del state, step
    resident_step(name, cfg, model, smi, inputs, label)
    del model, batch, inputs
    torch.cuda.empty_cache()


def phase_frames(smi):
    """Phase 14: the frame datasets on the card. Returns (records, errors,
    launch counts) of the kernels of its main paths."""
    t0 = time.perf_counter()
    split = write_frame_split(os.path.join(smoke_dir(), "frames"))
    log("frames", f"frame split written in {time.perf_counter() - t0:.1f} s:"
        f" {FRAME_FOLDERS} folders of {FRAME_JPEGS} JPEGs at "
        f"{FRAME_HW[1]}x{FRAME_HW[0]}; fatigue {FATIGUE_STEPS * FATIGUE_BATCH}"
        f" train and {FATIGUE_VIDEOS} val lines; Charades and SSv2 "
        f"(train, val, frames a video) {FRAME_LISTS}")
    loader_cps = phase_frame_benchmark(split, smi)
    k2_record, k2_err, bwd_record, bwd_err, counts = phase_fatigue_cmda(
        split, loader_cps, smi)
    torch.cuda.empty_cache()
    k1_record, k1_err, sf_counts = phase_fatigue_slowfast(split, smi)
    for k, v in sf_counts.items():
        counts[k] += v
    phase_frame_list("charades", CHARADES_YAML, split, smi)
    phase_frame_list("ssv2", SSV2_YAML, split, smi)
    log("frames", f"phase 14 in {time.perf_counter() - t0:.1f} s")
    records = {"fused_bottleneck": k1_record, "flash_attention": k2_record,
               "flash_attention_backward": bwd_record}
    errs = {"fused_bottleneck": k1_err, "flash_attention": k2_err,
            "flash_attention_backward": bwd_err}
    return records, errs, counts


# ---------------------------------------------------------------------------
# phase 15: int8 serving (K3) and the serving export
# K3 against its plain version: the int32 accumulators and the bf16 output
# bit for bit (torch.equal). Both sum the same integer products exactly,
# then dequantize the same accumulator with the same float32 product,
# round once to bf16 and add the bias in bf16.
# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet)
PEAK_INT8_OPS = 1979e12
# K3's shapes beside the SlowFast path, each with a bias: (label, x (B,
# Cin, T, H, W), Co, kernel, stride, padding, x's dtype, also the output's):
# a strided projection with Co not a multiple of 8, K not a multiple of 32
# (3·3·12 = 108, 3·1·1·20 = 60), a temporal kernel with stride, a
# 3-channel stem with stride 2 (the padded-channel path), and float32
# inputs
K3_OFF_PATH = [
    ("proj 40->100 s2", (4, 40, 8, 28, 28), 100, (1, 1, 1), (1, 2, 2),
     (0, 0, 0), torch.bfloat16),
    ("3x3x3 12->20 K108", (4, 12, 8, 20, 20), 20, (3, 3, 3), (1, 1, 1),
     (1, 1, 1), torch.bfloat16),
    ("3x1x1 20->36 K60 s2", (4, 20, 16, 14, 14), 36, (3, 1, 1), (2, 1, 1),
     (1, 0, 0), torch.bfloat16),
    ("stem 3->24 1x5x5 s2", (4, 3, 8, 30, 30), 24, (1, 5, 5), (1, 2, 2),
     (0, 2, 2), torch.bfloat16),
    ("f32 stem 3->24 1x5x5 s2", (4, 3, 8, 30, 30), 24, (1, 5, 5),
     (1, 2, 2), (0, 2, 2), torch.float32),
    ("f32 proj 40->100 s2", (4, 40, 8, 28, 28), 100, (1, 1, 1), (1, 2, 2),
     (0, 0, 0), torch.float32),
    ("f32 3x3 64->64", (4, 64, 8, 16, 16), 64, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), torch.float32)]
# calls of each shape under phase 15's profiler (K3's and cuDNN's device
# time per call is the sum over them)
K3_TRACE_CALLS = 5
# int8 against bf16 serving, per clip on the centred log probabilities (the
# logits less their mean, phase 8's measure), over the scale of the bf16
# ones. Sound int8 read 0.010 (INT8_EVAL) and 0.016 (+INT8_SPATIAL) on the
# H100; INT8_FAULTS plants faults and reads the same ratio for each.
INT8_LOGIT_TOL = 0.05
# planted faults, each served once in place of the sound int8 model and
# its ratio printed: a per-tensor weight scale in place of the per-channel
# one; the pointwise ranges of the unstrided input; calibration on clips
# at half the serving amplitude (every range about halved, so the top of
# each range clips). The last must exceed INT8_LOGIT_TOL: the gate's power.
INT8_FAULTS = ("per-tensor weight scale", "unstrided calibration",
               "half-amplitude calibration")
# the int8 forward with K3 against the same forward with K3's plain version
# on the card: the same codes, accumulators and dequantize, the float
# layers the same ops on the same inputs; bit for bit (torch.equal).
# export round trips: the artifact runs the same ops as the live forward,
# at the same batch and the same inputs; SERVE_BF16_ATOL of the scale.
EXPORT_BATCHES = (4, 1)


def int8_cfg(spatial, dtype="bfloat16"):
    """SlowFast-R50 8x8 (serving_cfg) served by the module forward with
    TPU.INT8_EVAL, and TPU.INT8_SPATIAL where ``spatial``."""
    cfg = serving_cfg(dtype)
    cfg.TPU.FUSED_EVAL = False
    cfg.TPU.INT8_EVAL = True
    cfg.TPU.INT8_SPATIAL = spatial
    cfg.TRAIN.ENABLE = False
    return cfg


def calibrate_with_shapes(cfg, model, seed):
    """Calibrate ``model`` on one seeded request; returns (quant state,
    {shape key: [conv names]}) with each int8 conv's input shape, Co,
    kernel, stride and padding as the calibrating forward saw them."""
    from efficient_slowfast_tpu_torch.engine.quantize import calibrate_int8
    from efficient_slowfast_tpu_torch.ops.conv import int8_convs

    shapes, hooks = {}, []
    for name, conv in int8_convs(model).items():
        def seen(m, args, name=name):
            key = (tuple(args[0].shape), m.out_channels, m.kernel_size,
                   m.stride, m.padding, m.int8)
            shapes.setdefault(key, []).append(name)
        hooks.append(conv.register_forward_pre_hook(seen))
    req = clips(cfg, CLIPS_PER_REQUEST, torch.Generator().manual_seed(seed),
                torch.bfloat16)
    quant = calibrate_int8(model, [req])
    for h in hooks:
        h.remove()
    return quant, shapes


def k3_cost(x_shape, co, k, s, p, x_size=2, out_size=2):
    """(int8 operations, bytes, output positions): the input positions the
    conv reads (a strided 1x1x1 conv reads every s-th) once in x's dtype,
    the Co x K weight codes and Co scales, the output written once."""
    b, ci = x_shape[0], x_shape[1]
    out = [(x_shape[2 + i] + 2 * p[i] - k[i]) // s[i] + 1 for i in range(3)]
    read = [len({o * s[i] - p[i] + j for o in range(out[i])
                 for j in range(k[i])} & set(range(x_shape[2 + i])))
            for i in range(3)]
    m = b * out[0] * out[1] * out[2]
    kk = ci * k[0] * k[1] * k[2]
    ops = 2 * m * co * kk
    nbytes = (x_size * b * ci * int(np.prod(read)) + co * kk + 4 * co
              + out_size * m * co)
    return ops, nbytes, m


def phase_int8_kernels(shapes, smi):
    """K3 against its plain version at every int8 conv shape of the int8
    SlowFast-R50 request and the off-path shapes: the quantize pass's code
    buffer and weight layout, the int32 accumulators and the output bit for
    bit; the plan's shared memory against the library's; timed beside its
    bound, the plain version, cuDNN's conv (x's dtype) and torch._int_mm
    (pointwise shapes where its rules hold): CUDA events around calls, the
    wrapper's host time a call, and device time from the profiler (K3's
    quantize and GEMM launches, cuDNN's kernels)."""
    from efficient_slowfast_tpu_torch.ops.kernels import int8_conv as k3
    from efficient_slowfast_tpu_torch.ops.kernels.int8_conv import (
        int8_conv, int8_conv_accumulator, int8_conv_reference, weight_codes)

    lib = k3._lib()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    rows = [(names[0] if len(names) == 1 else
             f"{names[0]} (+{len(names) - 1})", x, co, k, s, p, kind,
             len(names), torch.bfloat16)
            for (x, co, k, s, p, kind), names in shapes.items()]
    rows += [(label, x, co, k, s, p, "off path", 0, dtype)
             for label, x, co, k, s, p, dtype in K3_OFF_PATH]
    record, worst, calls = [], 0.0, []
    for label, x_shape, co, k, s, p, kind, count, dtype in rows:
        x = torch.randn(x_shape, device="cuda", generator=gen).to(
            dtype).contiguous(memory_format=torch.channels_last_3d)
        w = torch.randn(co, x_shape[1], *k, device="cuda", generator=gen)
        # the path's convs have no bias (BN follows); the off-path shapes
        # take one, so the epilogue's bias add is held too
        bias = None if count else torch.randn(
            co, device="cuda", generator=gen).to(dtype)
        codes, scale = weight_codes(w)
        am = x.float().abs().amax()
        pl = k3.plan(tuple(x_shape), co, k, s, p, dtype)
        out_size = 2 if dtype == torch.bfloat16 else 4
        chunks = pl.k_a // pl.gather if pl.gather else 0
        smem = lib.int8_conv_smem_bytes(pl.nwg, pl.bn, pl.stages,
                                        k3._DTYPES[dtype], chunks)
        if smem != pl.smem or smem != k3.smem_bytes(
                pl.nwg, pl.bn, pl.stages, out_size, chunks):
            raise AssertionError(f"int8 {label}: plan smem {pl.smem}, the "
                                 f"library's {smem}")
        q, bq = k3.int8_conv_layout(x, codes, am, k, s, p)
        if not torch.equal(q, k3.quantized_layout(x, am, pl)) or \
                not torch.equal(bq, k3.padded_codes(codes, pl)):
            raise AssertionError(f"int8 {label}: the quantize pass's code "
                                 "buffer or weight layout differs from its "
                                 "plain version")
        del q, bq
        acc = int8_conv_accumulator(x, codes, am, k, s, p)
        ref_acc = int8_conv_reference(x, codes, scale, am, None, k, s, p,
                                      dtype, True)
        y = int8_conv(x, codes, scale, am, bias, k, s, p, dtype)
        ref = int8_conv_reference(x, codes, scale, am, bias, k, s, p, dtype)
        torch.cuda.synchronize()
        if not torch.equal(acc, ref_acc):
            raise AssertionError(
                f"int8 {label}: accumulators differ at "
                f"{int((acc != ref_acc).sum())} of {acc.numel()} "
                f"(max |d| {(acc - ref_acc).abs().max().item()})")
        err = (y.float() - ref.float()).abs().max().item()
        if not bool(torch.isfinite(y).all()) or not torch.equal(y, ref):
            raise AssertionError(f"int8 {label}: output differs from "
                                 f"the plain version's, max |d| {err}")
        if count:
            worst = max(worst, err)
        del acc, ref_acc, y, ref
        run = functools.partial(int8_conv, x, codes, scale, am, bias, k, s,
                                p, dtype)
        k_ms = cuda_ms(run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run()
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        p_ms = cuda_ms(lambda: int8_conv_reference(
            x, codes, scale, am, bias, k, s, p, dtype), iters=1, reps=2)
        wb = w.to(dtype).contiguous(memory_format=torch.channels_last_3d)
        lib_run = functools.partial(torch.nn.functional.conv3d, x, wb, None,
                                    s, p)
        lib_ms = cuda_ms(lib_run)
        ops, nbytes, m = k3_cost(x_shape, co, k, s, p,
                                 x.element_size(), out_size)
        t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        ci = x_shape[1]
        int_mm = None
        if k == (1, 1, 1) and m > 16 and ci % 8 == 0 and co % 8 == 0:
            xs = x[:, :, ::s[0], ::s[1], ::s[2]]
            a = torch.clamp(torch.round(xs.float() / (am * 0.007874015718698502)),
                            -127, 127).to(torch.int8).permute(
                0, 2, 3, 4, 1).reshape(m, ci).contiguous()
            bmat = codes[:, :ci].contiguous().t()
            int_mm = cuda_ms(lambda: torch._int_mm(a, bmat))
        calls.append((run, lib_run))
        record.append(dict(label=label, kind=kind, count=count, x=x_shape,
                           co=co, k=k, s=s, p=p, event_ms=k_ms,
                           plain_ms=p_ms, library_event_ms=lib_ms,
                           int_mm_ms=int_mm, bound_ms=bound, bound_by=by,
                           host_us=host_us, ops=ops, nbytes=nbytes,
                           plan=f"BM {pl.bm} BN {pl.bn} split {pl.split} "
                           f"stages {pl.stages} "
                           f"{'TMA' if not pl.gather else f'gather {pl.gather}'}"
                           f" CTAs {pl.ctas} smem {pl.smem}"))
    # device time: every shape's K3 and cuDNN calls under the profiler
    device = k3_device_times(calls)
    for r, (k3_dev, launches, quant_ms, lib_dev, how) in zip(record, device):
        r.update(ms=k3_dev, launches_per_call=launches, quantize_ms=quant_ms,
                 library_ms=lib_dev, timed_by=how)
        log("int8", f"{r['label']:34s} {r['kind']:9s} x{r['count']} x "
            f"{tuple(r['x'])} Co {r['co']} k {r['k']} s {r['s']} p {r['p']} "
            f"| codes, acc and out bit-equal | {r['plan']} | K3 device "
            f"{k3_dev:.4f} ms ({launches:g} launches a call, quantize "
            f"{quant_ms:.4f}; {how}) | cuDNN device {lib_dev:.4f} ms | "
            f"events: K3 "
            f"{r['event_ms']:.4f}, cuDNN {r['library_event_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, _int_mm "
            + (f"{r['int_mm_ms']:.4f}" if r['int_mm_ms'] is not None else
               "n/a") + f" ms | host {r['host_us']:.1f} us a call | bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}; {r['ops'] / 1e9:.3f} "
            f"GOP, {r['nbytes'] / 1e6:.3f} MB) | K3/bound "
            f"{k3_dev / r['bound_ms']:.2f}, K3/cuDNN {k3_dev / lib_dev:.2f} "
            f"(device) | {smi}")
    path = [r for r in record if r["count"]]
    for what, keep in (("INT8_EVAL", lambda r: r["kind"] == "pointwise"),
                       ("+INT8_SPATIAL", lambda r: True)):
        sel = [r for r in path if keep(r)]
        dev, lib_dev = per_request(sel, "ms"), per_request(sel, "library_ms")
        log("int8", f"K3 per 4-clip request under {what}: "
            f"{sum(r['count'] for r in sel)} convs, "
            f"{sum(r['count'] * r['launches_per_call'] for r in sel):g} CUDA "
            f"launches | device {dev:.3f} ms (quantize "
            f"{per_request(sel, 'quantize_ms'):.3f}), cuDNN bf16 device "
            f"{lib_dev:.3f} ms, K3/cuDNN {dev / lib_dev:.2f} | events: K3 "
            f"{per_request(sel, 'event_ms'):.3f} ms, cuDNN bf16 "
            f"{per_request(sel, 'library_event_ms'):.3f}, plain "
            f"{per_request(sel, 'plain_ms'):.3f} | bound "
            f"{per_request(sel, 'bound_ms'):.3f} ms, K3 device/bound "
            f"{dev / per_request(sel, 'bound_ms'):.2f} | host "
            f"{statistics.median(r['host_us'] for r in sel):.1f} us a call "
            f"(median) | {smi}")
    torch.cuda.empty_cache()
    return record, worst


def k3_device_times(calls):
    """Each shape's K3 call and its cuDNN conv, K3_TRACE_CALLS times each,
    in profiler sessions of their own (CUPTI's kernel records; a session
    holds one side of one shape alone, so every kernel in it is that
    side's and no host-device time matching is needed): per shape (K3's
    device ms a call, its CUDA launches a call, the quantize launch's ms a
    call, cuDNN's device ms a call, how it was timed). Where a session
    records no kernel (K3's were missing from sessions that followed the
    earlier phases' traces in one whole run), both sides are timed by
    CUDA events around replays of a CUDA graph of the same calls, which
    has no host gaps, and K3's launches are its two by construction."""
    from torch.profiler import ProfilerActivity, profile

    def recorded(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(K3_TRACE_CALLS):
                fn()
            torch.cuda.synchronize()
        return [(e.key, getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0), e.count)
                for e in prof.key_averages()
                if (getattr(e, "device_time_total", None)
                    or getattr(e, "cuda_time_total", 0)) > 0]

    def replayed(fn, reps=3):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(K3_TRACE_CALLS):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps / K3_TRACE_CALLS

    for run, lib_run in calls:  # warm: cuDNN's plans, the allocator
        run()
        lib_run()
    torch.cuda.synchronize()
    per = lambda us: us / 1e3 / K3_TRACE_CALLS  # noqa: E731
    out = []
    for i, (run, lib_run) in enumerate(calls):
        k3, lib = recorded(run), recorded(lib_run)
        if k3 and lib:
            out.append((per(sum(r[1] for r in k3)),
                        sum(r[2] for r in k3) / K3_TRACE_CALLS,
                        per(sum(r[1] for r in k3 if "quantize" in r[0])),
                        per(sum(r[1] for r in lib)), "profiler"))
        else:
            if i == 0:
                log("int8", f"K3 timing: the profiler recorded K3 {k3} and "
                    f"cuDNN {[r[0][:60] for r in lib]}; timing by CUDA "
                    "graph replay")
            out.append((replayed(run), 2.0, float("nan"), replayed(lib_run),
                        "graph replay"))
    return out


def centred_logs(p):
    logp = torch.log(torch.clamp(p.float(), min=1e-30))
    return logp - logp.mean(-1, keepdim=True)


def serve_int8(spatial, float_model, smi):
    """The int8 SlowFast-R50 (``spatial``: +INT8_SPATIAL): calibrated on
    one request, three requests served through make_forward with K3 (its
    launches gated), held against the same model with K3's plain version
    and against the bf16 module forward; the request and the forward on a
    resident 64-clip batch timed beside bf16. Returns (model, cfg, shapes,
    K3 launches)."""
    import efficient_slowfast_tpu_torch.ops.conv as conv_mod
    from efficient_slowfast_tpu_torch.engine.state import make_forward
    from efficient_slowfast_tpu_torch.models import build_model
    from efficient_slowfast_tpu_torch.ops.kernels.int8_conv import \
        int8_conv_reference

    what = "+INT8_SPATIAL" if spatial else "INT8_EVAL"
    cfg = int8_cfg(spatial)
    model = build_model(cfg, device="cuda")  # the bf16 model's weights
    model.load_state_dict(float_model.state_dict(), strict=True)
    model.eval()
    t0 = time.perf_counter()
    quant, shapes = calibrate_with_shapes(cfg, model, SEED + 41)
    torch.cuda.synchronize()
    convs = len(quant)
    log("int8", f"{what}: {convs} int8 convs ({len(shapes)} shapes), "
        f"calibrated on one {CLIPS_PER_REQUEST}-clip request in "
        f"{time.perf_counter() - t0:.2f} s; act_max "
        f"{min(float(v) for v in quant.values()):.4g}-"
        f"{max(float(v) for v in quant.values()):.4g}")
    fwd = make_forward(cfg, model)
    ref = make_forward(serving_cfg_module(), float_model)
    gen = torch.Generator().manual_seed(SEED + 42)
    requests = [clips(cfg, CLIPS_PER_REQUEST, gen, torch.bfloat16)
                for _ in range(REQUESTS)]
    serve(fwd, requests[:1])
    serve(ref, requests[:1])
    reset_counts()
    outs, dt = serve(fwd, requests)
    counts = read_counts()
    expect = {**dict.fromkeys(counts, 0), "int8_conv": convs * REQUESTS}
    if counts != expect:
        raise AssertionError(f"int8 {what}: launches {counts}, expected "
                             f"{expect}")
    refs, dt_ref = serve(ref, requests)
    real = conv_mod.int8_conv
    conv_mod.int8_conv = int8_conv_reference
    try:
        plain, _ = serve(fwd, requests[:1])
    finally:
        conv_mod.int8_conv = real
    kp = (outs[0] - plain[0]).abs().max().item()
    if not torch.equal(outs[0], plain[0]):
        raise AssertionError(f"int8 {what}: K3 vs plain version in the "
                             f"network, max |dp| {kp}")
    dist, scale, top1 = 0.0, 0.0, []
    for i, (o, r) in enumerate(zip(outs, refs)):
        check_scores(o, CLIPS_PER_REQUEST, cfg.MODEL.NUM_CLASSES,
                     f"int8 {what} request {i}")
        co, cr = centred_logs(o), centred_logs(r)
        dist = max(dist, (co - cr).abs().max().item())
        scale = max(scale, cr.abs().max().item())
        top1.append((o.argmax(-1) == r.argmax(-1)).float().mean().item())
    n = REQUESTS * CLIPS_PER_REQUEST
    log("int8", f"{what}: {REQUESTS} requests x {CLIPS_PER_REQUEST} clips, "
        f"launches {counts} ({convs} a request) | K3 vs its plain version "
        f"on the card bit-equal | vs the "
        f"bf16 module forward: centred log probabilities max |d| "
        f"{dist:.4f} of scale {scale:.4f} (ratio {dist / scale:.3f}, tol "
        f"{INT8_LOGIT_TOL}), top-1 agreement {np.mean(top1):.3f} | request "
        f"{dt / REQUESTS * 1e3:.2f} ms int8, {dt_ref / REQUESTS * 1e3:.2f} ms"
        f" bf16; {n / dt:.2f} / {n / dt_ref:.2f} clips/s | {smi}")
    if dist > INT8_LOGIT_TOL * scale:
        raise AssertionError(f"int8 {what}: {dist} > {INT8_LOGIT_TOL} x "
                             f"{scale}")
    planted_faults(cfg, model, fwd, requests[0], refs[0], quant, what, smi)
    big = clips(cfg, TEST_CLIPS, torch.Generator().manual_seed(SEED + 43),
                torch.bfloat16)
    int8_ms = cuda_ms(lambda: fwd(big), iters=2, reps=3)
    bf16_ms = cuda_ms(lambda: ref(big), iters=2, reps=3)
    log("int8", f"{what}: forward on a resident {TEST_CLIPS}-clip batch "
        f"{int8_ms:.2f} ms ({TEST_CLIPS / int8_ms * 1e3:.1f} clips/s) | bf16 "
        f"module forward {bf16_ms:.2f} ms ({TEST_CLIPS / bf16_ms * 1e3:.1f} "
        f"clips/s) | int8/bf16 {int8_ms / bf16_ms:.2f} | {smi}")
    del big
    torch.cuda.empty_cache()
    return model, cfg, shapes, counts["int8_conv"]


def planted_faults(cfg, model, fwd, request, ref, quant, what, smi):
    """Serve ``request`` once under each of INT8_FAULTS and print its ratio
    of centred log probabilities to the bf16 ones (``ref``); the last must
    exceed INT8_LOGIT_TOL. ``model`` is left as it was calibrated."""
    from efficient_slowfast_tpu_torch.engine.quantize import (
        calibrate_int8, load_quant_state)
    from efficient_slowfast_tpu_torch.ops.conv import int8_convs

    convs = int8_convs(model).values()
    cr = centred_logs(ref)
    ratios = {}
    for fault in INT8_FAULTS:
        if fault == "per-tensor weight scale":
            for m in convs:
                codes, scale = m.weight_codes()
                top = scale.max()
                wf = m.weight.detach().float().permute(
                    0, 2, 3, 4, 1).reshape(m.out_channels, -1)
                m.w_codes = torch.zeros_like(codes)
                m.w_codes[:, :wf.shape[1]] = torch.clamp(
                    torch.round(wf / top), -127, 127).to(torch.int8)
                m.w_scale = torch.full_like(scale, float(top))
        elif fault == "unstrided calibration":
            for m in convs:
                if m.int8 == "pointwise":
                    m.int8 = "unstrided"  # calibrates on the whole input
            calibrate_int8(model, [request])
            for m in convs:
                if m.int8 == "unstrided":
                    m.int8 = "pointwise"
        else:
            calibrate_int8(model, [[x * 0.5 for x in request]])
        out, _ = serve(fwd, [request])
        co = centred_logs(out[0])
        ratios[fault] = ((co - cr).abs().max() / cr.abs().max()).item()
        for m in convs:
            m._codes_of = None  # requantize the weights per channel
        load_quant_state(model, quant)
    log("int8", f"{what}: planted faults, ratio of centred log "
        f"probabilities (tol {INT8_LOGIT_TOL}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in ratios.items()) + f" | {smi}")
    if ratios[INT8_FAULTS[-1]] <= INT8_LOGIT_TOL:
        raise AssertionError(f"int8 {what}: the gate cannot see a "
                             f"{INT8_FAULTS[-1]} ({ratios})")


def serving_cfg_module():
    cfg = serving_cfg()
    cfg.TPU.FUSED_EVAL = False
    return cfg


def phase_int8_test(convs, smi):
    """engine/test.py::test with TPU.INT8_EVAL on the synthetic split
    (SLOWFAST_8x8_R50.yaml): the first run calibrates on
    TPU.INT8_CALIB_BATCHES test batches and persists, the second loads the
    file; K3's launches a batch gated. Returns the launches."""
    import efficient_slowfast_tpu_torch.engine.quantize as quantize

    out = os.path.join(smoke_dir(), "int8_test")
    shutil.rmtree(out, ignore_errors=True)
    cfg = yaml_cfg("SLOWFAST_8x8_R50.yaml", [
        "TPU.FUSED_EVAL", False, "TPU.INT8_EVAL", True, "TRAIN.ENABLE", False,
        "OUTPUT_DIR", out])
    calls = []
    real = quantize.calibrate_for_test

    def counted(*a):
        calls.append(1)
        return real(*a)

    quantize.calibrate_for_test = counted
    total = 0
    try:
        metas = []
        for run in (1, 2):
            meter, dt, counts, peak = run_test(cfg)
            batches = -(-len(meter.video_preds) * meter.num_clips //
                        cfg.TEST.BATCH_SIZE)
            expect = {**dict.fromkeys(counts, 0),
                      "int8_conv": convs * batches}
            if counts != expect or calls != [1]:
                raise AssertionError(f"int8 test run {run}: launches {counts}"
                                     f" (expected {expect}), calibrations "
                                     f"{len(calls)}")
            if not np.isfinite(meter.video_preds).all():
                raise AssertionError("int8 test: non-finite scores")
            clips_n = len(meter.video_preds) * meter.num_clips
            log("int8", f"test() run {run} ({'calibrated and persisted' if run == 1 else 'loaded the calibration'}): "
                f"{clips_n} clips in {batches} batches, {clips_n / dt:.2f} "
                f"clips/s end to end ({dt:.2f} s with the build), launches "
                f"{counts}, peak {peak / 2 ** 30:.2f} GiB | {smi}")
            metas.append(meter.video_preds)
            total += counts["int8_conv"]
        log("int8", f"test() runs agree: max |d| of the video scores "
            f"{np.abs(metas[0] - metas[1]).max():.3e}; calibration file "
            f"{os.path.relpath(quantize.calibration_path(cfg), ROOT)}")
    finally:
        quantize.calibrate_for_test = real
    return total


def export_round_trip(name, cfg, model, smi, boxes=False):
    """Export ``model``'s serving forward (the detection forward where
    ``boxes``) on the card, load it there, serve it at EXPORT_BATCHES
    against the live forward; returns the launches inside the artifact and
    its graph's kernel nodes."""
    from efficient_slowfast_tpu_torch.data.ava_dataset import MAX_BOXES
    from efficient_slowfast_tpu_torch.engine.export import (export_serving,
                                                            load_serving)
    from efficient_slowfast_tpu_torch.engine.state import (
        make_detection_forward, make_forward)

    path = os.path.join(smoke_dir(), f"export_{name}")
    t0 = time.perf_counter()
    path = export_serving(cfg, model, path, max_boxes=MAX_BOXES,
                          device="cuda")
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    serving = load_serving(path, device="cuda")
    if serving.device.type != "cuda":
        raise AssertionError(f"export {name}: loaded on {serving.device}")
    t_load = time.perf_counter() - t0
    graph = str(serving.program.graph)
    nodes = {op: graph.count(f"esf_torch.{op}.default") for op in (
        "fused_bottleneck", "flash_attention", "int8_conv")}
    live = (make_detection_forward if boxes else make_forward)(cfg, model)
    gen = torch.Generator().manual_seed(SEED + 44)
    total = dict.fromkeys(read_counts(), 0)
    lines = []
    for b in EXPORT_BATCHES:
        x = clips(cfg, b, gen, torch.bfloat16)
        args = [x]
        if boxes:
            s = cfg.DATA.TEST_CROP_SIZE
            x1y1 = torch.rand(b, MAX_BOXES, 2, generator=gen) * s / 2
            wh = 2 + torch.rand(b, MAX_BOXES, 2, generator=gen) * s / 2
            args.append(torch.cat([x1y1, x1y1 + wh], -1).to("cuda"))
        want = live(*args).float().cpu().numpy()
        serving(*args)  # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = serving(*args)
        dt = time.perf_counter() - t0
        counts = read_counts()
        for k, v in counts.items():
            total[k] += v
        rows = b * MAX_BOXES if boxes else b
        if got.shape != (rows, cfg.MODEL.NUM_CLASSES) or \
                not np.isfinite(got).all():
            raise AssertionError(f"export {name}: batch {b} gave "
                                 f"{got.shape}")
        err = float(np.abs(got - want).max())
        scale = max(1.0, float(np.abs(want).max()))
        if err > SERVE_BF16_ATOL * scale:
            raise AssertionError(f"export {name} batch {b}: {err}")
        lines.append(f"batch {b}: max |d| vs live {err:.3e}, launches "
                     f"{ {k: v for k, v in counts.items() if v} }, "
                     f"{dt * 1e3:.2f} ms")
    log("export", f"{name}: exported on cuda, {os.path.getsize(path) / 1e6:.1f}"
        f" MB, export {t_export:.1f} s, load onto the card {t_load:.1f} s, "
        f"graph kernel nodes {nodes} "
        f"| " + " | ".join(lines) + f" | {smi}")
    os.remove(path)
    return total, nodes


def phase_export(smi):
    """Export round trips of fused SlowFast-R50 (K1), CMDA-R50 (K2) and
    SlowFast-R50 32x2 AVA detection (int8 SlowFast-R50's, K3, is phase
    20's, beside the split's). Returns the launches inside the
    artifacts."""
    from efficient_slowfast_tpu_torch.config import load_cfg

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    cfg = serving_cfg()
    model = serving_model(cfg, SEED)
    counts, nodes = export_round_trip("fused_slowfast", cfg, model, smi)
    per = len(EXPORT_BATCHES)
    if nodes["fused_bottleneck"] != 26 or counts["fused_bottleneck"] != 26 * per:
        raise AssertionError(f"fused export: nodes {nodes}, launches {counts}")
    add(counts)
    del model
    cfg = cmda_cfg()
    model = serving_model(cfg, SEED)
    calibrate_attention(cfg, model, SEED + 6, phase="export")
    counts, nodes = export_round_trip("cmda", cfg, model, smi)
    if nodes["flash_attention"] != 4 or counts["flash_attention"] != 4 * per:
        raise AssertionError(f"CMDA export: nodes {nodes}, launches {counts}")
    add(counts)
    del model
    cfg = load_cfg(AVA_YAML, ["TPU.COMPUTE_DTYPE", "bfloat16"])
    model = serving_model(cfg, SEED)
    counts, nodes = export_round_trip("ava_detection", cfg, model, smi,
                                      boxes=True)
    if any(counts.values()) or any(nodes.values()):
        raise AssertionError(f"AVA export: nodes {nodes}, launches {counts}")
    del model
    torch.cuda.empty_cache()
    return total


def phase_int8(smi):
    """Phase 15: K3 against its plain version, the int8 SlowFast-R50 served
    under INT8_EVAL and +INT8_SPATIAL, test() int8, and the export round
    trips. Returns (K3's record, its worst error, the launches on the main
    paths)."""
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    t0 = time.perf_counter()
    float_model = serving_model(serving_cfg_module(), SEED)
    model, cfg, shapes, n = serve_int8(True, float_model, smi)
    add({"int8_conv": n})
    del model
    record, worst = phase_int8_kernels(shapes, smi)
    eval_model, _, eval_shapes, n = serve_int8(False, float_model, smi)
    add({"int8_conv": n})
    del eval_model, float_model
    torch.cuda.empty_cache()
    convs = sum(len(v) for v in eval_shapes.values())
    add({"int8_conv": phase_int8_test(convs, smi)})
    add(phase_export(smi))
    torch.cuda.empty_cache()
    log("int8", f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return record, worst, launches


# ---------------------------------------------------------------------------
# the profiler: the device's busy share of a window
# ---------------------------------------------------------------------------
# Phase 16: Grad-CAM of CMDA-R50 on the card
GRADCAM_YAML = "SLOWFAST_DUALATTENTION_8x8_R50.yaml"
# (target, K2-bwd calls of one Grad-CAM call: the fusions between the
# target and the score; s4_fuse for s4, s3_fuse and s4_fuse for s3)
GRADCAM_TARGETS = [("s4", 1), ("s3", 2)]
# float32 CAMs, which lie in [0, 1], with the kernels against the plain
# attention: both paths float32, differing in the attention's summation
# order (about 1e-6 relative: ATTN_F32_TOL, ATTN_BWD_F32_TOL) carried
# through the rest of the backward and the CAM's min-max scaling; 1e-3.
GRADCAM_F32_ATOL = 1e-3
# Grad-CAM's gradients are d(the top class's probability)/d(activation)
# through a 400-class head and a spatial mean, far below 1 (the phase prints
# them), where a loss's are near 1. So each attention call is held at
# ATTN_*_TOL of its own output's or gradient's largest magnitude, floored
# only against an all-zero reference, not at max(1, that magnitude) as
# phases 7 and 11 hold a loss's gradients: under max(1, ·) a K2-bwd that
# returned zeros would pass here.
GRADCAM_SCALE_FLOOR = 1e-30


def gradcam_cfg(dtype="bfloat16", flash=True):
    """configs/Kinetics/SLOWFAST_DUALATTENTION_8x8_R50.yaml at full width
    and depth (400 classes, 32 frames, the 256² test crop) in ``dtype``,
    the plain attention where not ``flash``."""
    return yaml_cfg(GRADCAM_YAML, ["TPU.COMPUTE_DTYPE", dtype,
                                   "TPU.FLASH_ATTENTION", flash])


def cam_distance(a, b):
    """L2 distance of two Grad-CAM results' CAMs over every pathway."""
    return sum(float(np.sum((x.astype(np.float64) - y) ** 2))
               for x, y in zip(a["cams"], b["cams"])) ** 0.5


def gradcam_run(phase, cfg, model, clip, target, calls, smi):
    """One Grad-CAM call through the tool's core (gradcam_clip) with every
    launch count set to 0 just before it; checks its K2 and K2-bwd
    launches (4 and ``calls`` calls, no K1 or K3), the scores and the CAMs;
    returns (result, counts, the K2-bwd calls (BackwardCalls), the K2
    calls [(q, k, v, output)])."""
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL
    from efficient_slowfast_tpu_torch.visualization.video_cam import \
        gradcam_clip

    reset_counts()
    fwd_calls = []
    with BackwardCalls() as rec:
        res, _ = k2_shapes_of(
            lambda: gradcam_clip(cfg, model, clip, target), fwd_calls)
        torch.cuda.synchronize()
    counts = read_counts()
    flash = cfg.TPU.FLASH_ATTENTION
    expect = {"fused_bottleneck": 0, "flash_attention": 4 if flash else 0,
              "flash_attention_backward":
                  calls * BACKWARD_LAUNCHES_PER_CALL if flash else 0,
              "int8_conv": 0}
    if counts != expect or (flash and len(rec.calls) != calls):
        raise AssertionError(f"{phase} {target}: launches {counts}, "
                             f"{len(rec.calls)} K2-bwd calls; expected "
                             f"{expect}")
    preds = torch.from_numpy(res["predictions"])
    check_scores(preds, 1, cfg.MODEL.NUM_CLASSES, f"{phase} {target}")
    for cam in res["cams"]:
        if not (np.isfinite(cam).all() and cam.min() >= 0 and cam.max() <= 1):
            raise AssertionError(f"{phase} {target}: CAM outside [0, 1]")
    return res, counts, rec, fwd_calls


def hold_gradcam_calls(target, dtype, rec, fwd_calls):
    """Each K2 call's output against chunked_attention and each K2-bwd
    call's dQ, dK and dV against attention_backward, on the call's own
    inputs, at the attention tolerances of their own scale
    (GRADCAM_SCALE_FLOOR); returns the worst (forward, backward) error."""
    from efficient_slowfast_tpu_torch.ops.kernels import \
        flash_attention as fa

    f_tol, b_tol = ((ATTN_BF16_TOL, ATTN_BWD_BF16_TOL) if dtype == "bfloat16"
                    else (ATTN_F32_TOL, ATTN_BWD_F32_TOL))
    with torch.no_grad():
        fwd = [(q.shape[1], relative_error(o, fa.chunked_attention(q, k, v),
                                           GRADCAM_SCALE_FLOOR),
                o.float().abs().max().item())
               for q, k, v, o in ((t.detach() for t in c) for c in fwd_calls)]
    bwd = rec.held(GRADCAM_SCALE_FLOOR)
    worst_f = max(e for _, e, _ in fwd)
    worst_b = max(e for row in bwd for e, _ in row)
    shapes = [(c[0].shape[1], c[1].shape[1], c[0].shape[2], c[2].shape[2])
              for c in rec.calls]
    log("gradcam", f"{target} {dtype}: its {len(fwd)} K2 calls against "
        f"chunked_attention on their inputs, (N, error of its own scale, "
        f"scale) " + ", ".join(f"({n}, {e:.3e}, {m:.3e})" for n, e, m in fwd)
        + f" (tol {f_tol}) | its {len(bwd)} K2-bwd calls (N, M, D, C) "
        f"{shapes} against attention_backward on their inputs, dQ, dK, dV "
        f"(error of its own scale, scale): " + "; ".join(
            ", ".join(f"({e:.3e}, {m:.3e})" for e, m in row) for row in bwd)
        + f" (tol {b_tol})")
    if worst_f > f_tol or worst_b > b_tol:
        raise AssertionError(f"gradcam {target} {dtype}: K2 {worst_f} (tol "
                             f"{f_tol}), K2-bwd {worst_b} (tol {b_tol})")
    return worst_f, worst_b


def planted_fault_errors(call):
    """Two planted faults in dV of one recorded K2-bwd call, zeroed and P dO
    in place of Pᵀ dO (the probabilities untransposed; CMDA's N equals
    M), or, where a band's N queries meet its space group's M keys (phase
    19), Pᵀ dO of half the queries: {fault: (its error of dV's own scale,
    of max(1, scale))}."""
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        attention_backward

    q, k, v, out, lse, dout, _ = call
    dv = attention_backward(q, k, v, out, lse, dout)[2]
    with torch.no_grad():
        p = torch.exp(torch.bmm(q.float(), k.float().transpose(1, 2))
                      - lse[..., None])
        faults = {"dV zeroed": torch.zeros_like(dv)}
        if q.shape[1] == k.shape[1]:
            faults["dV = P dO"] = torch.bmm(p, dout.float()).to(dv.dtype)
        else:
            half = q.shape[1] // 2
            faults["dV of half the queries"] = torch.bmm(
                p[:, :half].transpose(1, 2), dout[:, :half].float()).to(
                    dv.dtype)
        del p
    return {name: (relative_error(f, dv, GRADCAM_SCALE_FLOOR),
                   relative_error(f, dv, 1.0)) for name, f in faults.items()}


def gate_planted_faults(tag, n, errs):
    """The K2-bwd gate against planted_fault_errors' faults on the N ``n``
    call: each must exceed ATTN_BWD_BF16_TOL of dV's own scale. Prints
    each one's error by that rule and by max(1, scale)."""
    log(tag, f"planted K2-bwd faults on the N {n} call, dV's error of its "
        "own scale / of max(1, scale): " + ", ".join(
            f"{name} {a:.3e} / {b:.3e}" for name, (a, b) in errs.items())
        + f" (gate {ATTN_BWD_BF16_TOL} of its own scale)")
    missed = [name for name, (a, _) in errs.items()
              if not a > ATTN_BWD_BF16_TOL]
    if missed:
        raise AssertionError(f"{tag}: the K2-bwd gate passes the planted "
                             f"faults {missed}")


def time_backward_calls(calls, smi):
    """K2-bwd alone on each captured call's inputs (one clip at 256²):
    the kernels, the plain version, SDPA's backward, the bound."""
    import torch.nn.functional as F

    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import (
        attention_backward, backward_split, flash_attention_backward)

    for q, k, v, out, lse, dout, _ in calls:
        b, n, d = q.shape
        m, c = v.shape[1], v.shape[2]
        k_ms = cuda_ms(lambda: flash_attention_backward(q, k, v, out, lse,
                                                        dout))
        p_ms = cuda_ms(lambda: attention_backward(q, k, v, out, lse, dout),
                       iters=2, reps=3)
        q4, k4, v4 = (t[:, None].detach().requires_grad_()
                      for t in (q, k, v))
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), dout[:, None], retain_graph=True))
        flops, nbytes, exps = attention_backward_cost(b, n, m, d, c)
        t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_exp = exps / EXP_RATE * 1e3
        bound = max(t_ops, t_bytes, t_exp)
        by = "bytes" if t_bytes == bound else "operations"
        split = backward_split(b, n, m, d, c) if q.dtype == torch.bfloat16 \
            else {}
        log("gradcam", f"K2-bwd {str(q.dtype)[6:]} B {b} N {n} M {m} D {d} "
            f"C {c}: kernels {k_ms:.4f} ms | plain {p_ms:.4f} ms | sdpa "
            f"({sdpa_backend(q4, k4, v4)}) backward {lib_ms:.4f} ms | bound "
            f"{bound:.5f} ms ({by}) | kernels/bound {k_ms / bound:.2f} | "
            f"split {split} | {smi}")
        del q4, k4, v4, o4


def trace_kernel_ms(name):
    """Device ms of K2's and of K2-bwd's kernels in the traced window
    ``name`` (trace_window's trace), and of all its kernels."""
    from efficient_slowfast_tpu_torch.utils import profiler

    with open(os.path.join(smoke_dir(), f"profile_{name}",
                           profiler.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    k2 = bwd = total = 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        total += e["dur"]
        if "attention_bwd" in e["name"]:
            bwd += e["dur"]
        elif "flash_attention" in e["name"]:
            k2 += e["dur"]
    return k2 / 1e3, bwd / 1e3, total / 1e3


def phase_gradcam(smi):
    """Phase 16: Grad-CAM of CMDA-R50 on one synthetic test clip. Returns
    the launch counts of its main-path calls and the worst K2 and K2-bwd
    errors."""
    from efficient_slowfast_tpu_torch.data.build import build_dataset
    from efficient_slowfast_tpu_torch.visualization.video_cam import (
        gradcam_clip, save_gif)

    cfg = gradcam_cfg()
    clip = np.ascontiguousarray(
        build_dataset(cfg.TEST.DATASET, cfg, "test")._fetch(1)[0])
    log("gradcam", f"clip {tuple(clip.shape)} (synthetic test split, video "
        "0, temporal view 0, the centre crop)")
    model = serving_model(cfg, SEED)
    calibrate_attention(cfg, model, SEED + 16, phase="gradcam")
    state = model.state_dict()
    models = {(dtype, flash): model_with(gradcam_cfg(dtype, flash), state)
              for dtype in ("bfloat16", "float32") for flash in (True, False)
              if (dtype, flash) != ("bfloat16", True)}
    models[("bfloat16", True)] = model
    total = dict.fromkeys(KERNELS, 0)
    worst_fwd, worst_bwd, timed = 0.0, 0.0, set()
    for target, calls in GRADCAM_TARGETS:
        runs = {}
        for dtype, flash in (("bfloat16", True), ("bfloat16", False),
                             ("float32", False), ("float32", True)):
            if dtype == "float32" and flash and target != "s4":
                continue
            res, counts, rec, fwd_calls = gradcam_run(
                "gradcam", gradcam_cfg(dtype, flash), models[(dtype, flash)],
                clip, target, calls, smi)
            runs[(dtype, flash)] = res
            bwd_calls = rec.calls
            if flash:
                log("gradcam", f"{target} {dtype}: launches {counts}")
                worst_f, worst_b = hold_gradcam_calls(target, dtype, rec,
                                                      fwd_calls)
                worst_fwd = max(worst_fwd, worst_f)
                worst_bwd = max(worst_bwd, worst_b)
                for key, value in counts.items():
                    total[key] += value
                if dtype == "bfloat16" and target == "s4":
                    gate_planted_faults("gradcam", bwd_calls[0][0].shape[1],
                                        planted_fault_errors(bwd_calls[0]))
                if dtype == "bfloat16":
                    # each fusion's backward alone, once (s4_fuse's, then
                    # s3_fuse's)
                    time_backward_calls([c for c in bwd_calls
                                         if c[0].shape[1] not in timed], smi)
                    timed.update(c[0].shape[1] for c in bwd_calls)
                    if target == "s4":
                        bf16_s4 = res
            del bwd_calls, rec, fwd_calls
        ref = runs[("float32", False)]
        e_k = cam_distance(runs[("bfloat16", True)], ref)
        e_p = cam_distance(runs[("bfloat16", False)], ref)
        top = [int(np.argmax(r["predictions"])) for r in runs.values()]
        log("gradcam", f"{target} bf16 CAMs, L2 distance from the f32 plain "
            f"path's: kernels {e_k:.4e}, plain {e_p:.4e} (ratio "
            f"{e_k / max(e_p, 1e-30):.3f}, gate {CMDA_TRAIN_BF16_RATIO}); "
            f"top-1 class of each run {top} | {smi}")
        if e_k > CMDA_TRAIN_BF16_RATIO * e_p:
            raise AssertionError(f"gradcam {target}: bf16 kernel CAMs {e_k} "
                                 f"from f32, plain bf16 {e_p}")
        if ("float32", True) in runs:
            err = max(float(np.abs(a - b).max()) for a, b in zip(
                runs[("float32", True)]["cams"], ref["cams"]))
            log("gradcam", f"{target} f32 CAMs, kernels vs plain attention: "
                f"max abs {err:.3e} (tol {GRADCAM_F32_ATOL})")
            if err > GRADCAM_F32_ATOL:
                raise AssertionError(f"gradcam {target} f32: {err}")
        # time and memory of the kernel path's Grad-CAM call alone, through
        # the tool's core as the gates drive it
        call = lambda: gradcam_clip(cfg, model, clip, target)  # noqa: E731
        ms = cuda_ms(call, iters=1, reps=3)  # host-bound: ~0.3 s a call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        name = f"gradcam_{target}"
        share, _, _, _ = trace_window(name, call)
        k2_ms, bwd_ms, dev_ms = trace_kernel_ms(name)
        log("gradcam", f"{target} bf16: {ms:.2f} ms a Grad-CAM call (CUDA "
            f"events over gradcam_clip: 1 clip to the host, the test "
            f"preprocess at 256², forward and backward to {target}, the CAMs "
            f"and the overlays on the host) | "
            f"device time in one traced call {dev_ms:.3f} ms, of it K2 "
            f"{k2_ms:.3f} ms and K2-bwd {bwd_ms:.3f} ms (torch.profiler) | "
            f"device busy {share * 100:.1f}% | peak memory {peak:.2f} GiB "
            f"| {smi}")
        del runs
        torch.cuda.empty_cache()
    # the tool's core writes the overlays as GIFs (mp4 needs the decoder,
    # which the card's machine cannot build)
    out = os.path.join(smoke_dir(), "gradcam")
    os.makedirs(out, exist_ok=True)
    for p, (overlay, fps) in enumerate(zip(bf16_s4["overlays"],
                                           bf16_s4["fps"])):
        path = save_gif(os.path.join(out, f"gradcam_s4_pathway{p}.gif"),
                        overlay, fps)
        crop = cfg.DATA.TEST_CROP_SIZE
        if overlay.shape[1:] != (crop, crop, 3) or os.path.getsize(path) == 0:
            raise AssertionError(f"gradcam: overlay {overlay.shape}, {path}")
        log("gradcam", f"pathway {p}: {overlay.shape[0]} overlay frames at "
            f"{fps} fps -> {os.path.relpath(path, ROOT)} "
            f"({os.path.getsize(path)} bytes)")
    del models, model
    torch.cuda.empty_cache()
    return total, worst_fwd, worst_bwd


# ---------------------------------------------------------------------------
# Phase 17: the demo (engine/demo.py) on the card
# windows a demo run serves (a synthetic stream; the card's machine cannot
# build the video decoder, so no file source)
DEMO_WINDOWS = 2
# the raw frames of the Kinetics streams: 4:3 landscape, as a camera gives
# them; the demo fits each window's short side to TEST_CROP_SIZE (256 →
# 256 x 341) on the host
DEMO_FRAME_HW = (256, 341)
# the AVA stream's: 16:9, as AVA's movies (phase 13's AVA_FRAME_HW)
DEMO_AVA_HW = (320, 568)
# normalized person boxes of the AVA demo's boxes file, by window: two
# people, one, three
DEMO_BOXES = {"0": [[0.10, 0.15, 0.45, 0.95], [0.55, 0.10, 0.90, 0.90]],
              "1": [[0.30, 0.20, 0.70, 0.98]],
              "2": [[0.05, 0.30, 0.30, 0.90], [0.35, 0.25, 0.60, 0.95],
                    [0.65, 0.05, 0.95, 0.85]]}
DEMO_DETECTOR = '''
import numpy as np

CALLS = []


def detect(frames, widx):
    """Two people a window, over the raw frames."""
    CALLS.append((widx, frames.shape))
    return np.asarray([[0.1, 0.2, 0.4, 0.9], [0.5, 0.1, 0.8, 0.95]],
                      np.float32)
'''


def demo_cfg(yaml, name, *opts):
    """demo/``yaml`` through the port's config loader: its labels by an
    absolute path, no output file, logs and any calibration under a fresh
    build/smoke/demo_``name``, and ``opts``."""
    from efficient_slowfast_tpu_torch.config import load_cfg

    out = os.path.join(smoke_dir(), f"demo_{name}")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_cfg(os.path.join(ROOT, "demo", yaml), [
        "DEMO.DATA_SOURCE", "0", "DEMO.OUTPUT_FILE", "", "OUTPUT_DIR", out]
        + list(opts))
    cfg.DEMO.LABEL_FILE_PATH = os.path.normpath(os.path.join(
        ROOT, cfg.DEMO.LABEL_FILE_PATH))
    return cfg


def demo_checkpoint(cfg, name, attention_seed=None):
    """Seeded weights in the JAX package's layout (serving_model) for
    ``cfg``, CMDA's attention calibrated as phase 5 does where
    ``attention_seed`` is given, saved as build/smoke/demo_``name``.pyth;
    returns its path (the demo's TEST.CHECKPOINT_FILE_PATH)."""
    model = serving_model(cfg, SEED)
    if attention_seed is not None:
        calibrate_attention(cfg, model, attention_seed, phase="demo")
    path = os.path.join(smoke_dir(), f"demo_{name}.pyth")
    torch.save({"model_state": model.state_dict()}, path)
    del model
    torch.cuda.empty_cache()
    return path


def demo_windows(hw, seed, frames):
    """DEMO_WINDOWS seeded windows of ``frames`` uint8 RGB frames at
    ``hw``: [(window index, (T, H, W, 3))]."""
    rs = np.random.RandomState(seed)
    return [(w, rs.randint(0, 256, (frames,) + tuple(hw) + (3,), np.uint8))
            for w in range(DEMO_WINDOWS)]


class DisplaySink:
    """The demo's display: records the launch counts when each window's
    overlays reach it (after the window's scores reached the host), and
    never quits."""

    def __init__(self):
        self.counts = []

    def __call__(self, frames):
        self.counts.append(read_counts())
        return True

    def per_window(self, key):
        """``key``'s launches in each window (the first with the warm-up)."""
        seen = [c[key] for c in self.counts]
        return [b - a for a, b in zip([0] + seen[:-1], seen)]


class ForwardCalls:
    """Every forward that the demo builds while the block runs, each call's
    inputs and scores recorded; ``model`` is the served model."""

    def __init__(self, detection=False):
        self.name = "make_detection_forward" if detection else "make_forward"
        self.calls, self.model = [], None

    def __enter__(self):
        from efficient_slowfast_tpu_torch.engine import demo

        self.mod, self.orig = demo, getattr(demo, self.name)

        def make(cfg, model, device=None):
            fwd = self.orig(cfg, model, device)
            self.model = model

            def recorded(*args):
                out = fwd(*args)
                self.calls.append((args, out))
                return out
            return recorded

        setattr(demo, self.name, make)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


class Int8Calls:
    """The last ``keep`` int8 conv calls while the block runs (one window's
    worth): their arguments and outputs; the launches stay on K3's count."""

    def __init__(self, keep):
        self.calls = collections.deque(maxlen=keep)

    def __enter__(self):
        import efficient_slowfast_tpu_torch.ops.conv as conv_mod

        self.mod, self.orig = conv_mod, conv_mod.int8_conv

        def recorded(*args):
            out = self.orig(*args)
            self.calls.append((args, out))
            return out

        conv_mod.int8_conv = recorded
        return self

    def __exit__(self, *exc):
        self.mod.int8_conv = self.orig


def traced_stream(windows, name):
    """``windows`` as a stream whose last window runs under utils/
    profiler.py's trace, in a smoke_window span from just before the demo
    takes it to just after the demo asks for the next: its canvas fit,
    copy, preprocess, forward, scores to the host and log line."""
    from efficient_slowfast_tpu_torch.utils import profiler

    windows = iter(windows)
    for i, item in enumerate(windows):
        if i < DEMO_WINDOWS - 1:
            yield item
            continue
        torch.cuda.synchronize()
        with profiler.trace(os.path.join(smoke_dir(), f"profile_{name}")):
            with profiler.annotate("smoke_window"):
                yield item
                torch.cuda.synchronize()


def demo_run(cfg, windows, display=True, trace=None, k2_calls=None,
             detection=False):
    """One demo() call over ``windows`` with every launch count set to 0
    just before and read just after: {results, counts, sink, fwd (the
    ForwardCalls), peak (GiB)}. ``display`` injects a DisplaySink
    (the overlays run); ``trace`` traces the last window under that name;
    ``k2_calls`` gets each K2 call's (q, k, v, output)."""
    from efficient_slowfast_tpu_torch.engine.demo import demo

    sink = DisplaySink() if display else None
    stream = windows if trace is None else traced_stream(windows, trace)
    with ForwardCalls(detection) as fwd:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        results, _ = k2_shapes_of(
            lambda: demo(cfg, stream=iter(stream), display=sink), k2_calls)
        torch.cuda.synchronize()
        counts = read_counts()
    return dict(results=results, counts=counts, sink=sink, fwd=fwd,
                peak=torch.cuda.max_memory_allocated() / 2 ** 30)


def window_ms(rows, frames):
    """ms a window from the demo's own logged fps (``frames`` frames over
    the wall time from the previous window's scores on the host to this
    one's, or from the warm-up's end for window 0): the mean over
    ``rows``."""
    return statistics.mean(1e3 * frames / r["fps"] for r in rows)


# the hand-written kernels' names in a trace
TRACE_KERNELS = {"K1": ("fused_bottleneck",), "K2": ("flash_attention_tc",
                                                     "flash_attention_k"),
                 "K3": ("conv_quantize", "conv_gemm")}


def demo_report(tag, cfg, run, plain, name, smi):
    """Prints a served configuration's line: ms a window with the overlays
    (``run``'s windows after the first, each of whose intervals holds the
    window before's overlays) and without (``plain``'s windows but the
    last, which was traced), the logged fps, the traced window's device
    time, its hand-written kernels' share of it, busy share and
    host-to-device bytes, peak memory and the launches."""
    from efficient_slowfast_tpu_torch.utils import profiler

    share, span_ms, _, _ = window_profile(name)
    with open(os.path.join(smoke_dir(), f"profile_{name}",
                           profiler.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    dev_ms = sum(e["dur"] for e in kernels) / 1e3
    ours = {k: sum(e["dur"] for e in kernels
                   if any(p in e["name"] for p in pats)) / 1e3
            for k, pats in TRACE_KERNELS.items()}
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    h2d = sum(e.get("args", {}).get("bytes", 0) for e in copies
              if "HtoD" in e["name"])
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.TEST_CROP_SIZE
    canvas = t * s * 2 * s * 3
    if h2d < canvas:  # name the copies the trace holds
        seen = collections.Counter(
            (e["name"], e.get("args", {}).get("bytes")) for e in copies)
        log("demo", f"{tag}: the traced window's copies {dict(seen)}")
    log("demo", f"{tag}: {window_ms(run['results'][1:], t):.2f} ms a window "
        f"with the overlays, {window_ms(plain['results'][:-1], t):.2f} ms "
        f"without (wall clock, the scores on the host; the demo's logged "
        f"fps {[r['fps'] for r in run['results']]} / "
        f"{[r['fps'] for r in plain['results']]}) | traced window: device "
        f"time {dev_ms:.3f} ms (" + ", ".join(
            f"{k} {v:.3f}" for k, v in ours.items() if v) + f"), busy "
        f"{share * 100:.1f}% of its {span_ms:.2f} ms, host-to-device "
        f"{h2d / 1e6:.3f} MB (the canvas {canvas / 1e6:.3f} MB) | peak "
        f"memory "
        f"{max(run['peak'], plain['peak']):.2f} GiB | launches "
        f"{run['counts']} in the run with the overlays | "
        f"{smi}")


def gate_windows(tag, run, key, per_window, warm):
    """Each window's launches of ``key`` per_window (the first also the
    warm-up's where ``warm``), and no other kernel's."""
    got = run["sink"].per_window(key)
    want = [per_window * (2 if warm else 1)] + [per_window] * (
        DEMO_WINDOWS - 1)
    others = {k: v for k, v in run["counts"].items() if k != key and v}
    if got != want or others or len(run["results"]) != DEMO_WINDOWS:
        raise AssertionError(f"demo {tag}: {key} launches by window {got}, "
                             f"expected {want}; others {others}; "
                             f"{len(run['results'])} windows")


def demo_scores(tag, run, classes, detection=False):
    """The windows' scores ([n, classes] on the host, the warm-up left
    out), checked finite; probabilities summing to 1 for classification,
    in [0, 1] for the RoI head's sigmoids."""
    outs = [o.float().cpu() for _, o in run["fwd"].calls[-DEMO_WINDOWS:]]
    for i, o in enumerate(outs):
        if detection:
            if not (bool(torch.isfinite(o).all()) and o.min() >= 0
                    and o.max() <= 1):
                raise AssertionError(f"demo {tag} window {i}: scores")
        else:
            check_scores(o, 1, classes, f"demo {tag} window {i}")
    return outs


def hold_against(tag, what, cfg_ref, model, run, tol, smi):
    """The windows' bf16 scores against those of the same pathways through
    make_forward(cfg_ref) on ``model`` (``what``: no kernel), within
    ``tol`` of their scale, as phases 4 and 5 hold a request's. Returns
    the reference scores."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    ref_fwd = make_forward(cfg_ref, model)
    outs = demo_scores(tag, run, cfg_ref.MODEL.NUM_CLASSES)
    reset_counts()
    refs = [ref_fwd(*args).float().cpu()
            for args, _ in run["fwd"].calls[-DEMO_WINDOWS:]]
    if any(read_counts().values()):
        raise AssertionError(f"demo {tag}: the reference launched "
                             f"{read_counts()}")
    err = max((o - r).abs().max().item() for o, r in zip(outs, refs))
    scale = max(1.0, max(r.abs().max().item() for r in refs))
    top = [int(o.argmax()) == int(r.argmax()) for o, r in zip(outs, refs)]
    # the entries are the scores' top-k, rounded as the demo logs them
    for entry, o in zip(run["results"], outs):
        k = len(entry["top_classes"])
        labels = [i for i in np.argsort(-o[0].numpy())[:k]]
        if [round(float(o[0, i]), 4) for i in labels] != entry["scores"]:
            raise AssertionError(f"demo {tag}: entry {entry} is not its "
                                 f"scores' top-{k}")
    log("demo", f"{tag}: the {DEMO_WINDOWS} windows' scores vs {what} on "
        f"the same pathways: max |dp| {err:.3e} (tol {tol * scale:.3e}"
        f"), top-1 agreement {sum(top)}/{len(top)}, top-1 p "
        f"{[round(float(o.max()), 4) for o in outs]} | {smi}")
    if err > tol * scale:
        raise AssertionError(f"demo {tag}: {err} > {tol} x {scale}")
    return refs


def hold_demo_k3(calls, smi):
    """Each recorded int8 conv call (one window's) against K3's plain
    version on its inputs: the quantize pass's code buffer and weight
    layout, the int32 accumulators and the output, bit for bit."""
    from efficient_slowfast_tpu_torch.ops.kernels import int8_conv as k3

    shapes = set()
    for args, out in calls:
        x, codes, scale, am, bias, k, s, p, dtype = args
        pl = k3.plan(tuple(x.shape), codes.shape[0], tuple(k), tuple(s),
                     tuple(p), dtype)
        q, bq = k3.int8_conv_layout(x, codes, am, k, s, p)
        acc = k3.int8_conv_accumulator(x, codes, am, k, s, p)
        ref_acc = k3.int8_conv_reference(x, codes, scale, am, None, k, s, p,
                                         dtype, True)
        ref = k3.int8_conv_reference(x, codes, scale, am, bias, k, s, p,
                                     dtype)
        torch.cuda.synchronize()
        if not (torch.equal(q, k3.quantized_layout(x, am, pl))
                and torch.equal(bq, k3.padded_codes(codes, pl))):
            raise AssertionError(f"demo int8 {tuple(x.shape)}: the quantize "
                                 "pass's codes differ from the plain version")
        if not torch.equal(acc, ref_acc) or not torch.equal(out, ref):
            raise AssertionError(
                f"demo int8 {tuple(x.shape)} k {k} s {s}: accumulators or "
                f"output differ, max |d| out "
                f"{(out.float() - ref.float()).abs().max().item()}")
        shapes.add((tuple(x.shape), codes.shape[0], tuple(k), tuple(s)))
    log("demo", f"int8: each of one window's {len(calls)} K3 calls "
        f"({len(shapes)} shapes at batch 1, e.g. "
        f"{sorted(shapes)[0]}) against its plain version on its inputs: "
        f"codes, accumulators and output bit-equal | {smi}")


def phase_demo(smi):
    """Phase 17: the demo served on the card over synthetic window
    streams, through engine/demo.py::demo as the CLI calls it. Returns the
    launches of its runs and K2's worst error."""
    import efficient_slowfast_tpu_torch.engine.quantize as quantize
    from efficient_slowfast_tpu_torch.ops.kernels import \
        flash_attention as fa

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)

    def add(counts):
        for key, value in counts.items():
            total[key] += value

    # (a) SlowFast-R50 on the fused engine
    sf_opts = ["TPU.FUSED_EVAL", True]
    cfg = demo_cfg("Kinetics/SLOWFAST_8x8_R50.yaml", "slowfast", *sf_opts)
    sf_ckpt = demo_checkpoint(cfg, "slowfast")
    cfg.TEST.CHECKPOINT_FILE_PATH = sf_ckpt
    windows = demo_windows(DEMO_FRAME_HW, SEED + 170, cfg.DATA.NUM_FRAMES)
    log("demo", f"stream: {DEMO_WINDOWS} windows of {cfg.DATA.NUM_FRAMES} "
        f"frames at {DEMO_FRAME_HW[0]}x{DEMO_FRAME_HW[1]} (seeded uint8); "
        f"seeded weights from {os.path.relpath(sf_ckpt, ROOT)}")
    run = demo_run(cfg, windows)
    gate_windows("slowfast", run, "fused_bottleneck", 26, True)
    add(run["counts"])
    model = run["fwd"].model
    ref_cfg = cfg.clone()
    ref_cfg.TPU.FUSED_EVAL = False
    sf_refs = hold_against("slowfast", "the module forward", ref_cfg, model,
                           run, SERVE_BF16_ATOL, smi)
    del model
    run["fwd"].calls.clear()
    plain = demo_run(cfg, windows, display=False, trace="demo_slowfast")
    demo_report("SlowFast-R50 (demo/Kinetics/SLOWFAST_8x8_R50.yaml, "
                "FUSED_EVAL, bf16, 1 clip of 32 frames at 256²: K1 26 a "
                "window)", cfg, run, plain, "demo_slowfast", smi)
    del run, plain
    torch.cuda.empty_cache()

    # (b) CMDA-R50, the paper's model
    cfg = demo_cfg("Kinetics/SLOWFAST_DUAL_8x8_R50_stepwise_multigrid.yaml",
                   "cmda")
    cfg.TEST.CHECKPOINT_FILE_PATH = demo_checkpoint(cfg, "cmda", SEED + 171)
    k2 = []
    run = demo_run(cfg, windows, k2_calls=k2)
    gate_windows("cmda", run, "flash_attention", 4, True)
    add(run["counts"])
    with torch.no_grad():
        errs = [(q.shape[1], relative_error(o, fa.chunked_attention(q, k, v),
                                            GRADCAM_SCALE_FLOOR))
                for q, k, v, o in k2]
    k2_worst = max(e for _, e in errs)
    log("demo", f"cmda: each of its {len(k2)} K2 calls (the warm-up's and "
        f"{DEMO_WINDOWS} windows' 4) against chunked_attention on its "
        f"inputs, the worst error of its own scale by N: " + ", ".join(
            f"{n} {max(e for m, e in errs if m == n):.3e}"
            for n in sorted({n for n, _ in errs}, reverse=True))
        + f" (tol {ATTN_BF16_TOL})")
    if k2_worst > ATTN_BF16_TOL:
        raise AssertionError(f"demo cmda: K2 {k2_worst} > {ATTN_BF16_TOL}")
    del k2
    plain_cfg = cfg.clone()
    plain_cfg.TPU.FLASH_ATTENTION = False
    plain_model = model_with(plain_cfg, run["fwd"].model.state_dict())
    hold_against("cmda", "the plain attention", plain_cfg, plain_model, run,
                 CMDA_BF16_ATOL, smi)
    del plain_model
    run["fwd"].calls.clear()
    plain = demo_run(cfg, windows, display=False, trace="demo_cmda")
    demo_report("CMDA-R50 (demo/Kinetics/SLOWFAST_DUAL_8x8_R50_stepwise_"
                "multigrid.yaml, bf16, 32 frames at 224²: K2 4 a window)",
                cfg, run, plain, "demo_cmda", smi)
    del run, plain
    torch.cuda.empty_cache()

    # (c) int8 SlowFast-R50: the first run calibrates on its first window
    # and persists, the second loads the file
    cfg = demo_cfg("Kinetics/SLOWFAST_8x8_R50.yaml", "int8",
                   "TPU.INT8_EVAL", True)
    cfg.TEST.CHECKPOINT_FILE_PATH = sf_ckpt
    real, calibrations = quantize.calibrate_int8, []
    quantize.calibrate_int8 = lambda *a, **k: (
        calibrations.append(1) or real(*a, **k))
    try:
        run = demo_run(cfg, windows)
        first = len(calibrations)
        convs = len(quantize.quant_state(run["fwd"].model))
        persisted = os.path.exists(quantize.calibration_path(cfg))
        gate_windows("int8", run, "int8_conv", convs, False)
        add(run["counts"])
        outs = demo_scores("int8", run, cfg.MODEL.NUM_CLASSES)
        dist = max((centred_logs(o) - centred_logs(r)).abs().max().item()
                   for o, r in zip(outs, sf_refs))
        scale = max(centred_logs(r).abs().max().item() for r in sf_refs)
        run["fwd"].calls.clear()
        with Int8Calls(convs) as k3_calls:
            plain = demo_run(cfg, windows, display=False, trace="demo_int8")
        loaded = len(calibrations) - first
    finally:
        quantize.calibrate_int8 = real
    if (first, persisted, loaded) != (1, True, 0) or convs != 47:
        raise AssertionError(f"demo int8: {first} calibrations in the first "
                             f"run (persisted: {persisted}), {loaded} in the"
                             f" second; {convs} int8 convs")
    if plain["counts"]["int8_conv"] != convs * (DEMO_WINDOWS + 1):
        raise AssertionError(f"demo int8, loaded: {plain['counts']}")
    add(plain["counts"])
    log("demo", f"int8: {convs} int8 convs; run 1 calibrated on its first "
        f"window ({first} calibrate_int8 call) and persisted "
        f"{os.path.relpath(quantize.calibration_path(cfg), ROOT)}; run 2 "
        f"loaded it (no call, so it warmed up: {plain['counts']['int8_conv']}"
        f" K3 op calls for {DEMO_WINDOWS} windows) | vs the bf16 module "
        f"forward on the same windows: centred log probabilities max |d| "
        f"{dist:.4f} of scale {scale:.4f} (ratio {dist / scale:.3f}, tol "
        f"{INT8_LOGIT_TOL}) | {smi}")
    if dist > INT8_LOGIT_TOL * scale:
        raise AssertionError(f"demo int8: {dist} > {INT8_LOGIT_TOL} x "
                             f"{scale}")
    hold_demo_k3(list(k3_calls.calls), smi)
    del k3_calls
    demo_report("int8 SlowFast-R50 (the same yaml, TPU.INT8_EVAL: K3 47 op "
                "calls a window)", cfg, run, plain, "demo_int8", smi)
    del run, plain
    torch.cuda.empty_cache()

    # (d) AVA SlowFast-R101 detection: boxes from a file, then a camera
    # capture with a live detector
    from efficient_slowfast_tpu_torch.engine.demo import camera_window_stream

    cfg = demo_cfg("AVA/SLOWFAST_32x2_R101_50_50.yaml", "ava")
    boxes = os.path.join(cfg.OUTPUT_DIR, "boxes.json")
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    with open(boxes, "w") as f:
        json.dump(DEMO_BOXES, f)
    cfg.DEMO.BOXES_FILE = boxes
    cfg.TEST.CHECKPOINT_FILE_PATH = demo_checkpoint(cfg, "ava")
    ava = demo_windows(DEMO_AVA_HW, SEED + 172, cfg.DATA.NUM_FRAMES)
    run = demo_run(cfg, ava, detection=True)
    if any(run["counts"].values()) or len(run["results"]) != DEMO_WINDOWS:
        raise AssertionError(f"demo ava: launches {run['counts']}, "
                             f"{len(run['results'])} windows")
    demo_scores("ava", run, cfg.MODEL.NUM_CLASSES, detection=True)
    nboxes = [len(e["boxes"]) for e in run["results"]]
    if nboxes != [len(DEMO_BOXES[str(w)]) for w in range(DEMO_WINDOWS)]:
        raise AssertionError(f"demo ava: boxes by window {nboxes}")
    run["fwd"].calls.clear()
    sys.path.insert(0, cfg.OUTPUT_DIR)
    with open(os.path.join(cfg.OUTPUT_DIR, "smoke_demo_detector.py"),
              "w") as f:
        f.write(DEMO_DETECTOR)
    import smoke_demo_detector

    live = cfg.clone()
    live.DEMO.BOXES_FILE = ""
    live.DEMO.DETECTOR_FN = "smoke_demo_detector:detect"
    seq = live.DATA.NUM_FRAMES * live.DATA.SAMPLING_RATE
    rs = np.random.RandomState(SEED + 173)
    frames = rs.randint(0, 256, (8,) + DEMO_AVA_HW + (3,), np.uint8)

    class Capture:
        """A camera: read() gives BGR frames, DEMO_WINDOWS windows' worth."""
        n = 0

        def read(self):
            if self.n == seq * DEMO_WINDOWS:
                return False, None
            self.n += 1
            return True, frames[self.n % len(frames)][..., ::-1]

    plain = demo_run(live, camera_window_stream(live, Capture()),
                     display=False, trace="demo_ava", detection=True)
    sys.path.remove(cfg.OUTPUT_DIR)
    calls = smoke_demo_detector.CALLS
    want = [(w, (live.DATA.NUM_FRAMES,) + DEMO_AVA_HW + (3,))
            for w in range(DEMO_WINDOWS)]
    if calls != want or any(plain["counts"].values()) or \
            [len(e["boxes"]) for e in plain["results"]] != [2] * DEMO_WINDOWS:
        raise AssertionError(f"demo ava, live detector: calls {calls}, "
                             f"launches {plain['counts']}")
    demo_scores("ava live", plain, live.MODEL.NUM_CLASSES, detection=True)
    top = plain["results"][0]["boxes"][0]
    log("demo", f"ava: boxes file {nboxes} boxes by window; camera capture "
        f"with the live detector (smoke_demo_detector:detect, called once a "
        f"window on the raw {DEMO_AVA_HW[0]}x{DEMO_AVA_HW[1]} frames) 2 a "
        f"window; window 0's first box {top['box']} -> "
        f"{top['top_classes'][:2]} {top['scores'][:2]}; no kernel launched")
    demo_report("AVA SlowFast-R101 detection (demo/AVA/SLOWFAST_32x2_R101_"
                "50_50.yaml, bf16, 32 frames, 256x454 content on the "
                "256x512 canvas; no hand-written kernel)", cfg, run, plain, "demo_ava", smi)
    del run, plain
    torch.cuda.empty_cache()
    log("demo", f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return total, k2_worst


# ---------------------------------------------------------------------------
# phase 18: distribution. The two-rank job's CMDA-R50 train steps, on one
# fixed global batch of TRAIN_CLIPS clips (each rank its half)
DIST_WORLD = 2
DIST_STEPS = 2
# a rank's deadline (it is killed with its process group after it), and
# how long the group's rendezvous and collectives wait for a rank
DIST_DEADLINE_S = 600
DIST_TIMEOUT_S = 300
# The two-rank step against one process on the same global batch, bf16:
# the same arithmetic but for the batch each conv sees (4 clips against
# 8: cuDNN may pick other algorithms, other bf16 summation orders), BN's
# statistics (reduced across the ranks in float32 against cuDNN's) and
# the gradients' sum over the ranks; each of order 2^-8 of a layer's
# values with random signs, as TEST_LOGIT_TOL argues, which over three
# steps at the warm-up lr moves the loss by far less than its own value.
# |loss difference| within 2e-2 of max(1, |loss|), NLN_LOSS_TOL's bf16
# bound for two paths that differ by bf16 roundings.
DIST_LOSS_TOL = 2e-2
# DDP over NCCL at world size 1 against the step without it. The forward
# is the same (the loss is held bit for bit); the gradients go through
# DDP's buckets, a sum over one rank and a division by one, all exact. So
# the parameters after the step differ only where the backward does not
# repeat: K2-bwd's bf16 dQ is summed by atomic adds and cuDNN's weight
# gradients may be too, so a second plain step is not the first's bit for
# bit either. On the H100 (700 W) the DDP step read 6.2e-4 and 1.3e-3 of
# the step's length from the plain one, and a second plain step 4.1e-4
# to 4.4e-4. The bound is 5e-3 of the step's length: about 4x the worst
# reading, and half of what a gradient misscaled by DIST_PLANTED_SCALE
# moves it, which the phase plants (a DDP comm hook) and must see fail.
DIST_DDP_BOUND = 5e-3
DIST_PLANTED_SCALE = 0.99


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_dir():
    path = os.path.join(smoke_dir(), "dist18")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def param_distance(a, b, keys):
    return sum((a[k].double() - b[k].double()).norm().item() ** 2
               for k in keys) ** 0.5


def dist_train(cfg, state_dict, batch, device, rows=slice(None),
               steps=DIST_STEPS, record=None, hook=None):
    """``steps`` train steps from ``state_dict`` on rows ``rows`` of the
    global ``batch`` through create_train_state (DDP in a process group,
    with the comm ``hook`` where given) and make_train_step, the dropout
    drawn from a seeded generator, at the yaml's warm-up lr; the first
    step inside ``record`` where given. Returns (state, losses, the later
    steps' seconds each)."""
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)
    from efficient_slowfast_tpu_torch.models import build_model

    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    state = create_train_state(cfg, model, device)
    if hook is not None:
        state.ddp.register_comm_hook(None, hook)
    step = make_train_step(cfg, state.model, state.optimizer)
    x = [t[rows].to(device) for t in batch[0]]
    y = batch[1][rows].to(device)
    drop = torch.Generator(device=device).manual_seed(SEED)
    lr = cfg.SOLVER.WARMUP_START_LR
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if i == 0 and record is not None:
            with record:
                mets = step(state, x, y, lr, drop)
        else:
            mets = step(state, x, y, lr, drop)
        losses.append(mets["loss"].item())
        torch.cuda.synchronize(device)
        if i:
            times.append(time.perf_counter() - t0)
    return state, losses, times


def misscaled_gradients(_, bucket):
    """A DDP comm hook that plants a fault: the bucket's gradients times
    DIST_PLANTED_SCALE, not reduced (world size 1)."""
    fut = torch.futures.Future()
    fut.set_result(bucket.buffer().mul_(DIST_PLANTED_SCALE))
    return fut


def phase_dist_nccl(cfg, state_dict, batch, smi):
    """(a) One CMDA-R50 step through DDP over NCCL at world size 1 against
    the same step without a process group (twice), and a DDP step with
    misscaled gradients that the gate must refuse. Returns the DDP step's
    launch counts."""
    from efficient_slowfast_tpu_torch.parallel import distributed

    params = [k for k in state_dict if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    one = lambda **kw: dist_train(cfg, state_dict, batch, "cuda",  # noqa
                                  steps=1, **kw)

    def after(run):
        state, losses, _ = run
        out = {k: v.detach().clone() for k, v in state.model.state_dict()
               .items()}
        return out, losses[0], state.ddp is not None

    plain, loss_p, _ = after(one())
    again, loss_a, _ = after(one())
    gcfg = cfg.clone()
    gcfg.DIST_BACKEND = "nccl"
    gcfg.NUM_SHARDS, gcfg.SHARD_ID, gcfg.NUM_GPUS = 1, 0, 1
    distributed.TIMEOUT_S = DIST_TIMEOUT_S
    distributed.init_distributed(gcfg, 0, torch.device("cuda", 0),
                                 f"tcp://127.0.0.1:{free_port()}")
    try:
        backend = torch.distributed.get_backend()
        world = distributed.world_size()
        reset_counts()
        ddp, loss_d, wrapped = after(one())
        counts = read_counts()
        fault, loss_f, _ = after(one(hook=misscaled_gradients))
    finally:
        distributed.destroy_distributed()
    step = param_distance(plain, state_dict, params)
    r_ddp = param_distance(ddp, plain, params) / step
    r_again = param_distance(again, plain, params) / step
    r_fault = param_distance(fault, plain, params) / step
    log("dist", f"(a) CMDA-R50, bf16, {TRAIN_CLIPS} clips at 224², one step "
        f"through DDP over {backend} at world size {world} against the "
        f"step without a process group: loss {loss_d!r} vs {loss_p!r} "
        f"(a second plain step {loss_a!r}; held bit for bit); parameters, "
        f"distance from the plain step over the step's length: DDP "
        f"{r_ddp:.3e}, a second plain step {r_again:.3e}, DDP with the "
        f"gradients planted x{DIST_PLANTED_SCALE} {r_fault:.3e} (loss "
        f"{loss_f!r}; bound {DIST_DDP_BOUND}) | kernel launches {counts} | "
        f"{smi}")
    expect = {"fused_bottleneck": 0, "flash_attention": 4,
              "flash_attention_backward": 12, "int8_conv": 0}
    if not (wrapped and backend == "nccl" and world == 1):
        raise AssertionError(f"dist (a): DDP {wrapped}, {backend}, {world}")
    if counts != expect:
        raise AssertionError(f"dist (a): launches {counts}, expected {expect}")
    if loss_d != loss_p or not r_ddp <= DIST_DDP_BOUND:
        raise AssertionError(f"dist (a): loss {loss_d!r} vs {loss_p!r}, "
                             f"parameters {r_ddp} (bound {DIST_DDP_BOUND})")
    if not r_fault > DIST_DDP_BOUND:
        raise AssertionError(f"dist (a): the gate passes gradients planted "
                             f"x{DIST_PLANTED_SCALE}: {r_fault}")
    return counts


def collective_ms(prof):
    """{op: (calls, CPU ms)} of the collectives' records in a profile
    (gloo's and c10d's all-reduce, broadcast and all-gather): the host's
    time to issue them, not the time it waits for them."""
    pattern = re.compile(r"gloo|allreduce|all_reduce|broadcast|allgather",
                         re.I)
    return {e.key: (e.count, e.cpu_time_total / 1e3)
            for e in prof.key_averages() if pattern.search(e.key)}


def rank18_job(cfg, device):
    """One rank of phase 18 (b), in a process group that ``launch_job``
    joined: the CMDA-R50 train steps on this rank's half of the global
    batch (the first step's attention calls recorded and held against the
    plain versions on their inputs at their own scale, with planted
    faults on the smallest; one more step traced, its synchronous
    all-reduces timed on the host), then the 30-view test; its results
    in the job's directory."""
    from efficient_slowfast_tpu_torch.engine.state import make_train_step
    from efficient_slowfast_tpu_torch.engine.test import test
    from efficient_slowfast_tpu_torch.ops.kernels import \
        flash_attention as fa
    from efficient_slowfast_tpu_torch.parallel import distributed
    from efficient_slowfast_tpu_torch.utils import profiler

    job = torch.load(os.path.join(cfg.OUTPUT_DIR, "job.pt"),
                     weights_only=False)
    rank, world = distributed.rank(), distributed.world_size()
    b = job["batch"][1].shape[0] // world
    torch.cuda.reset_peak_memory_stats(device)
    rec = BackwardCalls()
    reset_counts()
    state, losses, times = dist_train(
        job["train_cfg"], job["state"], job["batch"], device,
        rows=slice(rank * b, (rank + 1) * b), record=rec)
    counts = read_counts()
    train_peak = torch.cuda.max_memory_allocated(device)  # before the holds
    with torch.no_grad():
        fwd = [(q.shape[1], relative_error(out, fa.chunked_attention(q, k, v),
                                           GRADCAM_SCALE_FLOOR),
                out.float().abs().max().item())
               for q, k, v, out, _, _, _ in rec.calls]
    bwd = rec.held(GRADCAM_SCALE_FLOOR)
    small = min(rec.calls, key=lambda c: c[0].shape[1])
    planted = (small[0].shape[1], planted_fault_errors(small))
    calls = len(rec.calls)
    del rec, small
    step = make_train_step(job["train_cfg"], state.model, state.optimizer)
    x = [t[rank * b:(rank + 1) * b].to(device) for t in job["batch"][0]]
    y = job["batch"][1][rank * b:(rank + 1) * b].to(device)
    # the host's wall time inside each synchronous all-reduce (BN's
    # statistics, the metrics): gloo copies a CUDA tensor to the host once
    # the stream reaches it, so this is the wait for the card to drain plus
    # the exchange; DDP's bucket all-reduces are issued from C++ and wait
    # at the backward's end
    waits, all_reduce = [], torch.distributed.all_reduce

    def timed(*args, **kw):
        t = time.perf_counter()
        out = all_reduce(*args, **kw)
        waits.append(time.perf_counter() - t)
        return out

    name = f"dist18_rank{rank}"
    torch.distributed.all_reduce = timed
    try:
        torch.cuda.synchronize(device)
        with profiler.trace(os.path.join(smoke_dir(), f"profile_{name}")) \
                as prof:
            with profiler.annotate("smoke_window"):
                step(state, x, y, job["train_cfg"].SOLVER.WARMUP_START_LR,
                     torch.Generator(device=device).manual_seed(SEED))
                torch.cuda.synchronize(device)
    finally:
        torch.distributed.all_reduce = all_reduce
    collectives = collective_ms(prof)
    busy, span_ms, _, _ = window_profile(name)
    crc = distributed.state_checksum(state.model)
    del state, step, x, y, prof
    torch.cuda.empty_cache()
    distributed.host_barrier("dist18_train")
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    meter = test(job["test_cfg"], device)
    test_s = time.perf_counter() - t0
    torch.save(dict(
        rank=rank, world=world, losses=losses, step_s=times, counts=counts,
        fwd=fwd, bwd=bwd, planted=planted, calls=calls,
        collectives=collectives, waits=waits, busy=busy, span_ms=span_ms,
        crc=crc, train_peak=train_peak,
        test_counts=read_counts(), test_s=test_s,
        test_peak=torch.cuda.max_memory_allocated(device),
        video_preds=meter.video_preds, num_clips=meter.num_clips,
        stats=meter.stats),
        os.path.join(cfg.OUTPUT_DIR, f"rank{rank}.pt"))


def rank_main(job, argv):
    """A rank process of phase 18 (b), 19 or 20 running ``job``, started
    as the port's CLI is: the flags of ``config/parser.py``
    (``--num_shards``, ``--shard_id``, ``--init_method``, ``--device``)
    through ``launch_job``, TF32 off as phase_device sets it."""
    from efficient_slowfast_tpu_torch.config.parser import (load_config,
                                                            parse_args)
    from efficient_slowfast_tpu_torch.models.build import resolve_device
    from efficient_slowfast_tpu_torch.parallel import distributed
    from efficient_slowfast_tpu_torch.utils.misc import launch_job

    distributed.TIMEOUT_S = DIST_TIMEOUT_S
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = parse_args(argv)
    launch_job(load_config(args), args.init_method, job,
               resolve_device(args.device))


def start_ranks(tag, d, yaml, world, *opts):
    """The ``world`` rank processes of ``tag`` (a key of RANK_JOBS), each
    in a session of its own, over gloo on cuda:0, with ``opts`` after the
    yaml's; its logs and results in ``d``."""
    port = free_port()
    procs = []
    for r in range(world):
        log_path = os.path.join(d, f"rank{r}.log")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), tag,
             "--num_shards", str(world), "--shard_id", str(r),
             "--init_method", f"tcp://127.0.0.1:{port}", "--device",
             "cuda:0", "--cfg", yaml, "DIST_BACKEND", "gloo", *opts,
             "OUTPUT_DIR", d], cwd=ROOT, stdout=open(log_path, "w"),
            stderr=subprocess.STDOUT, start_new_session=True), log_path))
    return procs


def wait_ranks(procs):
    """Wait for every rank until DIST_DEADLINE_S; kill what is left (with
    its process group) and raise with the logs' tails where any failed."""
    import signal

    t0, errors = time.time(), []
    for p, log_path in procs:
        try:
            rc = p.wait(timeout=max(1.0, DIST_DEADLINE_S - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            rc = "killed at the deadline"
        if p.poll() is None or rc != 0:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
            with open(log_path) as f:
                errors.append(f"{log_path}: {rc}\n{f.read()[-4000:]}")
    if errors:
        raise AssertionError("dist (b): a rank failed\n" + "\n".join(errors))


def phase_dist_ranks(cfg, state_dict, batch, smi):
    """(b) Two ranks over gloo on cuda:0, started through the CLI's flags:
    DIST_STEPS CMDA-R50 train steps on the global batch, then the 30-view
    test of SLOWFAST_8x8_R50.yaml with TPU.FUSED_EVAL on the synthetic
    split (240 clips, global batches of 64: each rank 4 of 32, its last 24
    real), each held against one process. Returns the ranks' launches and
    the worst attention errors."""
    from efficient_slowfast_tpu_torch.engine.test import test

    d = dist_dir()
    torch.cuda.reset_peak_memory_stats()
    _, ref_losses, ref_times = dist_train(cfg, state_dict, batch, "cuda")
    ref_peak = torch.cuda.max_memory_allocated()
    # one process on one rank's rows: the peak a rank's batch has alone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist_train(cfg, state_dict, batch, "cuda",
               rows=slice(0, batch[1].shape[0] // DIST_WORLD))
    half_peak = torch.cuda.max_memory_allocated()
    pyth = os.path.join(d, "slowfast.pyth")
    tcfg = yaml_cfg("SLOWFAST_8x8_R50.yaml", [
        "TPU.FUSED_EVAL", True, "OUTPUT_DIR", d,
        "TEST.CHECKPOINT_FILE_PATH", pyth])
    model = serving_model(tcfg, SEED)
    torch.save({"model_state": model.state_dict()}, pyth)
    del model
    reset_counts()
    t0 = time.perf_counter()
    ref_meter = test(tcfg)
    ref_test_s = time.perf_counter() - t0
    ref_test_counts = read_counts()
    torch.save({"train_cfg": cfg, "test_cfg": tcfg,
                "state": {k: v.cpu() for k, v in state_dict.items()},
                "batch": ([t.cpu() for t in batch[0]], batch[1].cpu())},
               os.path.join(d, "job.pt"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wait_ranks(start_ranks("rank18", d, os.path.join(
        ROOT, "configs", "Kinetics", "SLOWFAST_DUALATTENTION_8x8_R50.yaml"),
        DIST_WORLD))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in range(DIST_WORLD)]
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL

    train_expect = {"fused_bottleneck": 0, "flash_attention": 4 * DIST_STEPS,
                    "flash_attention_backward":
                        4 * BACKWARD_LAUNCHES_PER_CALL * DIST_STEPS,
                    "int8_conv": 0}
    batches = -(-len(ref_meter.video_preds) * ref_meter.num_clips
                // DIST_WORLD // (tcfg.TEST.BATCH_SIZE // DIST_WORLD))
    test_expect = dict.fromkeys(KERNELS, 0)
    test_expect["fused_bottleneck"] = 26 * batches
    ref_means = ref_meter.video_preds / ref_meter.num_clips
    ref_c = centred_log(ref_means)
    scale = float(np.abs(ref_c).max())
    clips = batch[1].shape[0]
    step_s = max(statistics.mean(r["step_s"]) for r in ranks)
    worst = [0.0, 0.0]
    log("dist", f"(b) {DIST_WORLD} ranks over gloo on cuda:0 (--num_shards "
        f"{DIST_WORLD} --shard_id r --init_method tcp://127.0.0.1:<port>), "
        f"the job {ranks_s:.1f} s with each rank's start | {smi}")
    for r in ranks:
        means = r["video_preds"] / r["num_clips"]
        err = float(np.abs(centred_log(means) - ref_c).max())
        top1 = float((means.argmax(1) == ref_means.argmax(1)).mean())
        loss_err = max(abs(a - b) / max(1.0, abs(b))
                       for a, b in zip(r["losses"], ref_losses))
        coll = ", ".join(f"{k} {n}x {ms:.2f} ms" for k, (n, ms) in sorted(
            r["collectives"].items(), key=lambda kv: -kv[1][1])[:4])
        worst_f = max(e for _, e, _ in r["fwd"])
        worst_b = max(e for row in r["bwd"] for e, _ in row)
        log("dist", f"(b) rank {r['rank']}: the first step's {r['calls']} "
            f"K2 calls against chunked_attention on their inputs (N, error "
            f"of its own scale, scale) " + ", ".join(
                f"({n}, {e:.3e}, {m:.3e})" for n, e, m in r["fwd"])
            + f" (tol {ATTN_BF16_TOL}) | its K2-bwd calls against "
            f"attention_backward, dQ, dK, dV (error of its own scale, "
            f"scale): " + "; ".join(", ".join(
                f"({e:.3e}, {m:.3e})" for e, m in row) for row in r["bwd"])
            + f" (tol {ATTN_BWD_BF16_TOL})")
        gate_planted_faults(f"dist (b) rank {r['rank']}", *r["planted"])
        waits = r["waits"]
        log("dist", f"(b) rank {r['rank']}: a traced step {r['span_ms']:.1f} "
            f"ms, the card busy {r['busy'] * 100:.1f}% of it "
            f"({r['busy'] * r['span_ms']:.1f} ms); the host inside the "
            f"step's {len(waits)} synchronous all-reduces (BN statistics, "
            f"metrics; each waits for the card to drain, then exchanges) "
            f"{sum(waits) * 1e3:.1f} ms in all, median "
            f"{statistics.median(waits) * 1e3:.2f} ms, largest "
            f"{max(waits) * 1e3:.2f} ms; issuing the collectives (CPU ms "
            f"of their records) {coll or 'none recorded'}")
        log("dist", f"(b) rank {r['rank']}/{r['world']}: {DIST_STEPS} CMDA "
            f"steps of {clips // DIST_WORLD} clips: losses " + ", ".join(
                f"{x:.6f}" for x in r["losses"]) + " against one process's "
            + ", ".join(f"{x:.6f}" for x in ref_losses) + f" (worst rel "
            f"{loss_err:.3e}, tol {DIST_LOSS_TOL}); parameter crc "
            f"{r['crc']:#010x}; launches {r['counts']}; train peak memory "
            f"{r['train_peak'] / 2 ** 30:.2f} GiB | 30-view test "
            f"{r['test_s']:.1f} s, launches {r['test_counts']}, per-video "
            f"centred log mean probabilities vs one process max |d| "
            f"{err:.3e} of scale {scale:.3e} (tol "
            f"{TEST_LOGIT_TOL * scale:.3e}), top-1 agreement {top1:.3f}, "
            f"{r['stats']}, test peak memory "
            f"{r['test_peak'] / 2 ** 30:.2f} GiB")
        if r["counts"] != train_expect or r["test_counts"] != test_expect:
            raise AssertionError(f"dist (b) rank {r['rank']}: launches "
                                 f"{r['counts']} / {r['test_counts']}, "
                                 f"expected {train_expect} / {test_expect}")
        if (loss_err > DIST_LOSS_TOL or not worst_f <= ATTN_BF16_TOL
                or not worst_b <= ATTN_BWD_BF16_TOL
                or not err <= TEST_LOGIT_TOL * scale
                or r["calls"] != 4):
            raise AssertionError(
                f"dist (b) rank {r['rank']}: losses {loss_err}, attention "
                f"{worst_f} / {worst_b} ({r['calls']} calls), test {err} "
                f"of {scale}")
        worst[0], worst[1] = max(worst[0], worst_f), max(worst[1], worst_b)
    r0, r1 = ranks
    if (r0["losses"] != r1["losses"] or r0["crc"] != r1["crc"]
            or not np.array_equal(r0["video_preds"], r1["video_preds"])):
        raise AssertionError("dist (b): the ranks differ: losses "
                             f"{r0['losses']} / {r1['losses']}, crc "
                             f"{r0['crc']:#x} / {r1['crc']:#x}")
    log("dist", f"bf16 CMDA-R50 train clips/s on the global batch of "
        f"{clips}: 1 process {clips / statistics.mean(ref_times):.2f} (peak "
        f"{ref_peak / 2 ** 30:.2f} GiB; on one rank's "
        f"{clips // DIST_WORLD} clips {half_peak / 2 ** 30:.2f} GiB), "
        f"{DIST_WORLD} ranks on one card "
        f"{clips / step_s:.2f}; the 30-view test of 240 clips: 1 process "
        f"{ref_test_s:.1f} s ({ref_test_counts['fused_bottleneck']} K1 "
        f"launches), {DIST_WORLD} ranks "
        f"{max(r['test_s'] for r in ranks):.1f} s | {smi}")
    counts = dict.fromkeys(KERNELS, 0)
    for r in ranks:
        for key in KERNELS:
            counts[key] += r["counts"][key] + r["test_counts"][key]
    return counts, worst[0], worst[1]


def phase_distributed(smi):
    """Phase 18: CMDA-R50 (phase 7's model, attention calibrated) through
    DDP over NCCL at world size 1 (a), then two gloo ranks on the card (b).
    Returns the main paths' launches and the worst attention errors."""
    t0 = time.perf_counter()
    cfg = train_cfg("SlowFastDualAttention")
    model = train_model(cfg, SEED)
    calibrate_attention(cfg, model, SEED + 9, phase="dist")
    state_dict = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = train_batches(cfg, 1, TRAIN_CLIPS, SEED + 18)[0]
    counts = dict(phase_dist_nccl(cfg, state_dict, batch, smi))
    torch.cuda.empty_cache()
    ranks, worst_f, worst_b = phase_dist_ranks(cfg, state_dict, batch, smi)
    for key, value in ranks.items():
        counts[key] += value
    log("dist", f"phase 18 {time.perf_counter() - t0:.1f} s | {smi}")
    return counts, worst_f, worst_b



# ---------------------------------------------------------------------------
# phase 19: spatial model parallelism (TPU.SPATIAL_SHARD 2): two gloo ranks
# on cuda:0 split each frame's height (parallel/spatial.py)
SPACE_WORLD = 2
# a rank's clips: (a) and (c) serve CLIPS_PER_REQUEST clips a request at
# 256², (b) steps on the global batch of TRAIN_CLIPS clips at 224² (D = 1:
# each rank all the clips, its band of their rows)
SPACE_REQUESTS = 1


def space_dir():
    path = os.path.join(smoke_dir(), "space19")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


class AttentionCalls:
    """Every ``flash_attention`` call of the CMDA fusions while the block
    runs (ops/attention.py's name): (q, k, v, out); the launches stay on
    the wrapper's count."""

    def __enter__(self):
        from efficient_slowfast_tpu_torch.ops import attention

        self.mod, self.orig, self.calls = attention, attention.flash_attention, []

        def recorded(q, k, v):
            out = self.orig(q, k, v)
            self.calls.append((q, k, v, out))
            return out

        attention.flash_attention = recorded
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.orig

    def held(self):
        """[(N, M, error of its own scale, scale)] a call, against
        chunked_attention on its inputs."""
        from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
            chunked_attention

        with torch.no_grad():
            return [(q.shape[1], k.shape[1], relative_error(
                out, chunked_attention(q, k, v), GRADCAM_SCALE_FLOOR),
                out.float().abs().max().item())
                for q, k, v, out in self.calls]


class BottleneckCalls:
    """Every K1 call of the fused engine while the block runs
    (engine/inference.py's name): its arguments and output."""

    def __enter__(self):
        from efficient_slowfast_tpu_torch.engine import inference

        self.mod, self.orig, self.calls = (inference,
                                           inference.fused_bottleneck, [])

        def recorded(*args):
            out = self.orig(*args)
            self.calls.append((args, out))
            return out

        inference.fused_bottleneck = recorded
        return self

    def __exit__(self, *exc):
        self.mod.fused_bottleneck = self.orig

    def held(self):
        """[(slab height, error of the output's scale)] a call, against
        bottleneck_reference on its inputs."""
        from efficient_slowfast_tpu_torch.ops.kernels.fused_bottleneck import \
            bottleneck_reference

        with torch.no_grad():
            return [(args[0].shape[1], relative_error(
                out, bottleneck_reference(*args), 1.0))
                for args, out in self.calls]


def space_serve(cfg, model, x, device, record):
    """``make_forward`` of ``model`` on ``x`` inside ``record`` (counts
    set to 0 before and read after): (scores on the host, launches, ms a
    request after a warm-up, the peak memory)."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    fwd = make_forward(cfg, model, device)
    fwd(x)  # cuDNN's plans, K1's plans
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    with record:
        for _ in range(SPACE_REQUESTS):
            scores = fwd(x)
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3 / SPACE_REQUESTS
    return (scores.float().cpu(), read_counts(), ms,
            torch.cuda.max_memory_allocated(device))


def unsummed_gradients(_, bucket):
    """A DDP comm hook that plants a fault: each rank keeps its own part
    of the space group's gradient (not summed over the group), divided by
    the world as DDP's mean divides."""
    fut = torch.futures.Future()
    fut.set_result(bucket.buffer().div_(SPACE_WORLD))
    return fut


def rank19_job(cfg, device):
    """One rank of phase 19 (TPU.SPATIAL_SHARD 2, D = 1), in a process
    group that ``launch_job`` joined: (a) CMDA-R50 serving, each K2 call
    held against the plain version on its inputs; (b) one CMDA-R50 train
    step (each K2-bwd call held), then (d) its async ``.dcp`` save, which
    runs while (c) the fused SlowFast-R50 serves (each K1 call held), then
    the resume; one more step with the planted fault; results in the
    job's directory."""
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)
    from efficient_slowfast_tpu_torch.models import build_model
    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        chunked_attention
    from efficient_slowfast_tpu_torch.parallel import distributed
    from efficient_slowfast_tpu_torch.utils import checkpoint as cu

    job = torch.load(os.path.join(cfg.OUTPUT_DIR, "job.pt"),
                     weights_only=False)
    out = dict(rank=distributed.rank(), world=distributed.world_size(),
               space=(distributed.space_rank(), distributed.space_size(),
                      distributed.data_size()))

    def model_of(c, sd):
        m = build_model(c, device=device)
        m.load_state_dict(sd, strict=True)
        return m

    # (a) CMDA-R50 serving
    x = [t.to(device) for t in job["cmda_x"]]
    rec = AttentionCalls()
    scores, counts, ms, peak = space_serve(
        job["cmda_cfg"], model_of(job["cmda_cfg"], job["cmda"]), x, device,
        rec)
    out["cmda"] = dict(scores=scores, counts=counts, ms=ms, peak=peak,
                       held=rec.held(),
                       split=[c[0].shape[1] * distributed.space_size()
                              == c[1].shape[1] for c in rec.calls])
    del rec, x
    torch.cuda.empty_cache()

    # (b) one CMDA-R50 train step on the global batch (D = 1)
    tcfg = job["train_cfg"]
    batch = job["batch"]
    torch.cuda.reset_peak_memory_stats(device)
    brec = BackwardCalls()
    reset_counts()
    t0 = time.perf_counter()
    state, losses, _ = dist_train(tcfg, job["train"], batch, device, steps=1,
                                  record=brec)
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    out["train"] = dict(
        loss=losses[0], counts=counts, first_ms=step_ms,
        peak=torch.cuda.max_memory_allocated(device),
        params={k: v.detach().cpu().clone()
                for k, v in state.model.state_dict().items()},
        fwd=[(q.shape[1], k.shape[1], relative_error(
            o, chunked_attention(q, k, v), GRADCAM_SCALE_FLOOR))
            for q, k, v, o, _, _, _ in brec.calls],
        bwd=brec.held(GRADCAM_SCALE_FLOOR), calls=len(brec.calls))
    small = min(brec.calls, key=lambda c: c[0].shape[1])
    out["train"]["planted"] = (small[0].shape[1], planted_fault_errors(small))
    del brec, small

    # (d) the .dcp save of that state, from both ranks, in flight during (c)
    dcfg = tcfg.clone()
    dcfg.TPU.CHECKPOINT_BACKEND = "orbax"
    saved_model = {k: v.detach().cpu().clone()
                   for k, v in state.model.state_dict().items()}
    saved_opt = state.optimizer.state_dict()
    saved_opt = {i: {k: v.detach().cpu().clone() for k, v in s.items()}
                 for i, s in saved_opt["state"].items()}
    t0 = time.perf_counter()
    path = cu.save_checkpoint(cfg.OUTPUT_DIR, state, 0, dcfg)
    save_call_ms = (time.perf_counter() - t0) * 1e3
    # a second step, timed, while the save is written
    step = make_train_step(tcfg, state.model, state.optimizer)
    x = [t.to(device) for t in batch[0]]
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    step(state, x, batch[1].to(device), tcfg.SOLVER.WARMUP_START_LR,
         torch.Generator(device=device).manual_seed(SEED))
    torch.cuda.synchronize(device)
    out["train"]["step_ms"] = (time.perf_counter() - t0) * 1e3
    del state, step, x
    torch.cuda.empty_cache()

    # (c) the fused SlowFast-R50 on halo slabs
    x = [t.to(device) for t in job["sf_x"]]
    krec = BottleneckCalls()
    scores, counts, ms, peak = space_serve(
        job["sf_cfg"], model_of(job["sf_cfg"], job["sf"]), x, device, krec)
    out["slowfast"] = dict(scores=scores, counts=counts, ms=ms, peak=peak,
                           held=krec.held())
    del krec, x
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cu.wait_for_saves()
    wait_ms = (time.perf_counter() - t0) * 1e3
    torch.manual_seed(SEED)  # the ranks' fresh weights alike, for DDP
    fresh = create_train_state(tcfg, build_model(tcfg, device=device),
                               device)
    epoch = cu.load_checkpoint(path, fresh.model, fresh.optimizer, tcfg)
    model_equal = all(torch.equal(v.cpu(), saved_model[k]) for k, v in
                      fresh.model.state_dict().items())
    opt = fresh.optimizer.state_dict()["state"]
    opt_equal = opt.keys() == saved_opt.keys() and all(
        torch.equal(v.cpu(), saved_opt[i][k])
        for i, s in opt.items() for k, v in s.items())
    out["dcp"] = dict(path=path, files=sorted(os.listdir(path)), epoch=epoch,
                      model_equal=model_equal, opt_equal=opt_equal,
                      save_call_ms=save_call_ms, wait_ms=wait_ms)
    del fresh
    torch.cuda.empty_cache()

    # (b) in float32 (TF32 off), where the split's arithmetic is one
    # process's but for summation order: the parameters, and with the
    # planted fault (the space group's gradients left unsummed)
    fcfg = job["f32_cfg"]
    fbatch = ([t.float() for t in batch[0]], batch[1])
    for key, hook in (("f32", None), ("fault", unsummed_gradients)):
        state, losses, _ = dist_train(fcfg, job["train"], fbatch, device,
                                      steps=1, hook=hook)
        out[key] = dict(loss=losses[0], params={
            k: v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()})
        del state
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(cfg.OUTPUT_DIR,
                                 f"rank{distributed.rank()}.pt"))


def space_reference(cfg, model, x):
    """One process's scores of ``model`` on ``x``, its ms a request after a
    warm-up and its peak memory."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    fwd = make_forward(cfg, model)
    fwd(x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = fwd(x).float().cpu()
    ms = (time.perf_counter() - t0) * 1e3
    return scores, ms, torch.cuda.max_memory_allocated()


def phase_spatial(smi):
    """Phase 19: TPU.SPATIAL_SHARD 2 over two gloo ranks on cuda:0, started
    through the CLI's flags (rank19_job), each held against one process on
    the same clips. Returns the launches of the split paths and the worst
    K1, K2 and K2-bwd errors."""
    t_phase = time.perf_counter()
    d = space_dir()
    gen = torch.Generator().manual_seed(SEED + 19)
    # (a) CMDA-R50 serving as phase 5 serves it (attention calibrated)
    ccfg = cmda_cfg()
    model = serving_model(ccfg, SEED)
    calibrate_attention(ccfg, model, SEED + 6, phase="space")
    cmda_x = clips(ccfg, CLIPS_PER_REQUEST, gen, torch.bfloat16)
    cmda_ref, cmda_ms, cmda_peak = space_reference(ccfg, model, cmda_x)
    cmda_sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    # (b) one CMDA-R50 train step as phase 18 takes it
    tcfg = train_cfg("SlowFastDualAttention")
    model = train_model(tcfg, SEED)
    calibrate_attention(tcfg, model, SEED + 9, phase="space")
    train_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = train_batches(tcfg, 1, TRAIN_CLIPS, SEED + 18)[0]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, ref_losses, _ = dist_train(tcfg, train_sd, batch, "cuda", steps=1)
    train_peak = torch.cuda.max_memory_allocated()
    ref_params = {k: v.detach().cpu().clone()
                  for k, v in state.model.state_dict().items()}
    del state
    ref_step_ms = dist_train(tcfg, train_sd, batch, "cuda",
                             steps=2)[2][0] * 1e3
    fcfg = train_cfg("SlowFastDualAttention", dtype="float32")
    state, f32_losses, _ = dist_train(
        fcfg, train_sd, ([t.float() for t in batch[0]], batch[1]), "cuda",
        steps=1)
    f32_params = {k: v.detach().cpu().clone()
                  for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    # (c) the fused SlowFast-R50 as phase 4 serves it
    scfg = serving_cfg()
    model = serving_model(scfg, SEED)
    sf_x = clips(scfg, CLIPS_PER_REQUEST, gen, torch.bfloat16)
    sf_ref, sf_ms, sf_peak = space_reference(scfg, model, sf_x)
    sf_sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()

    def split(c):
        c = c.clone()
        c.TPU.SPATIAL_SHARD, c.DIST_BACKEND = SPACE_WORLD, "gloo"
        return c

    torch.save({"cmda_cfg": split(ccfg), "cmda": cmda_sd,
                "cmda_x": [t.cpu() for t in cmda_x],
                "train_cfg": split(tcfg), "f32_cfg": split(fcfg),
                "train": {k: v.cpu() for k, v in train_sd.items()},
                "batch": ([t.cpu() for t in batch[0]], batch[1].cpu()),
                "sf_cfg": split(scfg), "sf": sf_sd,
                "sf_x": [t.cpu() for t in sf_x]},
               os.path.join(d, "job.pt"))
    t0 = time.perf_counter()
    wait_ranks(start_ranks(
        "rank19", d, os.path.join(ROOT, "configs", "Kinetics",
                                  "SLOWFAST_DUALATTENTION_8x8_R50.yaml"),
        SPACE_WORLD, "TPU.SPATIAL_SHARD", str(SPACE_WORLD)))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in range(SPACE_WORLD)]

    from efficient_slowfast_tpu_torch.ops.kernels.flash_attention import \
        BACKWARD_LAUNCHES_PER_CALL

    none = dict.fromkeys(KERNELS, 0)
    expect = {"cmda": {**none, "flash_attention": 4 * SPACE_REQUESTS},
              "slowfast": {**none, "fused_bottleneck": 26 * SPACE_REQUESTS},
              "train": {**none, "flash_attention": 4,
                        "flash_attention_backward":
                            4 * BACKWARD_LAUNCHES_PER_CALL}}
    params = [k for k in train_sd if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    train_cpu = {k: v.cpu() for k, v in train_sd.items()}
    length = param_distance(ref_params, train_cpu, params)
    f32_length = param_distance(f32_params, train_cpu, params)
    # bf16's own distance from the float32 step, one process's
    r_bf16 = param_distance(ref_params, f32_params, params) / f32_length
    counts = dict.fromkeys(KERNELS, 0)
    worst = {"fused_bottleneck": 0.0, "flash_attention": 0.0,
             "flash_attention_backward": 0.0}
    log("space", f"{SPACE_WORLD} ranks over gloo on cuda:0 (--num_shards "
        f"{SPACE_WORLD} --shard_id r ... TPU.SPATIAL_SHARD {SPACE_WORLD}), "
        f"the job {ranks_s:.1f} s with each rank's start | {smi}")
    for r in ranks:
        tag = f"space rank {r['rank']}"
        a, b, c, dd = r["cmda"], r["train"], r["slowfast"], r["dcp"]
        a_err = float((a["scores"] - cmda_ref).abs().max())
        c_err = float((c["scores"] - sf_ref).abs().max())
        loss_err = abs(b["loss"] - ref_losses[0]) / max(1.0,
                                                       abs(ref_losses[0]))
        r_step = param_distance(b["params"], ref_params, params) / length
        r_step_f32 = param_distance(b["params"], f32_params,
                                    params) / f32_length
        r_f32 = param_distance(r["f32"]["params"], f32_params,
                               params) / f32_length
        r_fault = param_distance(r["fault"]["params"], f32_params,
                                 params) / f32_length
        f32_loss_err = abs(r["f32"]["loss"] - f32_losses[0]) / max(
            1.0, abs(f32_losses[0]))
        k2 = max(e for _, _, e, _ in a["held"])
        k2_train = max(e for _, _, e in b["fwd"])
        k2b = max(e for row in b["bwd"] for e, _ in row)
        k1 = max(e for _, e in c["held"])
        log("space", f"{tag} (space index, S, D) {r['space']}: (a) CMDA-R50 "
            f"{CLIPS_PER_REQUEST} clips at 256², bf16: {a['ms']:.1f} ms a "
            f"request (one process {cmda_ms:.1f}); its K2 calls (N queries, M keys, error of its own "
            f"scale, scale) " + ", ".join(
                f"({n}, {m}, {e:.3e}, {s:.3e})" for n, m, e, s in a["held"])
            + f" (tol {ATTN_BF16_TOL}), N·S = M {a['split']}; scores "
            f"vs one process max |d| {a_err:.3e} (tol {CMDA_BF16_ATOL}); "
            f"peak memory {a['peak'] / 2 ** 30:.2f} GiB against one "
            f"process's {cmda_peak / 2 ** 30:.2f} GiB; launches "
            f"{a['counts']}")
        log("space", f"{tag}: (b) one CMDA-R50 step of {TRAIN_CLIPS} clips "
            f"at 224² (each rank its band of every clip), {b['step_ms']:.1f}"
            f" ms a step after the first (one process {ref_step_ms:.1f}; the "
            f"first, with the holds' records, {b['first_ms']:.1f}): loss {b['loss']!r} vs one process's "
            f"{ref_losses[0]!r} (rel {loss_err:.3e}, tol {DIST_LOSS_TOL}); "
            f"parameters' distance from one process's step over the step's "
            f"length {r_step:.3e}; from the float32 step's {r_step_f32:.3e}"
            f" (one process's bf16 step {r_bf16:.3e}) | float32 (TF32 off): "
            f"loss "
            f"{r['f32']['loss']!r} vs {f32_losses[0]!r} (rel "
            f"{f32_loss_err:.3e}), parameters {r_f32:.3e} (bound "
            f"{DIST_DDP_BOUND}), with the space group's gradients left "
            f"unsummed {r_fault:.3e} | K2 forward "
            f"(N, M, error) " + ", ".join(
                f"({n}, {m}, {e:.3e})" for n, m, e in b["fwd"])
            + " | K2-bwd dQ, dK, dV (error of its own scale, scale): "
            + "; ".join(", ".join(f"({e:.3e}, {s:.3e})" for e, s in row)
                        for row in b["bwd"])
            + f" (tol {ATTN_BWD_BF16_TOL}); peak memory "
            f"{b['peak'] / 2 ** 30:.2f} GiB against one process's "
            f"{train_peak / 2 ** 30:.2f} GiB; launches {b['counts']}")
        gate_planted_faults(tag, *b["planted"])
        log("space", f"{tag}: (c) fused SlowFast-R50 {CLIPS_PER_REQUEST} "
            f"clips at 256², bf16: {c['ms']:.1f} ms a request (one "
            f"process {sf_ms:.1f}); its "
            f"{len(c['held'])} K1 calls on halo slabs (slab rows, error of "
            f"the output's scale) " + ", ".join(
                f"({h}, {e:.2e})" for h, e in c["held"]) + f" (tol "
            f"{BF16_TOL}); probabilities vs one process max |d| "
            f"{c_err:.3e} (tol {SERVE_BF16_ATOL}); peak memory "
            f"{c['peak'] / 2 ** 30:.2f} GiB against one process's "
            f"{sf_peak / 2 ** 30:.2f} GiB; launches {c['counts']}")
        log("space", f"{tag}: (d) {os.path.basename(dd['path'])} "
            f"{dd['files']}, the async save's call {dd['save_call_ms']:.1f} "
            f"ms, its wait after (c) {dd['wait_ms']:.1f} ms; resumed epoch "
            f"{dd['epoch']}, the model bit for bit {dd['model_equal']}, the "
            f"optimizer's moments {dd['opt_equal']}")
        for what in ("cmda", "train", "slowfast"):
            if r[what]["counts"] != expect[what]:
                raise AssertionError(f"{tag} {what}: launches "
                                     f"{r[what]['counts']}, expected "
                                     f"{expect[what]}")
        if (r["space"] != (r["rank"], SPACE_WORLD, 1) or len(a["held"]) != 4
                or not all(a["split"]) or a["held"][0][:2] != (16384, 32768)
                or not k2 <= ATTN_BF16_TOL or not k2_train <= ATTN_BF16_TOL
                or not k2b <= ATTN_BWD_BF16_TOL or not k1 <= BF16_TOL
                or len(c["held"]) != 26 or not a_err <= CMDA_BF16_ATOL
                or not c_err <= SERVE_BF16_ATOL
                or not loss_err <= DIST_LOSS_TOL
                or not f32_loss_err <= DIST_LOSS_TOL
                or not r_f32 <= DIST_DDP_BOUND):
            raise AssertionError(
                f"{tag}: K2 {k2} / {k2_train}, K2-bwd {k2b}, K1 {k1} "
                f"({len(c['held'])} calls), scores {a_err} / {c_err}, loss "
                f"{loss_err} / {f32_loss_err}, parameters {r_f32}, shapes "
                f"{a['held']}")
        if not r_fault > DIST_DDP_BOUND:
            raise AssertionError(f"{tag}: the gate passes the space group's "
                                 f"gradients unsummed: {r_fault}")
        if not (dd["model_equal"] and dd["opt_equal"] and dd["epoch"] == 0
                and ".metadata" in dd["files"]):
            raise AssertionError(f"{tag}: the .dcp resume {dd}")
        for what in ("cmda", "train", "slowfast"):
            for key in KERNELS:
                counts[key] += r[what]["counts"][key]
        worst["fused_bottleneck"] = max(worst["fused_bottleneck"], k1)
        worst["flash_attention"] = max(worst["flash_attention"], k2, k2_train)
        worst["flash_attention_backward"] = max(
            worst["flash_attention_backward"], k2b)
    if ranks[0]["train"]["loss"] != ranks[1]["train"]["loss"]:
        raise AssertionError("space: the ranks' losses differ")
    log("space", f"phase 19 {time.perf_counter() - t_phase:.1f} s | {smi}")
    return counts, worst


# ---------------------------------------------------------------------------
# phase 20: the entry points under TPU.SPATIAL_SHARD 2 (two gloo ranks on
# cuda:0): int8 serving with K3 on halo slabs, the serving export, Grad-CAM
# and the demo, each held against one process on the same inputs
ENTRY_WORLD = 2
# int8 under the split, by distance ratio (centred log probabilities, phase
# 15's measure): the split's int8 scores no farther from one process's bf16
# scores than ENTRY_INT8_RATIO x one process's own int8 scores are. Each
# split K3 call is bit-equal to the unsplit conv's rows and the group's
# ranges are the frame's, so the split's departures from one process's
# int8 are code flips where a bf16 op before a conv summed a slab in
# another order; each flip is one quantization step, of the kind whose sum
# is int8's own distance, so by the triangle inequality sound flips stay
# within 2. The planted fault (one rank's halo rows zeroed in one conv)
# must exceed it.
ENTRY_INT8_RATIO = 2.0
# ... and directly: the split's int8 scores within ENTRY_INT8_DIRECT_TOL
# (centred log probabilities, max |d|) of one process's int8 scores on the
# same inputs at the same ranges. Sound runs on an H100 read 1.33e-2 under
# INT8_EVAL (its bf16 3x3 convs run on slabs, where cuDNN may round
# otherwise and flip a code downstream) and 0 under +INT8_SPATIAL and in
# the int8 demo; the gate leaves 3.7x the largest reading, and the planted
# fault reads 0.368, 7x past it
ENTRY_INT8_DIRECT_TOL = 0.05
# the group's ranges against one process's: the activations are bf16, and
# a band's float ops may round them differently (2^-8 relative)
ENTRY_RANGE_TOL = 2.0 ** -8
# the planted fault's conv: s5's stride-2 1x3x3 (8-row bands at 256²)
ENTRY_FAULT_CONV = "s5.pathway0_res0.branch2.b"


def entry_dir():
    path = os.path.join(smoke_dir(), "entry20")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


class K3Calls:
    """Every int8 conv call while the block runs (ops/conv.py's name): its
    arguments and output; the launches stay on K3's count."""

    def __enter__(self):
        import efficient_slowfast_tpu_torch.ops.conv as conv_mod

        self.mod, self.orig, self.calls = conv_mod, conv_mod.int8_conv, []

        def recorded(*args):
            out = self.orig(*args)
            self.calls.append((args, out))
            return out

        conv_mod.int8_conv = recorded
        return self

    def __exit__(self, *exc):
        self.mod.int8_conv = self.orig

    def held(self):
        """[(slab height, output bit-equal to int8_conv_reference on its
        inputs)] a call."""
        from efficient_slowfast_tpu_torch.ops.kernels.int8_conv import \
            int8_conv_reference

        return [(args[0].shape[3], torch.equal(out, int8_conv_reference(
            *args))) for args, out in self.calls]


def traced_kernel_ms(name, patterns):
    """The device ms of the CUDA kernels whose names hold one of
    ``patterns`` inside the smoke_window span of trace_window's ``name``
    (each kernel's own interval, as CUPTI records it)."""
    from efficient_slowfast_tpu_torch.utils import profiler

    with open(os.path.join(smoke_dir(), f"profile_{name}",
                           profiler.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    span = next(e for e in events if e.get("name") == "smoke_window"
                and e.get("cat") == "user_annotation")
    w0, w1 = span["ts"], span["ts"] + span["dur"]
    return sum(min(e["ts"] + e["dur"], w1) - max(e["ts"], w0)
               for e in events if e.get("cat") == "kernel"
               and e["ts"] < w1 and e["ts"] + e["dur"] > w0
               and any(p in e["name"] for p in patterns)) / 1e3


class OwnRanges:
    """Each rank's own ranges before the group's maximum
    (engine/quantize.py::_job_ranges)."""

    def __enter__(self):
        from efficient_slowfast_tpu_torch.engine import quantize

        self.mod, self.orig, self.seen = quantize, quantize._job_ranges, []

        def recorded(convs):
            self.seen.append(torch.stack([m.act_max.detach().float().cpu()
                                          for m in convs]))
            self.orig(convs)

        quantize._job_ranges = recorded
        return self

    def __exit__(self, *exc):
        self.mod._job_ranges = self.orig


class PlantedHalo:
    """Rank 1's halo rows zeroed in the conv ``name`` of ``model``
    (parallel/spatial.py's halo, while that conv runs)."""

    def __init__(self, model, name):
        self.conv, self.active = model.get_submodule(name), []

    def __enter__(self):
        from efficient_slowfast_tpu_torch.parallel import distributed, spatial

        self.mod, self.orig = spatial, spatial.halo
        self.hooks = [
            self.conv.register_forward_pre_hook(
                lambda m, a: self.active.append(1)),
            self.conv.register_forward_hook(
                lambda m, a, y: self.active.clear())]

        def zeroed(x, above, below, fill=0.0):
            out = self.orig(x, above, below, fill)
            if self.active and distributed.space_rank() == 1 and above:
                out = out.clone()
                out[:, :, :, :above] = 0
            return out

        spatial.halo = zeroed
        return self

    def __exit__(self, *exc):
        self.mod.halo = self.orig
        for h in self.hooks:
            h.remove()


def int8_distance(out, ref):
    """max |d| of the centred log probabilities."""
    return (centred_logs(out) - centred_logs(ref)).abs().max().item()


def entry_int8(c, sd, x, device, name=None, fault=False):
    """The int8 model of ``c`` from ``sd``: calibrated on ``x`` (the
    group's step under the split), a request served with each K3 call
    recorded, where ``name`` one more traced as profile_``name`` (K3's
    kernels' device time); returns its line's numbers (and, where
    ``fault``, the scores with PlantedHalo) and the model."""
    from efficient_slowfast_tpu_torch.engine.quantize import calibrate_int8
    from efficient_slowfast_tpu_torch.engine.state import make_forward
    from efficient_slowfast_tpu_torch.models import build_model

    model = build_model(c, device=device)
    model.load_state_dict(sd, strict=True)
    with OwnRanges() as own:
        quant = calibrate_int8(model, [x])
    fwd = make_forward(c, model, device)
    fwd(x)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    with K3Calls() as rec:
        scores = fwd(x)
    counts = read_counts()
    held = rec.held()
    del rec
    k3_ms = None
    if name:
        trace_window(name, lambda: fwd(x))
        k3_ms = traced_kernel_ms(name, TRACE_KERNELS["K3"])
    ms = cuda_ms(lambda: fwd(x), iters=1, reps=3)
    out = dict(quant={k: float(v) for k, v in quant.items()},
               own=own.seen[0].tolist() if own.seen else None,
               scores=scores.float().cpu(), counts=counts, k3_ms=k3_ms,
               held=held, ms=ms, peak=torch.cuda.max_memory_allocated(device))
    if fault:
        with PlantedHalo(model, ENTRY_FAULT_CONV):
            out["fault"] = fwd(x).float().cpu()
    return out, model


def rank20_job(cfg, device):
    """One rank of phase 20 (TPU.SPATIAL_SHARD 2, D = 1), in a process
    group that ``launch_job`` joined: (a) int8 SlowFast-R50 under
    INT8_EVAL and +INT8_SPATIAL, (b) the export of the latter (the master
    writes it), (c) Grad-CAM of CMDA-R50, (d) the fused and int8 demos;
    results in the job's directory."""
    from efficient_slowfast_tpu_torch.engine.export import export_serving
    from efficient_slowfast_tpu_torch.models import build_model
    from efficient_slowfast_tpu_torch.parallel import distributed
    from efficient_slowfast_tpu_torch.visualization.video_cam import \
        gradcam_clip

    job = torch.load(os.path.join(cfg.OUTPUT_DIR, "job.pt"),
                     weights_only=False)
    out = dict(rank=distributed.rank(),
               space=(distributed.space_rank(), distributed.space_size(),
                      distributed.data_size()))
    smi = job["smi"]
    seconds, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        seconds[name] = now - t_part
        t_part = now

    # (a) int8 serving, then (b) the export of +INT8_SPATIAL's model
    x = [t.to(device) for t in job["x"]]
    for spatial_opt in (False, True):
        c = job["int8_cfg"][spatial_opt]
        out[spatial_opt], model = entry_int8(
            c, job["sd"], x, device,
            spatial_opt and f"entry20_k3_rank{distributed.rank()}",
            fault=spatial_opt)
        if spatial_opt:
            part("a")
            t0 = time.perf_counter()
            # on the CPU (the weight codes quantized there), moved to the
            # card at load: the ops dispatch on the tensors' device
            out["export"] = export_serving(
                c, model, os.path.join(cfg.OUTPUT_DIR, "split_int8"),
                device="cpu")
            out["export_s"] = time.perf_counter() - t0
        del model
        torch.cuda.empty_cache()
    del x
    part("b")

    # (c) Grad-CAM of CMDA-R50
    gcfg = job["gradcam_cfg"]
    gmodel = build_model(gcfg, device=device)
    gmodel.load_state_dict(job["gradcam"], strict=True)
    gmodel.eval()
    out["gradcam"] = {}
    worst = [0.0, 0.0]
    part("c build")
    for target, calls in GRADCAM_TARGETS:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        res, counts, rec, fwd_calls = gradcam_run(
            "entry", gcfg, gmodel, job["clip"], target, calls, smi)
        peak = torch.cuda.max_memory_allocated(device)
        part(f"c {target} run")
        wf, wb = hold_gradcam_calls(target, "bfloat16", rec, fwd_calls)
        worst = [max(worst[0], wf), max(worst[1], wb)]
        split = [c[0].shape[1] * ENTRY_WORLD == c[1].shape[1]
                 for c in fwd_calls]
        del rec, fwd_calls
        part(f"c {target} hold")
        call = functools.partial(gradcam_clip, gcfg, gmodel, job["clip"],
                                 target)
        ms = cuda_ms(call, iters=1, reps=2)
        part(f"c {target} time")
        out["gradcam"][target] = dict(
            scores=res["predictions"], cams=res["cams"], counts=counts,
            split=split, ms=ms, peak=peak)
    out["gradcam_worst"] = worst
    del gmodel
    torch.cuda.empty_cache()
    part("c")

    # (d) the demos: two injected one-clip windows each
    out["demo"] = {}
    for kind in ("fused", "int8"):
        dcfg = job["demo_cfg"][kind]
        krec = BottleneckCalls() if kind == "fused" else \
            contextlib.nullcontext()
        with krec:
            run = demo_run(dcfg, job["windows"])
        held = krec.held() if kind == "fused" else []
        out["demo"][kind] = dict(
            scores=[o.float().cpu() for _, o in
                    run["fwd"].calls[-DEMO_WINDOWS:]],
            windows=len(run["results"]), counts=run["counts"],
            shown=len(run["sink"].counts), held=held, peak=run["peak"],
            ms=window_ms(run["results"][1:] or run["results"],
                         dcfg.DATA.NUM_FRAMES))
        del run, krec
        torch.cuda.empty_cache()
    part("d")
    out["seconds"] = seconds
    torch.save(out, os.path.join(cfg.OUTPUT_DIR,
                                 f"rank{distributed.rank()}.pt"))


def entry_export(path, c, model, quant, x, smi):
    """(b) The split master's artifact at ``path`` (the one-device graph,
    traced from a model built without the split that holds the group's
    ranges) loaded onto the card and served at EXPORT_BATCHES against one
    process's live forward of ``model`` (``c``) at the group's ranges
    ``quant``: the same graph on the same inputs, bit for bit. Returns the
    launches inside."""
    from efficient_slowfast_tpu_torch.engine.export import load_serving
    from efficient_slowfast_tpu_torch.engine.quantize import load_quant_state
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    load_quant_state(model, {k: torch.tensor(v) for k, v in quant.items()})
    live = make_forward(c, model)
    t0 = time.perf_counter()
    art = load_serving(path, device="cuda")
    t_load = time.perf_counter() - t0
    nodes = str(art.program.graph).count("esf_torch.int8_conv.default")
    total = dict.fromkeys(KERNELS, 0)
    lines = []
    for b in EXPORT_BATCHES:
        xb = [t[:b] for t in x]
        want = live(xb).float().cpu().numpy()
        art(xb)  # warm-up
        reset_counts()
        got = art(xb)
        for k, v in read_counts().items():
            total[k] += v
        err = float(np.abs(got - want).max())
        lines.append(f"batch {b}: max |d| {err:.3e}")
        if err != 0.0 or got.shape != (b, c.MODEL.NUM_CLASSES):
            raise AssertionError(f"entry export batch {b}: {got.shape}, "
                                 f"max |d| {err} from one process's")
    log("entry", f"(b) +INT8_SPATIAL export written by the master under the "
        f"split on the CPU ({os.path.getsize(path) / 1e6:.1f} MB, {nodes} "
        f"K3 graph nodes), moved onto the card at load in {t_load:.1f} s, "
        f"against one process's live forward at the group's ranges: "
        + ", ".join(lines)
        + f" | launches inside {total} | {smi}")
    if nodes != 110 or total["int8_conv"] != 110 * len(EXPORT_BATCHES):
        raise AssertionError(f"entry export: nodes {nodes}, launches {total}")
    os.remove(path)
    return total


def phase_entry(smi):
    """Phase 20: the entry points under TPU.SPATIAL_SHARD 2 over two gloo
    ranks on cuda:0, started through the CLI's flags (rank20_job), each
    held against one process on the same inputs. Returns the launches of
    the split paths and the worst K1, K2, K2-bwd and K3 errors."""
    from efficient_slowfast_tpu_torch.data.build import build_dataset
    from efficient_slowfast_tpu_torch.engine.state import make_forward
    from efficient_slowfast_tpu_torch.visualization.video_cam import \
        gradcam_clip

    t_phase = time.perf_counter()
    d = entry_dir()
    gen = torch.Generator().manual_seed(SEED + 20)

    def split(c, out=None):
        c = c.clone()
        c.TPU.SPATIAL_SHARD, c.DIST_BACKEND = ENTRY_WORLD, "gloo"
        if out is not None:
            c.OUTPUT_DIR = out
        return c

    # (a) one process: bf16 and int8 SlowFast-R50 on one 4-clip request
    fcfg = serving_cfg_module()
    float_model = serving_model(fcfg, SEED)
    sd = {k: v.detach().cpu() for k, v in float_model.state_dict().items()}
    x = clips(fcfg, CLIPS_PER_REQUEST, gen, torch.bfloat16)
    bf16 = make_forward(fcfg, float_model)(x).float().cpu()
    del float_model
    one, int8_cfgs = {}, {}
    for spatial_opt in (False, True):
        int8_cfgs[spatial_opt] = int8_cfg(spatial_opt)
        one[spatial_opt], model = entry_int8(
            int8_cfgs[spatial_opt], sd, x, "cuda",
            spatial_opt and "entry20_k3_one")
        if spatial_opt:
            export_model = model
        else:
            del model
    torch.cuda.empty_cache()
    # (c) one process: Grad-CAM of CMDA-R50 in bf16 (kernels) and float32
    # (the plain attention, phase 16's reference)
    gcfg = gradcam_cfg()
    clip = np.ascontiguousarray(
        build_dataset(gcfg.TEST.DATASET, gcfg, "test")._fetch(1)[0])
    gmodel = serving_model(gcfg, SEED)
    calibrate_attention(gcfg, gmodel, SEED + 16, phase="entry")
    gstate = {k: v.detach().cpu() for k, v in gmodel.state_dict().items()}
    f32 = model_with(gradcam_cfg("float32", False), gstate)
    cam_one = {}
    for target, _ in GRADCAM_TARGETS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = gradcam_clip(gcfg, gmodel, clip, target)
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_ms(functools.partial(gradcam_clip, gcfg, gmodel, clip,
                                       target), iters=1, reps=2)
        cam_one[target] = dict(
            bf16=res, ms=ms, peak=peak,
            f32=gradcam_clip(gradcam_cfg("float32", False), f32, clip,
                             target))
    del gmodel, f32
    torch.cuda.empty_cache()
    # (d) one process: the fused and int8 demos of
    # demo/Kinetics/SLOWFAST_8x8_R50.yaml on the same windows
    demo_cfgs, demo_one = {}, {}
    sf_ckpt = None
    windows = None
    for kind, opts in (("fused", ["TPU.FUSED_EVAL", True]),
                       ("int8", ["TPU.INT8_EVAL", True])):
        dcfg = demo_cfg("Kinetics/SLOWFAST_8x8_R50.yaml", f"entry_{kind}",
                        *opts)
        if sf_ckpt is None:
            sf_ckpt = demo_checkpoint(dcfg, "entry")
            windows = demo_windows(DEMO_FRAME_HW, SEED + 200,
                                   dcfg.DATA.NUM_FRAMES)
        dcfg.TEST.CHECKPOINT_FILE_PATH = sf_ckpt
        run = demo_run(dcfg, windows)
        demo_one[kind] = dict(
            scores=[o.float().cpu() for _, o in
                    run["fwd"].calls[-DEMO_WINDOWS:]],
            ms=window_ms(run["results"][1:] or run["results"],
                         dcfg.DATA.NUM_FRAMES), peak=run["peak"])
        demo_cfgs[kind] = split(dcfg, os.path.join(d, f"demo_{kind}"))
        del run
        torch.cuda.empty_cache()

    t_refs = time.perf_counter() - t_phase
    torch.save({"smi": smi, "sd": sd, "x": [t.cpu() for t in x],
                "int8_cfg": {k: split(v) for k, v in int8_cfgs.items()},
                "gradcam_cfg": split(gcfg), "gradcam": gstate, "clip": clip,
                "demo_cfg": demo_cfgs, "windows": windows},
               os.path.join(d, "job.pt"))
    t0 = time.perf_counter()
    wait_ranks(start_ranks(
        "rank20", d, os.path.join(ROOT, "configs", "Kinetics",
                                  "SLOWFAST_8x8_R50.yaml"),
        ENTRY_WORLD, "TPU.SPATIAL_SHARD", str(ENTRY_WORLD)))
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
             for r in range(ENTRY_WORLD)]
    with open(os.path.join(d, "rank0.log")) as f:
        for line in f:
            if "Exported" in line or line.startswith("[gradcam]"):
                log("entry", f"rank 0 logged: {line.strip()[:600]}")
    log("entry", f"{ENTRY_WORLD} ranks over gloo on cuda:0 (--num_shards "
        f"{ENTRY_WORLD} --shard_id r ... TPU.SPATIAL_SHARD {ENTRY_WORLD}), "
        f"the job {ranks_s:.1f} s with each rank's start (rank 0's parts, s: "
        + ", ".join(f"({k}) {v:.1f}" for k, v in ranks[0]["seconds"].items())
        + f"); one process's references before it {t_refs:.1f} s | {smi}")

    none = dict.fromkeys(KERNELS, 0)
    counts = dict.fromkeys(KERNELS, 0)
    worst = dict.fromkeys(KERNELS, 0.0)

    def add(c):
        for key in KERNELS:
            counts[key] += c[key]

    # (a) the ranges, each K3 call on its slab, the scores by the ratio
    for spatial_opt, convs in ((False, 47), (True, 110)):
        what = "+INT8_SPATIAL" if spatial_opt else "INT8_EVAL"
        ref = one[spatial_opt]
        own = np.maximum(*[np.asarray(r[spatial_opt]["own"]) for r in ranks])
        group = ranks[0][spatial_opt]["quant"]
        names = list(group)
        ones = np.asarray([ref["quant"][k] for k in names])
        rel = float(np.max(np.abs(np.asarray(list(group.values())) - ones)
                           / ones))
        own_dist = int8_distance(ref["scores"], bf16)
        group_is_max = np.array_equal(own, np.asarray(list(group.values()),
                                                      np.float32))
        for r in ranks:
            a = r[spatial_opt]
            tag = f"entry rank {r['rank']} {what}"
            dist = int8_distance(a["scores"], bf16)
            direct = int8_distance(a["scores"], ref["scores"])
            equal = sum(eq for _, eq in a["held"])
            heights = sorted({h for h, _ in a["held"]})
            log("entry", f"{tag}: (a) {len(a['held'])} K3 calls on slabs "
                f"({len(heights)} slab heights, {heights[0]}-{heights[-1]} "
                f"rows), {equal} bit-equal to int8_conv_reference on their "
                f"inputs | group ranges vs one process's max rel "
                f"{rel:.3e} (tol {ENTRY_RANGE_TOL:.3e}), the max of the "
                f"ranks' own {group_is_max} "
                f"| centred log probabilities vs one process's bf16 max |d| "
                f"{dist:.4f}, one process's int8 {own_dist:.4f} (ratio "
                f"{dist / own_dist:.3f}, gate {ENTRY_INT8_RATIO}); vs one "
                f"process's int8 max |d| {direct:.4e} (tol "
                f"{ENTRY_INT8_DIRECT_TOL}) | "
                f"{a['ms']:.1f} ms a request (one process {ref['ms']:.1f}); "
                + (f"K3's kernels {a['k3_ms']:.3f} device ms in a traced "
                   f"request on its slabs, the other rank's sharing the "
                   f"card (one process {ref['k3_ms']:.3f}); "
                   if spatial_opt else "") + f"peak memory "
                f"{a['peak'] / 2 ** 30:.2f} GiB (one process "
                f"{ref['peak'] / 2 ** 30:.2f}) | launches {a['counts']} | "
                f"{smi}")
            if (a["counts"] != {**none, "int8_conv": convs}
                    or equal != convs or a["quant"] != group
                    or not group_is_max or rel > ENTRY_RANGE_TOL
                    or dist > ENTRY_INT8_RATIO * own_dist
                    or direct > ENTRY_INT8_DIRECT_TOL):
                raise AssertionError(f"{tag}: launches {a['counts']}, "
                                     f"{equal} of {convs} bit-equal, ranges "
                                     f"{rel}, ratio {dist / own_dist}, "
                                     f"direct {direct}")
            if spatial_opt:
                fault = int8_distance(a["fault"], bf16)
                fault_direct = int8_distance(a["fault"], ref["scores"])
                log("entry", f"{tag}: planted fault (rank 1's halo rows "
                    f"zeroed in {ENTRY_FAULT_CONV}): ratio "
                    f"{fault / own_dist:.3f} (must exceed "
                    f"{ENTRY_INT8_RATIO}), vs one process's int8 "
                    f"{fault_direct:.4e} (must exceed "
                    f"{ENTRY_INT8_DIRECT_TOL})")
                if not (fault > ENTRY_INT8_RATIO * own_dist
                        and fault_direct > ENTRY_INT8_DIRECT_TOL):
                    raise AssertionError(f"{tag}: a gate passes the planted "
                                         f"fault ({fault}, {fault_direct})")
            check_scores(a["scores"], CLIPS_PER_REQUEST, 400, tag)
            add(a["counts"])
        if ranks[0][spatial_opt]["own"] == ranks[1][spatial_opt]["own"]:
            raise AssertionError(f"entry {what}: the ranks' own ranges are "
                                 "equal: no band saw less than the frame")
    worst["int8_conv"] = 0.0  # bit for bit

    # (b) the export
    if not (ranks[0]["export"] == ranks[1]["export"]
            and os.path.exists(ranks[0]["export"])):
        raise AssertionError(f"entry export: {ranks[0]['export']}, "
                             f"{ranks[1]['export']}")
    log("entry", f"(b) the master's export under the split took "
        f"{ranks[0]['export_s']:.1f} s, the other rank waited "
        f"{ranks[1]['export_s']:.1f} s at the barrier")
    add(entry_export(ranks[0]["export"], int8_cfgs[True], export_model,
                     ranks[0][True]["quant"], x, smi))
    del export_model
    torch.cuda.empty_cache()

    # (c) Grad-CAM against one process's
    for target, calls in GRADCAM_TARGETS:
        o = cam_one[target]
        e_one = cam_distance(o["bf16"], o["f32"])
        for r in ranks:
            g = r["gradcam"][target]
            tag = f"entry rank {r['rank']} Grad-CAM {target}"
            res = {"cams": g["cams"]}
            e_split = cam_distance(res, o["f32"])
            err = float(np.abs(g["scores"] - o["bf16"]["predictions"]).max())
            log("entry", f"{tag}: (c) scores vs one process's max |d| "
                f"{err:.3e} (tol {CMDA_BF16_ATOL}); CAMs' L2 distance from "
                f"one process's float32 plain path's {e_split:.4e}, one "
                f"process's bf16 {e_one:.4e} (ratio "
                f"{e_split / max(e_one, 1e-30):.3f}, gate "
                f"{CMDA_TRAIN_BF16_RATIO}); K2 queries a band's "
                f"{all(g['split'])} | {g['ms']:.1f} ms a call (one process "
                f"{o['ms']:.1f}); peak memory {g['peak'] / 2 ** 30:.2f} GiB "
                f"(one process {o['peak'] / 2 ** 30:.2f}) | launches "
                f"{g['counts']} | {smi}")
            if (err > CMDA_BF16_ATOL or e_split > CMDA_TRAIN_BF16_RATIO * e_one
                    or not all(g["split"]) or [c.shape for c in g["cams"]]
                    != [c.shape for c in o["bf16"]["cams"]]):
                raise AssertionError(f"{tag}: scores {err}, CAMs {e_split} "
                                     f"against {e_one}")
            add(g["counts"])
    for r in ranks:
        worst["flash_attention"] = max(worst["flash_attention"],
                                       r["gradcam_worst"][0])
        worst["flash_attention_backward"] = max(
            worst["flash_attention_backward"], r["gradcam_worst"][1])

    # (d) the demos against one process's windows
    for r in ranks:
        for kind, key, per in (("fused", "fused_bottleneck", 26),
                               ("int8", "int8_conv", 47)):
            g, o = r["demo"][kind], demo_one[kind]
            tag = f"entry rank {r['rank']} demo {kind}"
            want = per * (DEMO_WINDOWS + (kind == "fused"))
            shown = DEMO_WINDOWS if r["rank"] == 0 else 0
            if kind == "fused":
                err = max(float((a - b).abs().max())
                          for a, b in zip(g["scores"], o["scores"]))
                held = max(e for _, e in g["held"])
                worst["fused_bottleneck"] = max(worst["fused_bottleneck"],
                                                held)
                ok = err <= SERVE_BF16_ATOL and held <= BF16_TOL and len(
                    g["held"]) == want
                line = (f"probabilities vs one process's max |d| {err:.3e} "
                        f"(tol {SERVE_BF16_ATOL}); its {len(g['held'])} K1 "
                        f"calls on halo slabs vs bottleneck_reference worst "
                        f"{held:.2e} (tol {BF16_TOL})")
            else:
                dist = max(int8_distance(a, f) for a, f in zip(
                    g["scores"], demo_one["fused"]["scores"]))
                own_d = max(int8_distance(a, f) for a, f in zip(
                    o["scores"], demo_one["fused"]["scores"]))
                direct = max(int8_distance(a, b) for a, b in zip(
                    g["scores"], o["scores"]))
                ok = (dist <= ENTRY_INT8_RATIO * own_d
                      and direct <= ENTRY_INT8_DIRECT_TOL)
                line = (f"centred log probabilities vs one process's fused "
                        f"windows max |d| {dist:.4f}, one process's int8 "
                        f"{own_d:.4f} (ratio {dist / own_d:.3f}, gate "
                        f"{ENTRY_INT8_RATIO}); vs one process's int8 "
                        f"windows {direct:.4e} (tol {ENTRY_INT8_DIRECT_TOL});"
                        " calibrated on the first window over the group")
            log("entry", f"{tag}: (d) {g['windows']} windows, {line} | "
                f"{g['ms']:.1f} ms a window (one process {o['ms']:.1f}); "
                f"shown {g['shown']} | peak memory {g['peak']:.2f} GiB (one "
                f"process {o['peak']:.2f}) | launches {g['counts']} | {smi}")
            if (not ok or g["windows"] != DEMO_WINDOWS or g["shown"] != shown
                    or g["counts"] != {**none, key: want}):
                raise AssertionError(f"{tag}: {line}, shown {g['shown']}, "
                                     f"launches {g['counts']}")
            add(g["counts"])
    log("entry", f"phase 20 {time.perf_counter() - t_phase:.1f} s | {smi}")
    return counts, worst


def trace_window(name, fn, top_n=5):
    """``fn()`` under utils/profiler.py's trace, in a span that ends after
    a synchronize; returns (device-busy share of the span: the union of
    the CUDA kernels' intervals over its wall time, the span in ms, the
    top ``top_n`` kernels by device time [(name, ms, calls)], kernels)."""
    from efficient_slowfast_tpu_torch.utils import profiler

    log_dir = os.path.join(smoke_dir(), f"profile_{name}")
    torch.cuda.synchronize()
    with profiler.trace(log_dir):
        with profiler.annotate("smoke_window"):
            fn()
            torch.cuda.synchronize()
    return window_profile(name, top_n)


def window_profile(name, top_n=5):
    """trace_window's reading of the trace of build/smoke/profile_``name``
    (its one smoke_window span)."""
    from efficient_slowfast_tpu_torch.utils import profiler

    log_dir = os.path.join(smoke_dir(), f"profile_{name}")
    with open(os.path.join(log_dir, profiler.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("name") == "smoke_window"
            and e.get("cat") == "user_annotation"]
    if len(span) != 1:
        raise AssertionError(f"profile {name}: {len(span)} window spans")
    w0 = span[0]["ts"]
    w1 = w0 + span[0]["dur"]
    kernels = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1), e)
               for e in events if e.get("cat") == "kernel"]
    kernels = [k for k in kernels if k[1] > k[0]]
    if not kernels:
        raise AssertionError(f"profile {name}: the trace holds no CUDA kernel")
    busy, end = 0.0, w0
    for a, b, _ in sorted(kernels, key=lambda k: k[0]):
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for a, b, e in kernels:
        total, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (total + (b - a), calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top_n]
    share = busy / (w1 - w0)
    first = {}  # each top kernel's first launch: the aten op and its inputs
    for _, _, e in sorted(kernels, key=lambda k: k[0]):
        if e["name"] in dict(top) and e["name"] not in first:
            first[e["name"]] = launching_op(events, e)
    log("profile", f"{name}: device busy {share * 100:.1f}% of the "
        f"{(w1 - w0) / 1e3:.2f} ms window (union of {len(kernels)} CUDA "
        f"kernel intervals; torch.profiler, CUPTI tracing on) | trace "
        f"{os.path.relpath(log_dir, ROOT)}/{profiler.TRACE_FILE}")
    for kname, (total, calls) in top:
        log("profile", f"{name}: top kernel {total / 1e3:.3f} ms "
            f"({total / (w1 - w0) * 100:.1f}% of the window, {calls} calls)"
            f": {kname[:140]} | first launched by {first[kname]}")
    return share, (w1 - w0) / 1e3, top, len(kernels)


def launching_op(events, kernel):
    """The innermost host op around the runtime call that launched
    ``kernel`` (matched by correlation id), with its input shapes and
    dtypes as the trace records them."""
    corr = kernel.get("args", {}).get("correlation")
    launch = next((e for e in events if e.get("cat") == "cuda_runtime"
                   and e.get("args", {}).get("correlation") == corr), None)
    if launch is None:
        return "no launch found"
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("tid") == launch.get("tid")
           and e["ts"] <= launch["ts"] <= e["ts"] + e["dur"]]
    if not ops:
        return "no host op"
    op = min(ops, key=lambda e: e["dur"])
    args = op.get("args", {})
    return (f"{op['name']} {args.get('Input Dims')} "
            f"{args.get('Input type')}")


def per_request(record, key):
    return sum(r[key] * r["count"] for r in record)


def kernel_entry(name, source, replaces, launches, err, record):
    """One kernel's JSON entry: per-request sums over its main-path rows
    (``library_ms`` null where a row has no library time)."""
    path = [r for r in record if r["count"]]
    ops_share = sum(r["bound_ms"] * r["count"] for r in path
                    if r["bound_by"] == "operations") / per_request(
                        path, "bound_ms")
    library = (None if any(r["library_ms"] is None for r in path)
               else per_request(path, "library_ms"))
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=err, ms=per_request(path, "ms"),
        plain_ms=per_request(path, "plain_ms"),
        bound_ms=per_request(path, "bound_ms"),
        bound_by="operations" if ops_share >= 0.5 else "bytes",
        library_ms=library)


# the phases that run together: a block runs whole when any of its phases
# is chosen (each takes what the one before it made); 1 and 2 always run
PHASE_BLOCKS = [("3", "4"), ("3b", "5"), ("3c", "6", "7"), ("8",), ("9",),
                ("10",), ("11",), ("12",), ("13",), ("14",), ("15",),
                ("16",), ("17",), ("18",), ("19",), ("20",)]
KERNELS = {
    "fused_bottleneck": (
        "efficient_slowfast_tpu_torch/csrc/fused_bottleneck.cu",
        "efficient_slowfast_tpu/ops/pallas/fused_bottleneck.py:200"),
    "flash_attention": (
        "efficient_slowfast_tpu_torch/csrc/flash_attention.cu",
        "efficient_slowfast_tpu/ops/pallas/flash_attention.py:112"),
    "flash_attention_backward": (
        "efficient_slowfast_tpu_torch/csrc/flash_attention_bwd.cu",
        "efficient_slowfast_tpu/ops/pallas/flash_attention.py:219"),
    "int8_conv": (
        "efficient_slowfast_tpu_torch/csrc/int8_conv.cu",
        "efficient_slowfast_tpu/ops/conv.py:243")}


def chosen_phases(argv):
    """The phases of ``--phases`` (a comma-separated list, e.g. 1,2,13),
    each with the rest of its block (PHASE_BLOCKS), and 3b and 3c with
    10, whose shapes they hold; None (every phase) without it."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--phases", help="comma-separated phases to run "
                        "(1 and 2 always run), e.g. 1,2,13")
    phases = parser.parse_args(argv).phases
    if phases is None:
        return None
    want = {p.strip() for p in phases.split(",") if p.strip()}
    known = {"1", "2"}.union(*PHASE_BLOCKS)
    if want - known:
        parser.error(f"unknown phases {sorted(want - known)}; known: "
                     f"{sorted(known)}")
    if "10" in want:
        want |= {"3b", "3c"}
    for block in PHASE_BLOCKS:
        if want & set(block):
            want |= set(block)
    return want


RANK_JOBS = {"rank18": rank18_job, "rank19": rank19_job,
             "rank20": rank20_job}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] and argv[0] in RANK_JOBS:  # a rank of phase 18, 19 or 20
        return rank_main(RANK_JOBS[argv[0]], argv[1:])
    want = chosen_phases(argv)
    run = lambda *block: want is None or bool(want & set(block))  # noqa: E731
    start = time.time()
    smi = phase_device()
    phase_build()
    log("time", f"phases 1, 2 done {time.time() - start:.1f} s after the start")
    launches = dict.fromkeys(KERNELS, 0)  # on the main paths
    records, errs = {}, {k: [] for k in KERNELS}

    def stamp(*block):
        if run(*block):
            log("time", f"phases {', '.join(block)} done "
                f"{time.time() - start:.1f} s after the start")

    def add(counts):
        for key, value in counts.items():
            launches[key] += value

    if run("3", "4"):
        cfg = serving_cfg()
        model = serving_model(cfg, SEED)
        k1_record, k1_err = phase_kernels(cfg, model, smi)
        records["fused_bottleneck"] = k1_record
        errs["fused_bottleneck"].append(k1_err)
        launches["fused_bottleneck"] += phase_serving(
            cfg, model, per_request(k1_record, "ms"), smi)
        del model
        torch.cuda.empty_cache()
        phase_serving_f32(smi)
        torch.cuda.empty_cache()

    recipe_fwd = recipe_bwd = None
    held_fwd = held_bwd = None
    stamp("3", "4")
    if run("3b", "5"):
        cfg = cmda_cfg()
        model = serving_model(cfg, SEED)
        recipe_fwd, recipe_bwd = recipe_attention_rows(model)
        k2_record, k2_err, held_fwd = phase_attention(
            attention_rows(cfg, model), smi, recipe_fwd)
        records["flash_attention"] = k2_record
        errs["flash_attention"].append(k2_err)
        calibrate_attention(cfg, model, SEED + 6)
        launches["flash_attention"] += phase_cmda(cfg, model, smi)
        state = model.state_dict()
        del model
        torch.cuda.empty_cache()
        phase_cmda_f32(state, smi)
        del state
        torch.cuda.empty_cache()

    step_clips_per_s = float("nan")
    stamp("3b", "5")
    if run("3c", "6", "7"):
        cfg = train_cfg("SlowFastDualAttention")
        model = train_model(cfg, SEED)
        if recipe_bwd is None:
            recipe_bwd = recipe_attention_rows(model)[1]
        bwd_record, bwd_err, held_bwd = phase_attention_backward(
            attention_rows(cfg, model), smi, recipe_bwd)
        records["flash_attention_backward"] = bwd_record
        errs["flash_attention_backward"].append(bwd_err)
        phase_train(smi)
        torch.cuda.empty_cache()
        calibrate_attention(cfg, model, SEED + 9)
        train_counts, step_clips_per_s = phase_cmda_train(cfg, model, smi)
        add(train_counts)
        del model
        torch.cuda.empty_cache()

    stamp("3c", "6", "7")
    if run("8"):
        none = dict.fromkeys(KERNELS, 0)
        sf_counts, sf_means, cfg, model = phase_thirty_view(
            "SLOWFAST_8x8_R50.yaml", True, {**none, "fused_bottleneck": 26},
            smi)
        phase_thirty_view_reference(cfg, model, sf_means,
                                    ["TPU.FUSED_EVAL", False], "fused engine",
                                    smi)
        del model
        torch.cuda.empty_cache()
        cmda_counts, cmda_means, cfg, model = phase_thirty_view(
            "SLOWFAST_DUALATTENTION_8x8_R50.yaml", False,
            {**none, "flash_attention": 4}, smi)
        phase_thirty_view_reference(cfg, model, cmda_means,
                                    ["TPU.FLASH_ATTENTION", False],
                                    "flash attention", smi)
        add(sf_counts)
        add(cmda_counts)
        del model
        torch.cuda.empty_cache()
    stamp("8")
    if run("9"):
        add(phase_epochs(step_clips_per_s, smi))
        torch.cuda.empty_cache()
    stamp("9")
    if run("10"):
        add(phase_recipe(held_fwd, held_bwd, smi))
        torch.cuda.empty_cache()
        recipe_split_bn_cost(smi)
    stamp("10")
    if run("11"):
        nln_fwd_err, nln_bwd_err, _ = phase_nonlocal_kernels(smi)
        errs["flash_attention"].append(nln_fwd_err)
        errs["flash_attention_backward"].append(nln_bwd_err)
        torch.cuda.empty_cache()
        add(phase_nonlocal(smi))
        torch.cuda.empty_cache()
    stamp("11")
    if run("12"):
        _, eff_fwd_err, eff_bwd_err = phase_efficient_kernels(smi)
        errs["flash_attention"].append(eff_fwd_err)
        errs["flash_attention_backward"].append(eff_bwd_err)
        add(phase_efficient(smi))
        torch.cuda.empty_cache()
    stamp("12")
    if run("13"):
        det_k2, det_k2_err, det_bwd, det_bwd_err, det_counts = \
            phase_detection(smi)
        # the times stay the serving and training paths' of 3b and 3c;
        # phase 13's own rows stand in where those did not run
        records.setdefault("flash_attention", det_k2)
        records.setdefault("flash_attention_backward", det_bwd)
        errs["flash_attention"].append(det_k2_err)
        errs["flash_attention_backward"].append(det_bwd_err)
        add(det_counts)
        torch.cuda.empty_cache()
    stamp("13")
    if run("14"):
        frame_records, frame_errs, frame_counts = phase_frames(smi)
        # phase 14's rows stand in where 3, 3b or 3c did not run
        for name, record in frame_records.items():
            records.setdefault(name, record)
            errs[name].append(frame_errs[name])
        add(frame_counts)
        torch.cuda.empty_cache()
    stamp("14")
    if run("15"):
        k3_record, k3_err, int8_counts = phase_int8(smi)
        records["int8_conv"] = k3_record
        errs["int8_conv"].append(k3_err)
        add(int8_counts)
        torch.cuda.empty_cache()
    stamp("15")
    if run("16"):
        gradcam_counts, gradcam_fwd_err, gradcam_bwd_err = phase_gradcam(smi)
        errs["flash_attention"].append(gradcam_fwd_err)
        errs["flash_attention_backward"].append(gradcam_bwd_err)
        add(gradcam_counts)
        torch.cuda.empty_cache()

    stamp("16")
    if run("17"):
        demo_counts, demo_k2_err = phase_demo(smi)
        errs["flash_attention"].append(demo_k2_err)
        add(demo_counts)
        torch.cuda.empty_cache()
    stamp("17")
    if run("18"):
        dist_counts, dist_fwd_err, dist_bwd_err = phase_distributed(smi)
        errs["flash_attention"].append(dist_fwd_err)
        errs["flash_attention_backward"].append(dist_bwd_err)
        add(dist_counts)
        torch.cuda.empty_cache()
    stamp("18")
    if run("19"):
        space_counts, space_worst = phase_spatial(smi)
        for name, err in space_worst.items():
            errs[name].append(err)
        add(space_counts)
        torch.cuda.empty_cache()
    stamp("19")
    if run("20"):
        entry_counts, entry_worst = phase_entry(smi)
        for name, err in entry_worst.items():
            errs[name].append(err)
        add(entry_counts)
        torch.cuda.empty_cache()
    stamp("20")

    # launches on the main paths of the phases run: serving (4, 5), CMDA
    # training (7), the 30-view tests (8), the epochs (9), the recipe (10),
    # the non-local networks (11), the efficient families (12), AVA
    # detection (13), the frame datasets (14), int8 serving (15),
    # Grad-CAM (16), the demo (17), distribution (18), the split height
    # (19) and the entry points under it (20); times per request of the
    # serving paths (3, 3b) and per CMDA train step (3c)
    kernels = [kernel_entry(name, *KERNELS[name], launches[name],
                            max(errs[name]), records[name])
               for name in KERNELS if name in records]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
