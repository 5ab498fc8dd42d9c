"""On-card smoke test of the PyTorch port (eilev_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times DIR   # A/B timing only, of the tree at DIR

Phases, each of which must pass (any failure exits non-zero, without the
final result line):

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from eilev_tpu_torch/csrc with nvcc, one process per source (five),
   all started together, beside one more nvcc of fused_mlp.cu whose
   -Xptxas -v report (each K6 kernel's registers and spills) is printed.
   Phases 2c-2e, which need only the decode, flash and fp32 attention
   libraries, run while the others still build; phase 2 runs after.
2. Check each kernel against its plain PyTorch twin in bf16 at the shapes of
   its path: K1 (packed ViT attention) at (136, 257, 3*1408), 16 heads x 88;
   K1 also past its whole-row limit, at S = 385, 577 (a 336^2 ViT) and 1,025
   (the two-pass body with no causal frontier);
   K2 (packed causal OPT prefill attention) at (4, 766, 3*2560), 32 heads x
   80, with all-ones and right-padded masks; K3 (decode attention, bf16
   stacked cache) at (L=32, B=4, S=798, 32x80), layer 17, with a full and a
   mid-decode mask (slots >= 780 unfilled), and at a GQA shape (32 heads over
   8 kv heads x 128, S=2048, score-side scale); K4 (decode attention, int8
   cache + bf16 scales) at the flagship shape against dequantize_kv + the
   twin, with a fully masked row (NaN in kernel and twin), at B=1 with S=1
   and S=5 (fewer slots than a cluster's chunks); K3 and K4 also at the
   narration's batch 1 (K4: a cluster of 8) and at the text LM's decode
   shape (32 layers, B=1, 2,048 slots with 2,016 filled, 32 x 128,
   score-side scale); K3 on the body its written rule (k3_split) picks at
   each of the three shapes, printed, with a fully masked row (NaN in both);
   K5 (flash attention) at (a) the LLaMA prefill,
   B=1 and 4, 1,984 queries into a 2,048-slot cache, 32 x 128, causal,
   score-side scale, the cache mask (empty tail; at B=4 rows left-padded to
   1,984/1,900/1,800/1,700 real tokens, whose padded rows must be exactly
   0), (b) the T5 form (hd 64, an fp32 (H, S, L) bias, padding mask, no
   scale) and (b') the same with the bias in bf16 padded rows, (c) the
   Q-Former cross shape (32 queries over 2,056 keys, 12 x 64, padded keys),
   (d) hd 88 at S=L=257 with no mask, (e) a q-side scale, hd 80, q_offset >
   0, (f) B=2, 300 queries into 320 slots, 32 x 128, causal, row 0
   left-padded by 150 (a wholly masked key tile; its padded rows exactly 0),
   (g) one query over 766 keys, 32 heads over 8 x 128, an fp32 bias, a row
   with no kept key (exactly 0); each call's body by counter (k5_counted):
   (a), (b'), (c) and (f) K5's Hopper body (launches_sm90), (b), (d) and (e)
   its mma.sync body, (g) its decode body (launches_decode); K6 (LayerNorm -> MLP)
   at the ViT MLP shape (136, 257, 1408 -> 6144), activations of unit scale
   from their own generator (K6_SEED).
   Tolerance atol = rtol = 2e-2 for K1-K3, K5 and K6 (one bf16 ulp of a
   rounded score, probability or activation moves an output by under 1%);
   3e-2 for K4 at the narration's batch 4 (the JAX int8 kernel test's bar)
   and 2e-3 for its other checks (K4_TIGHT_TOL: set from their measured
   maxima). K1 and K2 at long S on the bf16 two-pass body: K2 at (1, 4,096,
   32x80), causal, row 0 left-padded by 100 keys, and K1 at (1, 3,072,
   16x88), against their twins at 2e-2 with the fully masked rows NaN in
   both, timed beside SDPA with the same mask and the bound, printed on a
   JSON line of their own with their launches_sm90, which come from this
   check only (no path reaches S > 2,048). Every bf16 K1 and K2 launch of
   the script must be counted in its wrapper's launches_sm90 (the Hopper
   bodies, wgmma + TMA): counters() checks it on every counted run.
2b. The fp32 bodies (an fp32 model) against their twins, TF32 off, atol =
   rtol = 1e-4 (F32_TOL): K1 at (2, 257, 16x88) and at the fp32 ViT's
   (136, 257, 16x88); K2 at (2, 766, 32x80) with all-ones and left- and
   right-padded masks (fully masked rows: the uniform average of every V
   row), and at (1, 766) and (4, 766) all-ones; K3 and K4 (an fp32 query
   over the int8 cache) at every decode shape (the narration's at batch 4
   and 1, the text LM's), with a fully masked row (uniform), and the fp32
   decode body at the edges of its lanes: D = 64 and 128 over 32 heads on 8
   kv heads, q side and score side, S = 1,001 and 2,047 (a multiple of
   neither the cluster nor 32), layers 2 and 1, every third slot masked and
   a fully masked row, each call counted once in launches_f32 (K3) or
   launches_int8_f32 (K4); K5 at (a), B =
   1 and B = 4 left-padded, and at (f) (left-padded rows exactly 0), and at
   the edges of the fp32 attention body's tiling: D = 100 at S = L = 257;
   8 heads over 2 kv heads with an (H, S, L) bias, q_offset 130 and 10
   fully masked rows (exactly 0); q, k, v as views of a packed QKV of 3
   heads x 33, so k and v are only 4-byte aligned; each fp32 K1, K2 and K5
   call must raise its wrapper's launches_f32 by exactly one. A
   torch.profiler trace of one fp32 SDPA call at K1's, K2's and K5 (a)'s
   check shapes prints the kernels the yardstick runs. K6 at (8, 257, 1408
   -> 6144) and at the fp32 ViT's (136, 257), each call counted in
   launches_f32.
2c. K3 and K4 at the beam decode shapes (BEAM_DECODE_SHAPES: the flagship
   sample's 5 beams over the narration's cache at batch 1 and 4, so 5 and
   20 rows of 798 slots, 780 filled, 32 x 80, and the text LM's beam-4, 4
   rows of 2,048 slots, 2,040 filled, 32 x 128; K3 one block a (head, row)
   at all three): K3 against the twin at 2e-2 (full and mid-decode mask, NaN in
   a fully masked row), K4 against dequantize_kv + the twin at 2e-3 (3e-2
   at 20 rows), each timed as in 3 beside SDPA (K3) and its bound; printed
   on a JSON line of their own with their launches in the beam runs.
2d. The kernel shapes the decoding modes reach (SPEC_DECODE_SHAPES and
   SPEC_K5_SLOTS): K3 over the narration's speculative caches (804 slots =
   766 + 32 + gamma 4 + 2, 790 filled, 32 x 80) of the target's 32 layers
   and of the 4-layer self-draft, at batch 1 and 4, and over the text LM's
   4-layer draft cache (2,054 slots, 32 x 128, score-side scale), at the
   first, a middle and the last layer with full and mid-decode masks and
   NaN in a fully masked row; K5 at B = 1, the 1,984-token prompt into
   2,054 and 2,058 slots (a partial last key tile), on its Hopper body. Each
   against its twin at 2e-2 and timed as in 3 beside SDPA and its bound;
   printed on a JSON line of their own (decoding_mode_shapes) with their
   launches in the mode runs (none over the target's speculative cache: its
   verify pass is plain attention, as JAX's is XLA).
2e. K5's T5 forms (T5_K5_SHAPES, 32 heads x 64, no scale), bf16 and fp32:
   the encoder's self-attention over 766 tokens with the (32, 766, 766)
   relative bias in the T5 module's layout (rows padded to 768 keys) at B =
   1 and at B = 4 with a padded row (bf16: the Hopper body with its bias
   tiles), the decoder's cached step (1 query over a layer slice of the
   33-slot stacked cache, the (32, 1, 33) bias, the filled-slot mask
   expanded to (B, L)) and its cross step (1 query over 766 encoder keys, a
   padded row) (bf16: the decode body), each body by counter, against its
   twin at 2e-2 / 1e-4 and timed as in 3 beside one SDPA call with the bias
   and mask folded into one float mask and beside its bound (the bias
   counted in the dtype the kernel reads; the bf16 rows also carry
   bound_ms_fp32_bias, the count of the fp32 copy the parent's wrapper
   made); K5 at the Q-Former's self and cross attentions
   (QFORMER_K5_SHAPES: 68 videos, 32 queries over 32 and 2,056 keys, 12 x
   64, the Hopper body), held and timed the same way beside SDPA; the T5
   module's bias build at the encoder timed alone; printed on a JSON line of
   their own (t5_shapes) with their launches in phase 8b's flash runs. The
   encoder (B = 1) and cross (B = 4) rows also go on the kernels line.
3. Time each kernel against its twin with CUDA events, in turns (plain,
   kernel, kernel, plain; warm-up, median of 10), each call queued behind a
   device sleep so that the events measure device time, then one PyTorch
   call of the same function where there is one (scaled_dot_product_attention
   with the kernel's mask and scale; none for K4 and K6), and compute each kernel's
   bound from its shapes and this run's masks. K6, which no one PyTorch call
   computes, is timed beside composite_ms: the port's own LayerNorm + MLP
   modules (what the ViT runs in its place) on the same inputs. K3/K4 are timed as one decode
   step's 32 launches, one per layer of the 1 GB cache, so no call finds its
   layer in the 50 MB L2 cache; the time given is per launch; both decode
   shapes are printed, the narration one goes in the kernels line (K3's
   batch-1 time is printed too). K5 is timed at (a), and against the plain
   path at and below the auto thresholds. The fp32 bodies are timed in the
   same way at their check shapes (and K1, K2, K5 at the full-path shapes of
   2b), beside one fp32 SDPA call for K1, K2, K3 and K5; bounds at the fp32
   CUDA-core peak (67 TFLOP/s), but for the fp32 attention body (K1, K2,
   K5) and K6's fp32 body, which run 3xTF32 on the tensor cores: 495 / 3
   TFLOP/s (H100_TF32X3_FLOPS), the CUDA-core bound printed beside it; the fp32
   K3/K4 rows of the kernels line are those at the narration's batch 1, the
   shape phase 8 runs them at.
4. Drive the main path at the full eilev-blip2-opt-2.7b geometry with random
   bf16 weights N(0, 0.02) from a seeded generator on the card: the 16-shot
   prompt layout of bench.py (17 videos x 8 frames x 224^2, 766 tokens),
   uint8 frames -> process_videos -> generate (greedy, 32 new tokens), at
   batch 1 and batch 4. Per run the launch counters must rise by 39 (K1, one
   per ViT layer), 32 (K2, one per OPT layer) and 32 per one-token LM
   forward (K3), K4 and K5 not at all; every logit must be finite; a
   torch.profiler pass over one request at each batch size; the prefill
   logits through K2 must agree with the plain causal path on the same
   embeddings.
4b. K6 over the same model's 39 ViT layers at batch 1: each layer's input
   to its MLP branch, captured during one encode, through K6 with that
   layer's weights (K6 = 39 launches, every other counter 0), against the
   twin (2e-2) and the port's own layer_norm2 + mlp modules (min cosine >
   0.999; the modules round the fc1 output to bf16 before gelu); then the
   modules and K6 timed in turns on layer 0's input (also for phase 8's
   fp32 model, at its 2 layers).
4c. ICL classify on the same bf16 model, batch 4, 16 shots + 1 query video
   a row (8 frames x 224^2), the vendored class sets (187 verb prompts, 788
   noun prompts) tokenized by a word-level tokenizer with OPT's ids: (a)
   both stages through generation.classify with kernels (K1 = 39, K2 = 32 a
   stage) against the plain path on the card, prompts unpadded: (4, C)
   scores finite, cosine > 0.999, max abs error < 5e-2, argmax equal where
   the top-2 margin exceeds twice the max error; (b) class_batch_size = 64
   against unchunked, the same bar; (c) serving.VideoFeatureCache: the noun
   stage all hits (K1 = 0), scores within the bar of the pixel path, and
   greedy generate(video_features=...) and generate(vision_chunks=4) of the
   phase-4 batch-4 request token-identical to generate(pixel_values=...);
   (d) IclEvaluator end to end in fp32 at the phase-8 depth cut (8 eval
   datapoints, 4 shots drawn with replacement, batch 4, with and without
   the feature cache; left-padded prompts, the fp32 K1/K2 bodies):
   predictions and F1s identical to the plain path; (e) bf16 with row 0
   left-padded: every score of row 0 NaN on both paths, rows 1-3 finite
   (the reference behaviour, kept on purpose). Then each stage's p50 over 5
   warm requests split into encode, prefill and class scoring (CUDA events),
   without and with a cold feature cache, with the request's peak memory
   and K1/K2 launches.
4d. Generation on the same bf16 model: the flagship sample's beam search
   (5 beams, length_penalty -1, eos 50118, 32 new tokens) at batch 1 and
   4 (K1 = 39, K2 = 32, K3 = 32 per one-token forward over the 5 or 20
   beam rows; p50 of SECONDARY_REPS warm requests, peak memory, a torch.profiler pass at
   batch 4); the VideoBLIP sample's sampling (temperature 0.7, top_p 0.9)
   at batch 4 with 2 sequences a row (and a profiler pass), and beam_sample
   at batch 1, each with a generator seeded anew for every request: the
   same seed gives the same tokens twice.
4e. The decoding modes on the same bf16 model at batch 1 and 4:
   contrastive search (penalty_alpha 0.6, top_k 4), generate_stream
   (greedy, chunk 4), self-draft speculative greedy (the first 4 layers,
   gamma 4) and prompt-lookup greedy (gamma 8, match 3), then prompt-lookup
   sampling (temperature 0.7, top_p 0.9) at batch 4 with a seeded
   generator. Each request counted against its own iterations (K1 = 39; K2
   = 32 a target prefill + 4 a draft prefill; K3 = 32 a target one-token
   forward + 4 a draft one-token forward, gamma + 1 draft steps a verify
   pass), p50 of SECONDARY_REPS warm requests, peak memory, tokens a verify pass, and a
   torch.profiler pass over prompt-lookup greedy at batch 1. The stream's
   tokens equal generate's greedy tokens; speculative greedy rows equal
   plain greedy's or leave them at a near-tie of the plain path's logits
   (top-2 gap within NEAR_TIE of the row's largest |logit|, printed);
   sampling gives the same tokens twice for the same seed, all in the
   vocabulary.
5. The int8 serving mode (load_model(int8_lm=True, int8_kv=True)): the same
   model quantized on the card, in place, from its own bf16 weights; batch 1
   and batch 4. K1 = 39, K2 = 32, K4 = 32 per one-token forward, K3 = 0;
   every logit finite; the prefill logits' min cosine against the bf16
   model's on the same embeddings above INT8_MIN_COSINE. Then beam-5 at
   batch 1 over the int8 cache (K4 at 5 rows, its scales reordered with
   k and v).
6. One batch-4 run with every serving mode on: also W8A8 prefill, W8A8
   vision tower and Q-Former, fast gelu. Counts and finiteness as in 5.
7. The LLaMA text-LM path, after the VideoBLIP model is freed: the text-only
   module of TextLM at the Llama-2-7b widths (4096 wide, 32 heads x 128,
   FFN 11,008, vocab 32,000) with LLAMA_LAYERS = 8 of its 32 layers (a depth
   cut for the script's time limit; the widths, prompts and kernel shapes
   are the 7b model's) and random bf16 weights N(0, 0.02), token ids
   from a seed, greedy with 64 new tokens and eos 2 through the call
   TextLM.generate makes: batch 1 with a 1,984-token prompt, batch 4
   left-padded as in (a), and a 40-token prompt. K5 = L (the layers) per
   long-prompt request (one per prefill layer, all through its Hopper body:
   launches_sm90 = L) and 0 for the short one, K3 = L per
   one-token forward, K1, K2, K4 = 0; every logit finite; the prefill logits
   through K5 against the plain path (attention impl "xla") on the same ids:
   min cosine > 0.999, max relative error < 5e-2. A torch.profiler pass over
   one batch-1 request. A beam-4 request at batch 1 over a 2,032-token
   prompt with 16 new tokens (2,048 slots, so auto takes K5 = L; K3 = L
   per one-token forward over the 4 beam rows). Then the LM quantized in
   place (int8 LM + int8 KV cache), batch 1: K4 = L per one-token forward,
   K3 = 0, K5 = L (over the dequantized cache slice); prefill logits' min
   cosine against bf16 above INT8_MIN_COSINE. Before the int8 part (c):
   the text LM's speculative modes at batch 1, 64 new tokens: prompt lookup
   (gamma 8, 2,058 slots; K5 = L, K3 = 0) and the self-draft of 4 layers
   (gamma 4, 2,054 slots; K5 = L + 4 on the Hopper body, K3 = 4 a draft
   step), counted and compared with plain greedy as in 4e.
8. The fp32 model paths, each counted and held to the same model's plain
   path on the card (every wrapper swapped for its twin, no launch): greedy
   tokens identical, prefill logits within 1e-4 relative. The narration
   model by its default construction VideoBlipForConditionalGeneration(cfg)
   (the card, fp32) at the eilev-blip2-opt-2.7b widths with 2 ViT, 2
   Q-Former and 2 OPT layers, batch 1, 8 new tokens: K1, K2 = 2 and K3 = 2
   per one-token forward, all through their fp32 bodies; K6's fp32 body over
   its 2 ViT layers; then its int8 KV cache (K4 with an fp32 query = 2 per
   one-token forward). The text-only module of TextLM in fp32 at the
   Llama-2-7b widths with 2 layers and the 1,984-token prompt: K5 = 2 and
   K3 = 2 per one-token forward through their fp32 bodies. Beam-5,
   beam_sample and sampling (2 sequences a row) of the fp32 narration
   model, and beam-4 of the fp32 text LM, must give the plain path's tokens
   too (a sampling run's generator is seeded anew for each path, so both
   draw the same noise). (b) The decoding modes on the fp32 narration cut,
   token for token: the self-draft of 1 of its 2 layers, prompt-lookup
   greedy and the stream equal the plain path's greedy tokens, contrastive
   search the plain path's contrastive tokens; over its int8 KV cache the
   two speculative modes again (the draft steps on K4's fp32-query body).
8b. The T5 family at the eilev-blip2-flan-t5-xl widths (ViT 1408, Q-Former
   768, flan-t5-xl 2048, 32 x 64, gated-gelu 5,120, vocab 32,128, untied
   head) at T5_LAYERS = 6 layers a stack (ViT, Q-Former, encoder, decoder:
   a depth cut for the script's time limit; flan-t5-xl has 24 + 24, the ViT
   39), random bf16 weights N(0, 0.02) from
   T5_SEED, the 16-shot prompt in flan-t5's ids (766 tokens), 32 new
   tokens: (a) greedy at batch 1 and 4 under "auto" (K1 = T5_LAYERS a request,
   nothing else; every T5 attention plain), p50 of SECONDARY_REPS warm requests,
   videos/s, peak memory, a torch.profiler pass at batch 1; (b) the same
   under "flash", restored after (K5 for each Q-Former attention and encoder
   layer on its Hopper body, two a decoder layer and step on its decode
   body, by counter, on every T5 attention with its bias), the encoder
   states'
   min cosine against (a)'s > 0.999, each row's tokens equal to (a)'s or
   parting at a near-tie (NEAR_TIE); (c) beam-5 at batch 1 (the reorder
   gathers the cross K/V too), p50; (d) the seq2seq classify of the
   187-verb stage at batch 4 against the plain path (score_bar); (e) the
   fp32 model at F32_LAYERS a stack by its default construction, under
   "auto" and "flash": tokens and encoder states the plain twins' (K5's
   fp32 body with the bias); (f) contrastive search's T5 helpers, which
   generate does not reach (JAX and the port refuse T5 contrastive search),
   on (b)'s batch-4 request under "flash" and on (e)'s fp32 request (batch
   1, TF32 off) under "auto" and "flash": T5_COMMITTED = 3 decoder steps
   (the start token, then greedy) through t5_decode_step_hidden, each
   counted (K5 twice a decoder layer under "flash", on its decode body in
   bf16 and its fp32 body in fp32; nothing under "auto") with logits equal
   to t5_decode_step's bit for bit; then t5_candidates over the top
   T5_CANDIDATES = 4 tokens of the last step's logits: no launch (plain
   einsums, as in JAX), the cache unchanged (torch.equal, index), each
   candidate's hidden against t5_decode_step_hidden committing that token on
   a clone of the cache (bf16 min cosine > 0.999, fp32 within F32_TOL); the
   sub-phase's seconds and host times. Printed on a JSON line of its own
   (t5).
9. Training, after the earlier models are freed. (a) The v2 training step
   (training.make_train_step: forward with labels, backward into the fp32
   masters of the query tokens, Q-Former and language projection, AdamW)
   at the full eilev-blip2-opt-2.7b geometry in bf16, N(0, 0.02) weights
   from a seeded generator, bench's 16-shot prompt padded to 1,024 tokens
   (labels -100 on the video slots and the padding), dropout on: the JAX
   training bench's variants 1, 1r, 2r and 4r (datapoints a micro-batch, r
   = remat of the LM trunk), each one counted warm step (K1 = 39, one a ViT
   layer, under no grad; K2-K6 = 0) and 3 timed steps: s/step, videos/s,
   peak memory; loss and grad_norm finite; a torch.profiler pass over one
   step of 1; the frozen weights unchanged. The gradient checks run with
   every LayerNorm at scale 1 and bias 0 (unit_norms_), so that every
   leaf carries a gradient: 1 against 1r on the same dropout seed, loss
   and every trainable gradient bit-identical. (b) K1 against its twin at
   full width, bf16, dropout off (every wrapper swapped by plain_kernels):
   loss within 2e-2 relative, the whole trainable gradient's cosine and
   each leaf's > 0.99. Then the Trainer at variant 1: batches from
   train_batch_iterator over 16-shot datapoints augmented on the card in
   its prefetch thread, 4 timed steps beside the bare step's time. (c) The
   fp32 model at the phase-8 cut (bench.py's init), dropout on, the same
   seed on both paths: loss within 1e-4 relative and each leaf's gradient
   within 1e-4 of its largest element; then at unit LayerNorm scales, where
   fp32 itself is not that close to fp64 on either path, each path against
   the plain path in fp64: the kernel path's worst leaf error at most twice
   the plain path's. In (b) and (c) the attention key biases (KEY_BIAS:
   their exact gradient is 0, so rounding noise has no direction to
   compare) are held below bf16's unit roundoff (b) or 1e-5 (c) of the
   largest leaf norm on both paths instead. The augmentation's ms per 17-clip
   datapoint on the card. (d) The Trainer at that cut: batches from
   train_batch_iterator over in-memory datapoints of uint8 clips (2 shots +
   a query, augmented on the card, the ICL phase's word tokenizer), 2 a
   step; the loss falls; a run saved at step 4 and resumed ends with the
   uninterrupted run's trainable state, bit for bit. (e) K1 called under
   grad on a tensor that requires grad raises, launching nothing. (f)
   Parallel training (training/pipeline_step.py, parallel/): (a) on (a)'s
   model (unit LayerNorm scales), the OPT trunk's 32 layers as a GPipe
   schedule of PP_STAGES = 4 stages (8 layers each, every stage on the one
   card) and PP_MICROBATCHES = 4 micro-batches over a micro-batch of
   PP_MICRO = 4 datapoints, dropout off: loss within 2e-2 relative and the
   gradients' cosines > 0.99 against the plain step on the same batch, K1 =
   39 and nothing else, then the pipelined and the plain train step timed
   (one counted warm step, PP_STEPS timed: s/step, peak memory); (b) fp32
   cuts, TF32 off, unit LayerNorm scales: the 2.7b widths with PP_F32_LAYERS
   = 4 OPT layers over 2 and 4 stages, and the flan-t5-xl widths with 4
   encoder and 4 decoder layers over 2, each PP_F32_MICRO = 2 micro-batches:
   the loss and every leaf's gradient within 1e-5 (relative to its largest
   element) of the plain step's; (c) on (a)'s model, the process group on
   NCCL with a world of one (NCCL takes one rank a card; the multi-rank
   arithmetic is held on the CPU by gloo in tests/test_torch_parallel_dp.py):
   two Trainer steps with zero_shard_opt_state against two without from the
   same weights, the trainable leaves and the optimizer state bit-identical;
   the all-reduce of the gradient's size and the all-gather of the ZeRO
   update timed. A JSON line of its own (parallel).
10. HF checkpoints and the CLIs, after the training models are freed, at
   the eilev-blip2-opt-2.7b widths with 4 ViT, 12 Q-Former and 4 OPT
   layers (CKPT_LAYERS): (a) a bf16 model of N(0, 0.02) weights from a seed
   exported by training.checkpoint.export_hf_safetensors (fp32) beside a
   config.json written here, the export's seconds and GB/s; (b)
   models.auto.load_model(dtype=bf16, param_dtype=bf16) onto the card,
   timed (seconds and GB/s of the file): every tensor equal to the
   source's, bit for bit, and greedy over bench.py's 16-shot prompt at
   batch 1 with 32 new tokens counted (K1 = 4, K2 = 4, K3 = 4 per one-token
   forward) and token-identical to the source model; (c) the CLIs' default,
   load_model(dtype=bf16) with fp32 weights: counted the same, prefill
   logits' min cosine over every position against (b)'s > 0.999; (d)
   load_model(int8_lm=True, int8_kv=True) (bf16 compute): K4 = 4 per
   one-token forward, K3 = 0, cosine > INT8_MIN_COSINE; (e) on (c)'s model,
   cli.generate_narration_texts.run at batch 4 (4 datapoints of 16 shots +
   a query over phase 4's frames, the ICL phase's word tokenizer, equal-length
   unpadded prompts): one CSV row a datapoint, K1 = 4, K2 = 4, K3 = 4 per
   one-token forward, finite logits; and cli.icl_eval.run at batch 4 (4
   eval datapoints, 1 shot, the vendored class sets): verb-stage prompts
   that fill their 64-token bucket (unpadded, finite scores), noun-stage
   rows left-padded by the predicted verb's words and NaN on every class
   exactly there (the reference behaviour), K1 = 8, K2 = 8, the F1 JSON
   written; (f) cli.train_v2.run at phase 8's fp32 cut, from a checkpoint of
   that cut loaded as the CLI loads it, 2 steps of 2 datapoints, an eval
   and --export_hf (the fp32 K1 body on the frozen ViT): the export
   reloaded through load_model holds the trainer's trainable tensors
   exactly; (g) the two samples' run with synthetic frames and the word
   tokenizer: EILeV's (beam 5, eos 50118) on (c)'s model and VideoBLIP's
   (sampling) on the checkpoint loaded as the v1 model, counted (K1 = 4,
   K2 = 4, K3 = 4 per one-token forward), the same text twice; (h) a bf16
   VideoBLIP-T5 at the flan-t5-xl widths, F32_LAYERS a stack, exported and
   loaded back with bf16 weights: every tensor bit for bit, greedy tokens
   identical to the source model's (K1 = F32_LAYERS); (i) on (c)'s model the
   evaluation CLIs: cli.get_vision_model_embs.run at batch 8 (K1 = the 4 ViT
   layers, nothing else; finite embeddings), cli.train_v1.run for 2 steps on
   the checkpoint loaded as the v1 model (bf16, K1 only, a finite eval loss),
   cli.generation_eval.run and cli.verify_quality.run --generated_csv on a
   CSV written here (random narrations: exit code 1). The directories are
   temporary and deleted at the phase's end.
11. Serving (serving/engine.py, serving/session.py, cli/serve.py), each leg
   counted (counters at 0 just before, read just after; K1 39 an encode, K2
   32 an admission prefill, K3/K4 32 a one-token forward, the speculative
   verify passes plain attention, as in JAX): (a) eilev-blip2-opt-2.7b in
   fp32 at full depth (its default construction), six staggered requests
   (P = 766 ... 790, their 17 videos encoded once by a VideoFeatureCache the
   runs share) through a 4-slot engine (chunk 8, bucket 64, max_len 960:
   compaction and slot reuse), plain and prompt-lookup speculative, every
   row token-identical to the request's isolated fp32 generate; (c) on the
   same model a captured speculative cache (4 slots x 2,048: sampled lookup
   passes leave holes; a 46-token request admitted behind a dead prefix
   longer than a split chunk), every layer through K3 and K4 against their
   twins in fp32 (F32_TOL) and cast to bf16 (2e-2, K4_TOL), every call
   timed; (b) the bf16 model through cli/serve.py's run at its defaults (4
   slots, max_len 2,048, chunk 8, bucket 128): 12 requests at once, then at
   half the rate the first leg sustained, with p50/p95 latency, time to
   first chunk, videos/s, peak memory, launches a request and the NaN rows
   (left-padded bf16 admissions, the reference's behaviour: the finite rows
   must be exactly the unpadded admissions); one decode chunk's host syncs
   (torch.cuda.set_sync_debug_mode) and, profiled, its idle share; a
   bucket-2 leg of four unpadded 766-token requests, rows within one bf16
   ulp of isolated generate (phase 4e's rule); (c) K2 at an admission's shape
   (1, 768, 32x80, left-padded by 2) held and timed; the int8 KV cache at
   a 4-layer fp32 cut, rows identical; (e) ChatSession on the bf16 model,
   three turns each adding a video and a question, each reply against a
   from-scratch generate (NEAR_TIE) and timed beside it, and at the fp32
   2-layer cut identical; (d) eilev-blip2-flan-t5-xl in bf16 at phase 8b's
   T5_LAYERS cut, 8 staggered requests through a 4-slot engine (a 64-slot
   decoder cache), under "auto" and "flash" (K5 = 30 an admission on its
   Hopper body + 24 a decoder step on its decode body, by counter):
   rows against isolated generate of the prompt and of the prompt padded as
   the engine encodes it (NEAR_TIE); under "auto" a request admitted into a
   slot that decoded while empty may decode from NaN (token 0; the
   reference's behaviour), under "flash" none; K5 at the engine's self (4,
   1, 64) and cross (4, 1, 832) steps held, on the decode body, and timed;
   the fp32 2-layer cut
   identical. A JSON line "serving" with the legs' numbers and the phase's
   launches, which the kernels line's rows also carry (serving_launches).
12. The evaluation encoders and the VideoMAE baseline: (a) K5 at VideoMAE's
   form, (8, 1,568, 12 x 64), bidirectional, no mask, no bias, bf16 (the
   Hopper body at head dim 64) and fp32, against its twin at 2e-2 / F32_TOL and timed as
   in 3 beside SDPA and its bound (two rows of the kernels line); VideoMAE-base
   (12 x 768, 16 frames x 224^2, random weights from a seed) predicting at
   batch 8 in fp32 under "auto" (plain, no K5) and "flash" (K5's fp32 body,
   12 launches): the same argmax, max |delta| printed; a bf16 forward under
   "flash" (12 bf16 launches, on the Hopper body); cli.baselines.videomae_train.run at its
   defaults (batch 8, fp32, "auto", the augmentation on the card) for 3
   steps: s/step, finite losses, peak memory, no kernel launch. (b)
   roberta-large, all-mpnet-base-v2 and the stsb-roberta-large cross-encoder
   at their published widths (N(0, 0.02), unit LayerNorms, from a seed)
   through SentenceEncoder._from_parts with a word-level tokenizer: the three
   metrics over 64 narration pairs at batch 32, each timed, and the first 8
   pairs' scores on the card within 1e-4 of the same code on the CPU. A JSON
   line "eval_baselines".
13. Tensor parallelism on one card (parallel/tensor.py, run_tensor_parallel):
   TP_RANKS = 2 ranks spawned on cuda:0, one gloo group over CUDA tensors
   (NCCL takes one rank a card), one model axis, beside the unsharded port
   in this process. (a) eilev-blip2-opt-2.7b at full width and depth, bf16
   N(0, 0.02) weights from TP_SEED exported once in bf16
   (export_hf_safetensors) and loaded by each rank through
   load_model(mesh=): greedy at batch 1 on bench.py's 16-shot prompt, 32 new
   tokens, then with the int8 KV cache: the prefill's last logits' cosine
   against the unsharded model's > 0.999, tokens identical or parting at a
   near-tie (NEAR_TIE), the ranks' tokens equal; K1 = 39 at 8 x 88, K2 = 32
   at 16 x 80, K3 (K4) = 32 a one-token forward at 16 x 80 on every rank;
   per-rank peak memory and the counted request's time (two ranks share one
   card and every collective goes through the host: no TP speed). (b) fp32 cuts, TF32 off,
   F32_LAYERS a stack (the 2.7b widths, flan-t5-xl's and Llama-2-7b's with
   the 1,984-token prompt, so K5 runs), each built whole from a seed and
   sharded in memory: greedy tokens identical to the unsharded port's, ICL
   classify at the OPT cut (TP_CLASSES classes) within 1e-4; the LLaMA cut
   in bf16 too (K5's Hopper body at 16 x 128). (c) The kernels at the
   local-head shapes against their twins and timed as in 3 (K1 (136, 257,
   8 x 88), K2 (1, 766, 16 x 80), K3/K4 (1 and 4, 798, 16 x 80), K5 (1,
   1,984 into 2,048, 16 x 128)), on a JSON line "tensor_parallel" with their
   launches in (a) and (b) (K3/K4 at batch 4: check only).
14. Tensor-parallel training on one card (run_tensor_parallel_training):
   TP_RANKS = 2 gloo ranks on cuda:0 over CUDA tensors, data 1 x model 2,
   beside the unsharded port's step in this process (run first and freed).
   (a) eilev-blip2-opt-2.7b at full width and depth, bf16 N(0, 0.02) weights
   from TPT_SEED with the Q-Former in fp32 master weights, each rank building
   it whole and keeping its shard: two steps of make_train_step (dropout on,
   the recipe's clip, micro-batch 1 of one 16-shot datapoint, TRAIN_SEQ
   tokens), the first counted (K1 = 39 a rank, 8 x 88, nothing else; the
   OPT trunk's attention stays plain for its gradient) and the second timed:
   loss and grad_norm of both steps within phase 9's bf16 bar (2e-2
   relative) of the unsharded step's on the same batch and masks, the first
   step's whole-gradient cosine printed, the replicated trainable leaves
   bit-identical across the ranks, per-rank weights and peak memory below
   the unsharded step's (the step time is a one-card gloo schedule's, no TP
   speed). (b) fp32 cuts, TF32 off, F32_LAYERS a stack at the 2.7b widths
   and flan-t5-xl's, N(0, 0.02) from TPT_SEED + 1: two steps with dropout
   on, loss and grad_norm within 1e-5 relative and every gathered trainable
   leaf within 1e-5 of the unsharded port's step evaluated in fp64 (the
   plain path: the kernels take no fp64), the yardstick because the fp32
   unsharded step is itself ~1e-5 off it (its distance and the TP step's to
   it printed beside each other); a TP checkpoint (save_checkpoint with
   the mesh) and the HF export from the ranks: the export loaded unsharded
   holds the ranks' gathered trainable leaves bit for bit and the frozen
   towers as they came in, and the checkpoint restores onto one process bit
   for bit. A JSON line "tensor_parallel_training"; the phase's time.

15. Tensor-parallel serving on one card (tps_legs and tps_check), run
   inside phase 13 on its two gloo ranks over CUDA tensors and its
   unsharded model, on the same models: eilev-blip2-opt-2.7b loaded by each
   rank through load_model(mesh=) (one load serves both phases; (a) after
   phase 13's bf16 request, (c) after its int8 KV request). (a) cli/serve.run at
   --model_parallel 2, full width and depth: 4 requests of the 16-shot
   layout (17 videos x 8 frames, the 16 in-context videos shared and
   encoded once by --vision_cache), 2 slots, chunk 8, 8 new tokens,
   staggered arrivals decided by rank 0's clock, a prefill bucket dividing
   the prompt length (no bf16 admission left-padded): the ranks' rows the
   same, equal to the unsharded engine's or parting at a near-tie, each
   admission's logits within cosine 0.999 of the unsharded engine's; the
   launches (K1 a feature-cache encode, K2 an admission, K3 a one-token
   forward), weights and peak memory a rank against unsharded, the
   all_reduces a token step (2 a layer + 2). (b) fp32 cuts (F32_LAYERS a
   stack): prompt lookup, a two-turn ChatSession and greedy over the int8
   KV cache at the 2.7b widths, flan-t5-xl's engine under "flash" (K5's
   bias form at 16 x 64), tokens identical to the unsharded port's. (c)
   int8_lm + w8a8_prefill + int8_vision + int8_qformer on the full-depth
   model over phase 13's int8 KV cache, so every int8 mode at once
   (quantize_model_ in place on each rank's loaded model, as load_model
   with the flags does), at a 1-shot request (2 videos, 91 tokens):
   prefill cosine > 0.99 against bf16, tokens the unsharded int8 model's or
   parting at a near-tie, K4 at every decode step, the int8 bytes a rank. (d) K1 at a feature-cache encode (64, 257, 8 x 88),
   K2 at an admission (1, 768, 16 x 80) left-padded by 2, K3 and K4 over a
   rank's captured engine cache (4 x 2,048, 16 x 80) against their twins,
   timed as in 3 beside SDPA and the bound. A JSON line
   "tensor_parallel_serving" (printed after phase 14's); its time on each
   side.
16. The tools around the model (the data-preparation, sentence and
   analysis CLIs and the v1 chat demo), each sub-phase timed. (e) After
   phase 4e, on phase 4's bf16 weights as the v1 class (a meta-device
   module given the same tensors): demo/video_blip_demo.VideoBlipChat with
   the word tokenizer, 10 frames (set_video where the native decoder
   builds, else set_frames), two turns of sampling (temperature 0.7, top_p
   0.9, 128 new tokens), each counted (K1 = 39, K2 = 32, K3 = 32 a one-token
   forward) and token-identical to generate called directly with a
   generator seeded with the dialogue's length; with top_k 1 each turn
   against greedy generate (identical, or parting at a tie: top_k keeps
   every token tied at the top). (d) Inside phase 7, on its bf16 module:
   cli/ego4d/generate_std_sent and cli/epic_kitchens/transform_to_full_sent
   run over TextLM._from_parts and a word tokenizer with LLaMA's ids, 16
   rows in batches of 8, 64 new tokens, newline eos, each batch's prompts
   one length: K3 = the layers a one-token forward, nothing else; each row
   of the first batch against its prompt alone (first-step logits' cosine >
   0.999, tokens identical or parting at a near-tie). (a)-(c) after phase
   12, in a temporary directory of the checkout: a 1920x1080, 30 fps, 12 s
   y4m video with four narrated actions (one rejected); (a)
   cli/ego4d/extract_frames (main where the decoder builds, else extract()
   over seeded clips of the same shape; decoder_available() and the build
   error printed) to 8 frames at 448^2 on the card in png and raw and on
   the CPU in png: the CSVs equal, raw equal to png, the card's frames
   within one uint8 level of the CPU's (the share that differ printed),
   clips/s and the decode, resize and write seconds; (b)
   cli/epic_kitchens/epic_kitchens_extract_frames over the video symlinked
   under EK-55's layout; (c) the split twice (byte-identical) and the
   structured columns backfilled into the card's and the CPU's CSVs (the
   same bytes, equal to (a)'s columns). (f) K1 at the chat's (10, 257,
   16x88), K2 at each turn's prefill, K3 over each turn's cache and each
   sentence tool's (also with left-padded rows) against their twins at
   2e-2, timed as in 3 beside SDPA with the same mask and
   the bound. JSON lines "data_tools" and "data_tools_shapes" (with their
   launches in (d) and (e)).

Prints every number tagged with the card's name and power limit, then the
JSON line of the beam shapes' K3/K4 rows, the JSON line of the training
variants, the JSON line of the decoding modes' kernel shapes, the JSON lines
of K5's T5 forms, of the T5 phase, of serving, of phase 12, of phase 13, of
phase 14, of phase 15 and the two of phase 16, then one JSON
line of per-kernel results (every body: the bf16 ones and the fp32 ones,
whose launches come from phase 8, and K5's VideoMAE rows, whose launches
come from phase 12; K6's rows also carry composite_ms), then the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

With ``--kernel-times DIR`` it imports eilev_tpu_torch from DIR instead (an
unpacked parent commit, or this tree), builds K3-K6's sources and the fp32
attention body there, and only times K3/K4 at the three decode shapes (bf16,
and with an fp32 model also over a cache masked as phase 11 (c)'s capture), K5
at (a), batch 1 and 4, K5's bf16 forms of the T5 path, the T5 engine,
VideoMAE and the Q-Former (each bias as that tree's T5 module builds it,
and the encoder's also as a contiguous fp32 bias: the kernel alone), the fp32 attention body at K1 (2 and 136, 257,
16x88), K2 (2, 1 and 4, 766, 32x80) and K5 (a) batch 1 and 4, and K6 on
phase 2's and 2b's inputs (bf16 at 136 frames, fp32 at 8 and 136), twice each
(printing which K3 body the tree's rule picks, where it has one), then
prints one JSON line of times: the A/B of a kernel change within one call
(parent, change, change, parent). It checks nothing and prints no result
line.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import dataclasses
import gc
import json
import os
import pathlib
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

SHOTS = 16
FRAMES = 8
MAX_NEW_TOKENS = 32
TEXT_TOKENS_PER_SHOT = 12
NEWLINE = 50118  # OPT "\n", the narration eos
# int8 per-channel weight rounding puts about 0.2% relative noise on each of
# the 128 LM matmuls; with random N(0, 0.02) weights at full depth and bf16
# activations that is a cosine near 0.999 (the JAX int8 test asks 0.999 of a
# 2-layer model). 0.99 leaves room for the depth and still fails a wrong
# scale, transpose or layer, which give a cosine near 0.
INT8_MIN_COSINE = 0.99
# the LLaMA text-LM path: a 1,984-token prompt and 64 new tokens fill a
# 2,048-slot cache, so auto dispatch takes K5 on every prefill layer; the
# batch-4 rows are left-padded to these real lengths
LLAMA_PROMPT = 1984
LLAMA_NEW = 64
LLAMA_CACHE = LLAMA_PROMPT + LLAMA_NEW
LLAMA_REAL = (1984, 1900, 1800, 1700)
LLAMA_SHORT = 40
LLAMA_EOS = 2
LLAMA_LAYERS = 8  # of Llama-2-7b's 32: phase 7's depth cut (the script's time limit)
# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): bf16
# tensor cores, fp32 on the CUDA cores, and HBM3
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
# fp32-accurate work as 3xTF32: three TF32 tensor-core products (495 TFLOP/s
# dense) for each fp32 one, the fp32 attention body's design
H100_TF32X3_FLOPS = 495e12 / 3
H100_BYTES_PER_S = 3.35e12
# the fp32 bodies against their twins (TF32 off on both sides): the twins
# follow the same fp32 arithmetic and differ only in the order of fp32 sums
# (a relative 1e-6 or so at these widths)
F32_TOL = 1e-4
# the fp32 model runs: the eilev-blip2-opt-2.7b and Llama-2-7b widths at 2
# layers of each stack, batch 1, 8 new narration tokens
F32_LAYERS = 2
F32_NEW_TOKENS = 8
# the decode-attention shapes K3/K4 are checked at: (layers, B, slots,
# filled slots, heads, head_dim, q-side scale). The narration's (766 prompt +
# 32 new slots) at batch 4, the text LM's (2,048 slots, 32 tokens in), and
# the narration's at batch 1 (K4 takes a cluster of 3 at batch 4 and of 8
# here). The bf16 rows of the kernels line are timed at batch 4 (the text
# LM's and K3's batch-1 times are printed), the fp32 rows at batch 1, where
# phase 8 runs them (the other two shapes' times are printed)
DECODE_SHAPES = {
    "narration": (32, 4, 798, 780, 32, 80, True),
    "text-LM": (32, 1, LLAMA_CACHE, LLAMA_CACHE - 32, 32, 128, False),
    "narration batch 1": (32, 1, 798, 780, 32, 80, True),
}
# the generation phase (4d): the flagship sample's beam search
# (samples/eilev_generate_action_narration.py) and the VideoBLIP sample's
# sampling (samples/video_blip_generate_action_narration.py), the seed of the
# sampling generator, and the text LM's beam-4 run: a 2,032-token prompt and
# 16 new tokens fill 2,048 slots, so auto takes K5 in its prefill
BEAM_KNOBS = dict(num_beams=5, length_penalty=-1.0)
SAMPLE_KNOBS = dict(do_sample=True, temperature=0.7, top_p=0.9)
GEN_SEED = 11
LLAMA_BEAM_NEW = 16
LLAMA_BEAM_PROMPT = LLAMA_CACHE - LLAMA_BEAM_NEW
# the beam decode shapes K3/K4 are also held and timed at (phase 2c): the
# flagship sample's 5 beams over the narration's cache at batch 1 and 4, so
# 5 and 20 cache rows of 32 x 80, and the text LM's beam-4 (4 rows of 2,048
# slots, 32 x 128, half its new tokens in); K3 takes one block a (head, row)
# at all three
BEAM_DECODE_SHAPES = {
    "beam-5 batch 1": (32, 5, 798, 780, 32, 80, True),
    "beam-5 batch 4": (32, 20, 798, 780, 32, 80, True),
    "text-LM beam-4": (32, 4, LLAMA_CACHE, LLAMA_BEAM_PROMPT + LLAMA_BEAM_NEW // 2, 32, 128, False),
}
# the decoding modes (phase 4e; (c) in phase 7, (b) in phase 8): the
# narration CLI's defaults, gamma 4 for the self-draft of the first 4 layers
# and 8 for prompt lookup (match 3), contrastive search at penalty_alpha 0.6
# and top_k 4, streaming in chunks of 4. Speculative caches hold s + max_new
# + gamma + 2 slots: 804 (766 + 32 + 4 + 2) for the narration's self-draft,
# 2,054 and 2,058 for the text LM's self-draft and prompt lookup. A
# speculative row whose bf16 tokens leave plain greedy's must do so at a
# near-tie of the plain path's logits: a top-2 gap within NEAR_TIE of the
# row's largest |logit| (the verify pass computes the same logits by plain
# attention over a block of gamma + 1 queries, K3 one query at a time)
DRAFT_LAYERS = 4
DRAFT_GAMMA = 4
LOOKUP_GAMMA = 8
LOOKUP_MATCH = 3
CONTRASTIVE_KNOBS = dict(penalty_alpha=0.6, top_k=4)
STREAM_CHUNK = 4
NEAR_TIE = 2e-2
# the T5 phase (the eilev-blip2-flan-t5-xl geometry): flan-t5's eos and the
# whitespace id its tokenizer reads "\n" as, and the seed of its weights.
# K5's T5 forms (phase 2e), 32 heads x 64, no scale: (batch, queries, keys)
# of the encoder's self-attention over the 766-token prompt (a padded row at
# batch 4), the decoder's cached step (one query over 33 slots, 13 filled)
# and its cross step over the encoder states (a padded row)
T5_EOS = 1
T5_NEWLINE = 3
T5_SEED = 47
T5_COMMITTED = 3  # 8b (f): decoder steps committed before the candidate expansion
T5_CANDIDATES = 4  # 8b (f): contrastive search's top_k
T5_K5_SHAPES = {
    "T5 encoder, batch 1": (1, 766, 766),
    "T5 encoder, batch 4": (4, 766, 766),
    "T5 decoder self, batch 4": (4, 1, MAX_NEW_TOKENS + 1),
    "T5 cross, batch 4": (4, 1, 766),
}
T5_DECODE_FILLED = 13
# K5 at the Q-Former's attentions (phase 2e), 12 heads x 64, scale 64^-0.5:
# (videos, queries, keys) of a batch-4 T5 request's 4 x 17 videos, the 32
# query tokens over themselves and over 8 frames x 257 ViT tokens
# the rows of phase 2e that also go on the kernels line (K5's bf16 Hopper
# body with the bias tiles and its decode body)
K5_T5_LINE_ROWS = ("flash_attention at T5 encoder, batch 1", "flash_attention at T5 cross, batch 4")
QFORMER_K5_SHAPES = {
    "Q-Former self, 68 videos": (4 * 17, 32, 32),
    "Q-Former cross, 68 videos": (4 * 17, 32, 8 * 257),
}
DECODING_MODES = {
    "contrastive (penalty_alpha 0.6, top_k 4)": (CONTRASTIVE_KNOBS, {}),
    f"stream (greedy, chunk {STREAM_CHUNK})": ({}, {"chunk_tokens": STREAM_CHUNK}),
    f"self-draft ({DRAFT_LAYERS} layers, gamma {DRAFT_GAMMA})": (
        {}, {"draft_layers": DRAFT_LAYERS, "draft_tokens": DRAFT_GAMMA}),
    f"prompt lookup greedy (gamma {LOOKUP_GAMMA}, match {LOOKUP_MATCH})": (
        {}, {"draft": "prompt_lookup", "draft_tokens": LOOKUP_GAMMA, "draft_match_len": LOOKUP_MATCH}),
}
# the new kernel shapes the modes reach (phase 2d): K3 over the
# speculative caches of the narration (32 x 80, the target's 32 layers and
# the 4-layer draft's, batch 1 and 4) and the text LM's draft (32 x 128,
# score-side scale), and K5 at the text LM's speculative prefills
SPEC_DECODE_SHAPES = {
    "narration speculative cache, batch 1": (32, 1, 804, 790, 32, 80, True),
    "narration speculative cache, batch 4": (32, 4, 804, 790, 32, 80, True),
    "narration 4-layer draft cache, batch 1": (4, 1, 804, 790, 32, 80, True),
    "narration 4-layer draft cache, batch 4": (4, 4, 804, 790, 32, 80, True),
    "text-LM 4-layer draft cache": (4, 1, LLAMA_PROMPT + LLAMA_NEW + DRAFT_GAMMA + 2, 2040, 32, 128, False),
}
SPEC_K5_SLOTS = (LLAMA_PROMPT + LLAMA_NEW + DRAFT_GAMMA + 2, LLAMA_PROMPT + LLAMA_NEW + LOOKUP_GAMMA + 2)
# K4 against dequantize_kv + the twin: 3e-2 (the JAX int8 kernel test's bar)
# at the narration's batch 4, where it has always been held; every other K4
# check at 2e-3, from its measured maxima on an H100 (4.9e-4 at the text
# LM's shape, 6.1e-5 at the narration's, 0 at S = 1 and 5 and in the fully
# masked row): an output is ~0.03, so rounding p before normalising it, or
# a flash-decoding rescale, moves it past 2e-3
K4_TOL = 3e-2
K4_TIGHT_TOL = 2e-3
# the two-pass body's check (K1 and K2 past S = 2,048): K2's row 0 has this
# many left-padded keys, so its first rows are fully masked (NaN)
TWO_PASS_PAD = 100
# the ICL classify phase: batch 4 (the eval script's), warm repetitions of
# a timed request, and the bar the full-width bf16 scores (mean
# log-likelihoods near -11 at random weights) are held to against the plain
# path, and chunked and cached scores against unchunked pixel ones
ICL_BATCH = 4
ICL_REPS = 5
# timed requests (after one counted warm request) of the legs whose p50 is
# a secondary figure: the generation knobs, the decoding modes, T5, the text
# LM's beam-4 and int8 legs (3 until the parallel-training phase needed the time)
SECONDARY_REPS = 2
ICL_SCORE_TOL = 5e-2
ICL_MIN_COSINE = 0.999
# phase 9, training: the JAX training bench's variants (datapoints a
# micro-batch, r = remat of the LM trunk), each 1 warm and TRAIN_STEPS timed
# steps at the train CLI's token bucket (--max_length 1024); the dropout seed
# of the remat and kernel-vs-plain comparisons; the Trainer run at the fp32
# cut: datapoints of TRAINER_SHOTS shots + a query, 2 a step, saved at
# TRAINER_SAVE_AT and resumed
TRAIN_VARIANTS = ("1", "1r", "2r", "4r")
TRAIN_SEQ = 1024
TRAIN_STEPS = 3
TRAIN_DROPOUT_SEED = 5
TRAINER_DATAPOINTS = 2
TRAINER_SHOTS = 2
TRAINER_MAX_LEN = 256
TRAINER_STEPS = 10
TRAINER_SAVE_AT = 4
TRAINER_SEED = 42
TRAINER_LR = 5e-3
TRAINER_FULL_STEPS = 4  # the Trainer's timed steps at the full geometry, after one
# phase 9 (f), parallel training: the full-depth OPT pipeline's stages and
# GPipe micro-batches over a micro-batch of PP_MICRO datapoints (all stages
# on the one card), its timed steps; the fp32 cuts' LM depth and micro-batch
PP_STAGES = 4
PP_MICROBATCHES = 4
PP_MICRO = 4
PP_STEPS = 2
PP_F32_LAYERS = 4
PP_F32_MICRO = 2
T5_TARGET = 32  # the T5 leg's decoder labels a row
T5_LAYERS = 6  # phases 8b and 11 (d): layers a stack (a depth cut for the script's time limit)
NCCL_STEPS = 2
BF16_ROUNDOFF = 2.0**-7  # bf16's unit roundoff: a key bias's norm share "zero" in bf16
# phase 13, tensor parallelism on one card: TP_RANKS ranks of one model
# group over gloo with CUDA tensors (NCCL takes one rank a card), the seed
# of the models' weights, timed bf16 greedy requests a rank after the
# counted one (the int8 KV cache's counted request only: the phase keeps
# inside 120 s), the classes of the ICL classify at the fp32 OPT cut (TP_CLASSES of
# TP_CLASS_LEN tokens), and how long the parent waits for the ranks. The
# local-head kernel shapes (c) are checked and timed at: the narration's
# decode at batch 1 and 4 (K3 on the split at both: 2 * B * 16 <= 132)
TP_RANKS = 2
TP_SEED = 48
TP_REPS = 0  # phase 13 (a)'s timed repetitions (cut for the script's time limit)
TP_CLASSES = 16
TP_CLASS_LEN = 4
TP_DEADLINE_S = 600
TP_DECODE_SHAPES = {
    "narration tp 2": (32, 1, 798, 780, 16, 80, True),
    "narration batch 4 tp 2": (32, 4, 798, 780, 16, 80, True),
}
# phase 15, tensor-parallel serving on one card: (a)'s requests (16-shot
# layout, the in-context videos shared), slots, chunk and new tokens, a
# prefill bucket that divides the prompt length (no bf16 admission
# left-padded), the open-loop arrival rate (a second), the seed of the
# requests and of (d)'s inputs, (d)'s captured engine cache (slots x slots),
# (c)'s videos and (d)'s timing repetitions (the ranks are phase 13's)
TPS_REQUESTS = 4
TPS_SLOTS = 2
TPS_CHUNK = 8
TPS_NEW = 8
TPS_BUCKET = 2
TPS_RATE = 20.0
TPS_SEED = 52
TPS_CAPTURE = (4, 2048)
TPS_INT8_VIDEOS = 2  # (c)'s request: one in-context shot and the query
TPS_TIMING_REPS = 10  # (d)'s medians (the phase's time)
# phase 10, checkpoints and CLIs: the exported model's ViT, Q-Former and OPT
# layers (the widths are eilev-blip2-opt-2.7b's) and its weights' seed
# phase 14: tensor-parallel training on one card
TPT_SEED = 50
TPT_DEADLINE_S = 600
# lr 1e-4 as the recipe, no warmup; eps 1e-6 as the CPU tests; the clip at the recipe's 1.0
TPT_OCFG = dict(learning_rate=1e-4, eps=1e-6, warmup_steps=0, total_steps=10)
TPT_TOL = 1e-5
CKPT_LAYERS = (4, 12, 4)
CKPT_SEED = 10
# K6's inputs come from their own generator, so phases 2 and 2b and
# --kernel-times run the same numbers at each shape
K6_SEED = 6
K6_COMPOSITE = ("models/vision.py MixedLayerNorm + VisionMLP (layer_norm2, fc1, gelu, fc2): what the ViT "
                "runs in K6's place, several library calls, not one")
# device sleep before each timed call (median_ms): at most ~20 ms at the
# H100's 1.98 GHz, longer than the host takes to enqueue a 32-layer decode
# step of the plain twin; at least ~2 ms, several single-kernel enqueues
SLEEP_CYCLES = 40_000_000
MIN_SLEEP_CYCLES = 4_000_000


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def build_prompt(num_query_tokens: int, batch: int, t5: bool = False):
    """bench.py's interleaved 16-shot layout: bos + per video [32 query slots +
    newline + 12 text tokens]; for flan-t5 (the seq2seq prompt builder's) no
    bos, its ids (pad 0 in the query slots, "\n" read as its whitespace
    token), and the eos closing the prompt. 766 tokens either way."""
    rng = np.random.default_rng(0)
    ids, vim = ([], []) if t5 else ([2], [0])
    pad, newline, high = (0, T5_NEWLINE, 32000) if t5 else (1, NEWLINE, 40000)
    for _ in range(SHOTS + 1):
        ids += [pad] * num_query_tokens + [newline]
        vim += [1] * num_query_tokens + [0]
        toks = rng.integers(1000, high, size=TEXT_TOKENS_PER_SHOT).tolist()
        ids += toks
        vim += [0] * len(toks)
    if t5:
        ids, vim = ids + [T5_EOS], vim + [0]
    ids = np.asarray([ids] * batch)
    vim = np.asarray([vim] * batch)
    return ids, np.ones_like(ids), vim


def random_init_(model: torch.nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Every parameter N(0, std) from ``generator``, norms included, as bench.py
    initialises the JAX model."""
    with torch.no_grad():
        for param in model.parameters():
            param.normal_(0.0, std, generator=generator)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` by CUDA events. Each timed call is queued
    behind a device sleep, so the host has enqueued all of its launches
    before the start event fires: the events bracket device work, not the
    host's launch overhead (which exceeds a decode-attention launch). The
    sleep is 4x the longest host time of a warm-up call (which includes any
    wait that ``fn`` makes on the device), from MIN_SLEEP_CYCLES (~2 ms) to
    SLEEP_CYCLES (~20 ms): a single kernel waits ~2 ms, a 32-layer plain
    decode step the full 20."""
    longest = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        longest = max(longest, time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int(min(SLEEP_CYCLES, max(MIN_SLEEP_CYCLES, 4 * longest * SLEEP_CYCLES / 0.02)))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _counter_refs() -> dict:
    """Each launch counter by name: (wrapper, attribute). K1, K2, K5 and K6
    count every launch in ``launches`` and their fp32 body's also in
    ``launches_f32`` (K5 its bf16 Hopper body's in ``launches_sm90`` and its
    decode body's in ``launches_decode``; K1's and K2's ``launches_sm90``,
    every bf16 launch, are checked by :func:`counters`); K3 counts by cache
    (bf16, fp32), K4 every int8-cache launch and those with an fp32 query
    also in ``launches_int8_f32``."""
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import flash_attention as fl
    from eilev_tpu_torch.ops import fused_attention as fa
    from eilev_tpu_torch.ops import fused_mlp as fm

    return {
        "packed_qkv_attention": (fa.packed_qkv_attention, "launches"),
        "packed_qkv_attention_f32": (fa.packed_qkv_attention, "launches_f32"),
        "packed_qkv_causal_attention": (fa.packed_qkv_causal_attention, "launches"),
        "packed_qkv_causal_attention_f32": (fa.packed_qkv_causal_attention, "launches_f32"),
        "decode_attention_stacked_bf16": (da.decode_attention_stacked, "launches_bf16"),
        "decode_attention_stacked_f32": (da.decode_attention_stacked, "launches_f32"),
        "decode_attention_stacked_int8": (da.decode_attention_stacked, "launches_int8"),
        "decode_attention_stacked_int8_f32": (da.decode_attention_stacked, "launches_int8_f32"),
        "flash_attention": (fl.flash_attention, "launches"),
        "flash_attention_sm90": (fl.flash_attention, "launches_sm90"),
        "flash_attention_decode": (fl.flash_attention, "launches_decode"),
        "flash_attention_f32": (fl.flash_attention, "launches_f32"),
        "ln_mlp": (fm.ln_mlp, "launches"),
        "ln_mlp_f32": (fm.ln_mlp, "launches_f32"),
    }


def _packed_wrappers() -> dict:
    from eilev_tpu_torch.ops import fused_attention as fa

    return {"packed_qkv_attention": fa.packed_qkv_attention,
            "packed_qkv_causal_attention": fa.packed_qkv_causal_attention}


def counters() -> dict:
    """Every kernel body's launch counter, by name. Checks that every bf16
    K1 and K2 launch since the last reset took a Hopper body (wgmma + TMA):
    each wrapper's launches_sm90 is its launches less its fp32 body's."""
    counts = {name: getattr(fn, attr) for name, (fn, attr) in _counter_refs().items()}
    for name, fn in _packed_wrappers().items():
        assert fn.launches_sm90 == counts[name] - counts[f"{name}_f32"], (
            f"{name}: {fn.launches_sm90} Hopper-body launches of {counts[name] - counts[name + '_f32']} in bf16")
    return counts


def reset_counters() -> None:
    for fn, attr in _counter_refs().values():
        setattr(fn, attr, 0)
    for fn in _packed_wrappers().values():
        fn.launches_sm90 = 0


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper replaced by its plain twin where the models look it
    up, so that a model on the card runs the plain path: the yardstick the
    fp32 paths' tokens are held to."""
    from eilev_tpu_torch.models import llama, opt
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import flash_attention as fl
    from eilev_tpu_torch.ops import fused_attention as fa

    def k1(qkv, nh, hd, *, scale=None):
        return fa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5 if scale is None else scale)

    def k2(qkv, nh, hd, padding_mask, *, scale=None):
        return fa.packed_qkv_causal_attention_reference(qkv, nh, hd, padding_mask,
                                                        hd**-0.5 if scale is None else scale)

    swaps = [(fa, "packed_qkv_attention", k1), (opt, "packed_qkv_causal_attention", k2),
             (opt, "decode_attention_stacked", da.decode_attention_stacked_reference),
             (llama, "decode_attention_stacked", da.decode_attention_stacked_reference),
             (fl, "flash_attention", fl.flash_attention_reference)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def build_kernels(tag: str, sources: tuple = ("packed_attention", "decode_attention", "flash_attention",
                                               "fused_mlp", "attention_f32")) -> None:
    from eilev_tpu_torch.ops import _build

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    libs = {f"{src}.cu": getattr(_build, f"{src}_lib") for src in sources}
    # K6's registers, shared memory and spills, once (a tree from before
    # ptxas_report has none to give)
    report = getattr(_build, "ptxas_report", None) if "fused_mlp" in sources else None
    with ThreadPoolExecutor(max_workers=len(libs) + 1) as pool:  # nvcc runs outside the GIL
        futures = {src: pool.submit(timed, fn) for src, fn in libs.items()}
        ptxas = pool.submit(report, "fused_mlp.cu") if report else None
        for src, fut in futures.items():
            print(f"[{tag}] built eilev_tpu_torch/csrc/{src} in {fut.result()} s")
        if ptxas is not None:
            for line in ptxas.result().splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"[{tag}] fused_mlp.cu nvcc -Xptxas -v: {line.strip()}")


def bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over the peak for their type (bf16 tensor cores; fp32 on the CUDA cores,
    or fp32-accurate as 3xTF32 on the tensor cores) and the bytes over the
    memory rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_close(tag: str, label: str, out, ref, tol: float) -> float:
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    print(f"[{tag}] {label} max_abs_err={err}")
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    return err


def _sdpa(q, k, v, **kw):
    """One PyTorch call of the same function: torch's fused attention on
    (B, H, S, D) views. The yardstick only; the port never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)


K5_BODY_NAMES = {"sm90": "Hopper", "decode": "decode", "mma": "mma.sync", "f32": "fp32"}


def k5_counted(body: str, call, label: str = ""):
    """One K5 call, synchronised; the launch counters must say it ran
    ``body`` (ops.flash_attention.k5_body's name) and no other body."""
    from eilev_tpu_torch.ops import flash_attention as fl

    names = ("launches", "launches_sm90", "launches_decode", "launches_f32")
    before = [getattr(fl.flash_attention, c) for c in names]
    out = call()
    torch.cuda.synchronize()
    after = [getattr(fl.flash_attention, c) for c in names]
    want = [before[0] + 1, before[1] + (body == "sm90"), before[2] + (body == "decode"), before[3] + (body == "f32")]
    assert after == want, f"K5 {label}: counters {after}, expected {want} for the {body} body"
    return out


def padded_bias(nh: int, s: int, l: int, dev, g, dtype=torch.bfloat16, std: float = 2.0):
    """An (nh, s, l) bias as the T5 module builds it (models/t5.py:
    compute_bias): the [..., :l] view of an (nh, s, l rounded up to 8)
    buffer in the model dtype."""
    buf = torch.randn(nh, s, -(-l // 8) * 8, device=dev, generator=g) * std
    return buf.to(dtype)[:, :, :l]


def _k5_inputs(dev, g, b, s, l, nh, hd, real=None, tail_empty=False):
    """q (b, s, nh, hd), k/v (b, l, nh, hd) bf16 and the (b, l) keep-mask of a
    left-padded prompt of ``real[i]`` tokens in slots [s - real[i], s), with
    the cache tail (slots >= s) empty when ``tail_empty``."""
    q = torch.randn(b, s, nh, hd, device=dev, generator=g).to(torch.bfloat16)
    k = torch.randn(b, l, nh, hd, device=dev, generator=g).to(torch.bfloat16)
    v = torch.randn(b, l, nh, hd, device=dev, generator=g).to(torch.bfloat16)
    mask = torch.ones(b, l, dtype=torch.int32, device=dev)
    if tail_empty:
        mask[:, s:] = 0
    for i, n in enumerate(real or ()):
        mask[i, : s - n] = 0
    return q, k, v, mask


def _k5_causal_work(real, s, nh, hd, l, elem=2):
    """Operations and bytes a causal prefill of left-padded rows needs: row i
    of a prompt of n real tokens attends its n_i <= n real keys at or before
    it; every q/out element (``elem`` bytes) is read/written once, every real
    k/v row once, the int32 mask once."""
    flops = sum(4 * nh * hd * n * (n + 1) // 2 for n in real)
    nbytes = 2 * len(real) * s * nh * hd * elem + 2 * sum(real) * nh * hd * elem + len(real) * l * 4
    return flops, nbytes


def _decode_case(dev, g, da, shape, dtype=torch.bfloat16) -> SimpleNamespace:
    """A stacked model-dtype cache of DECODE_SHAPES[shape] (or
    BEAM_DECODE_SHAPES[shape] or SPEC_DECODE_SHAPES[shape], or the dims
    tuple ``shape`` itself), its int8 copy (quantize_kv), a query and the
    mid-decode keep-mask (slots past the filled ones empty)."""
    n_layers, b, s, filled, nh, hd, scale_query = shape if isinstance(shape, tuple) else {
        **DECODE_SHAPES, **BEAM_DECODE_SHAPES, **SPEC_DECODE_SHAPES, **TP_DECODE_SHAPES}[shape]
    q = torch.randn(b, nh * hd, device=dev, generator=g).to(dtype)
    k5 = torch.randn(n_layers, b, s, nh, hd, device=dev, generator=g).to(dtype)
    v5 = torch.randn(n_layers, b, s, nh, hd, device=dev, generator=g).to(dtype)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[:, filled:] = 0
    k8, ks = da.quantize_kv(k5)
    v8, vs = da.quantize_kv(v5)
    kw = dict(num_heads=nh, head_dim=hd, scale_query=scale_query)
    flat = lambda x: x.view(n_layers, b, s, nh * hd)  # noqa: E731
    return SimpleNamespace(q=q, k5=k5, v5=v5, kb=flat(k5), vb=flat(v5), k8=flat(k8), v8=flat(v8), ks=ks, vs=vs,
                           mask=mask, kw=kw, i8=dict(k_scale=ks, v_scale=vs, **kw),
                           dims=(n_layers, b, s, filled, nh, hd))


# phase 11 (c)'s captured engine cache as a keep-mask over a seeded fp32
# cache of its geometry (32 layers, 4 rows x 2,048 slots, 32 x 80, q side):
# index 859, row 0 live from slot 2 (773 live, 84 holes), row 1 from 786 (49
# live, 24 holes), rows 2 and 3 empty (what phase 11 (c) captures); for
# --kernel-times, where no engine runs
SERVING_LIKE = (32, 4, 2048, 859, 32, 80, True)
SERVING_LIKE_SEED = 24


def _serving_like_case(dev, g, da) -> SimpleNamespace:
    c = _decode_case(dev, g, da, SERVING_LIKE, dtype=torch.float32)
    c.mask.zero_()
    c.mask[0, 2:859] = 1
    c.mask[0, 7 + 10 * torch.arange(84, device=dev)] = 0
    c.mask[1, 786:859] = 1
    c.mask[1, 787 + 3 * torch.arange(24, device=dev)] = 0
    return c


def _k3_step(da, c, plain: bool = False):
    """One decode step of K3 (or its twin): a launch per layer of the cache."""
    fn = da.decode_attention_stacked_reference if plain else da.decode_attention_stacked
    return lambda: [fn(c.q, c.kb, c.vb, c.mask, i, **c.kw) for i in range(c.dims[0])]


def _k4_step(da, c, plain: bool = False):
    fn = da.decode_attention_stacked_reference if plain else da.decode_attention_stacked
    return lambda: [fn(c.q, c.k8, c.v8, c.mask, i, **c.i8) for i in range(c.dims[0])]


def _decode_bound(c, int8: bool) -> tuple[float, str]:
    """Bound of one decode-attention launch: 4 flops per filled slot and head
    dim (at the peak of the model dtype); K and V rows of the filled slots
    (the model dtype, or int8 + a bf16 scale each), q, out and the mask, each
    moved once."""
    _, b, s, filled, nh, hd = c.dims
    elem = c.q.element_size()
    io = 2 * b * nh * hd * elem + b * s * 4
    row = hd + 2 if int8 else elem * hd
    peak = H100_F32_FLOPS if elem == 4 else H100_BF16_FLOPS
    return bound(4 * b * nh * filled * hd, 2 * b * filled * nh * row + io, peak)


def _k6_work(m: int, d: int, f: int, elem: int = 2) -> tuple[float, float]:
    """Operations and bytes of one LN -> MLP call: two products of 2 M D F
    each; x, out and both weights in the model dtype (``elem`` bytes), the
    four vectors in fp32."""
    return 4 * m * d * f, 2 * m * d * elem + 2 * d * f * elem + (3 * d + f) * 4


def _k6_args(dev, b: int, s: int, d: int, f: int, dtype=torch.bfloat16) -> list:
    """K6's inputs at the scale a trained layer keeps, from K6_SEED: x N(0,
    1), LayerNorm scale 1 + N(0, 0.1), weights N(0, 1 / fan_in), biases N(0,
    0.1), so every activation is of unit scale and atol = rtol = 2e-2 (bf16,
    the JAX kernel test's bar) or F32_TOL bites on every output."""
    g = torch.Generator(device=dev).manual_seed(K6_SEED)
    return [(torch.randn(*shape, device=dev, generator=g) * std + mean).to(dtype)
            for shape, std, mean in (((b, s, d), 1.0, 0.0), ((d,), 0.1, 1.0), ((d,), 0.1, 0.0),
                                     ((d, f), d**-0.5, 0.0), ((f,), 0.1, 0.0), ((f, d), f**-0.5, 0.0),
                                     ((d,), 0.1, 0.0))]


def _k6_composite(args: list, eps: float = 1e-6):
    """What the ViT runs in K6's place, on K6's inputs: the port's own
    layer_norm2 and mlp modules (MixedLayerNorm, then VisionMLP's fc1, gelu,
    fc2) holding K6's weights, in the inputs' dtype. No kernel of the port
    runs; the time is the kernels line's composite_ms, the yardstick for K6
    where no single PyTorch call computes LayerNorm -> MLP."""
    from eilev_tpu_torch.configs import VisionConfig
    from eilev_tpu_torch.models.mixed_precision import MixedLayerNorm
    from eilev_tpu_torch.models.vision import VisionMLP

    x, ln_s, ln_b, w1, b1, w2, b2 = args
    d, f = w1.shape
    ln = MixedLayerNorm(d, eps=eps, device=x.device, dtype=x.dtype)
    mlp = VisionMLP(VisionConfig(hidden_size=d, intermediate_size=f), device=x.device, dtype=x.dtype)
    with torch.no_grad():
        for param, value in ((ln.weight, ln_s), (ln.bias, ln_b), (mlp.fc1.weight, w1.T), (mlp.fc1.bias, b1),
                             (mlp.fc2.weight, w2.T), (mlp.fc2.bias, b2)):
            param.copy_(value)

    def run():
        with torch.inference_mode():
            return mlp(ln(x))
    return run


def check_kernels(tag: str, dev: torch.device) -> list[dict]:
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import flash_attention as fl
    from eilev_tpu_torch.ops import fused_attention as fa
    from eilev_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator(device=dev).manual_seed(0)
    results = []

    b, s, nh, hd = 136, 257, 16, 88
    k1_qkv = torch.randn(b, s, 3 * nh * hd, device=dev, generator=g).to(torch.bfloat16)
    # closures bind their shapes and tensors now: the names are reused below
    k1 = lambda nh=nh, hd=hd: fa.packed_qkv_attention(k1_qkv, nh, hd)  # noqa: E731
    k1_plain = lambda nh=nh, hd=hd: fa.packed_qkv_attention_reference(k1_qkv, nh, hd, hd**-0.5)  # noqa: E731
    k1_q, k1_k, k1_v = k1_qkv.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
    assert fa.packed_body(k1_qkv, causal=False) == "sm90_rows"
    err = check_close(tag, "K1 packed_qkv_attention (136,257,16x88)", k1(), k1_plain(), 2e-2)
    results.append({"name": "packed_qkv_attention", "body": "sm90_rows (wgmma + TMA, whole rows in registers)",
                    "source": "eilev_tpu_torch/csrc/packed_attention.cu",
                    "replaces": "eilev_tpu/ops/fused_attention.py:81",
                    "max_abs_err": err, "run": k1, "plain": k1_plain, "per_call": 1,
                    "library": lambda hd=hd: _sdpa(k1_q, k1_k, k1_v, scale=hd**-0.5),
                    "bound": bound(4 * b * nh * s * s * hd, 4 * b * s * nh * hd * 2)})
    # K1 past its whole-row limit (K1_MAX_SEQ = 384): the two-pass body with
    # no causal frontier; 577 is a 336^2 ViT (24^2 patches + CLS)
    for s_long in (385, 577, 1025):
        qkv = torch.randn(2, s_long, 3 * nh * hd, device=dev, generator=g).to(torch.bfloat16)
        assert fa.packed_body(qkv, causal=False) == "sm90"
        check_close(tag, f"K1 packed_qkv_attention (2,{s_long},{nh}x{hd}) past K1_MAX_SEQ, the two-pass body",
                    fa.packed_qkv_attention(qkv, nh, hd), fa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5),
                    2e-2)
    del qkv
    check_two_pass(tag, dev, g)

    b, s, nh, hd = 4, 766, 32, 80
    k2_qkv = torch.randn(b, s, 3 * nh * hd, device=dev, generator=g).to(torch.bfloat16)
    ones = torch.ones(b, s, dtype=torch.int32, device=dev)
    right = ones.clone()
    right[1, 600:] = 0
    right[3, 700:] = 0
    errs = []
    for name, mask in (("all-ones", ones), ("right-padded", right)):
        errs.append(check_close(
            tag, f"K2 packed_qkv_causal_attention (4,766,32x80) {name} mask",
            fa.packed_qkv_causal_attention(k2_qkv, nh, hd, mask),
            fa.packed_qkv_causal_attention_reference(k2_qkv, nh, hd, mask, hd**-0.5), 2e-2))
    k2 = lambda nh=nh, hd=hd: fa.packed_qkv_causal_attention(k2_qkv, nh, hd, ones)  # noqa: E731
    k2_plain = lambda nh=nh, hd=hd: fa.packed_qkv_causal_attention_reference(  # noqa: E731
        k2_qkv, nh, hd, ones, hd**-0.5)
    k2_q, k2_k, k2_v = k2_qkv.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
    results.append({"name": "packed_qkv_causal_attention", "body": "sm90 (wgmma + TMA, two passes)",
                    "source": "eilev_tpu_torch/csrc/packed_attention.cu",
                    "replaces": "eilev_tpu/ops/fused_attention.py:187",
                    "max_abs_err": max(errs), "run": k2, "plain": k2_plain, "per_call": 1,
                    "library": lambda hd=hd: _sdpa(k2_q, k2_k, k2_v, is_causal=True, scale=hd**-0.5),
                    "bound": bound(4 * b * nh * hd * s * (s + 1) // 2, 4 * b * s * nh * hd * 2 + b * s * 4)})

    # K3 / K4 at the decode shapes, each a 32-layer cache: layer 17 against
    # the twin with the full and the mid-decode mask (K4 against
    # dequantize_kv + the twin), then, but for the narration's batch 1, timed
    # as one decode step's 32 launches
    decode_extra = []
    for shape in DECODE_SHAPES:
        c = _decode_case(dev, g, da, shape)
        n_layers, b, s, filled, nh, hd = c.dims
        full = torch.ones_like(c.mask)
        label = f"({n_layers},{b},{s} with {filled} filled,{nh}x{hd}) layer 17"
        body = (f"the split, a cluster of {da.cluster_size(b, nh, s)}" if da.k3_split(b, nh, s)
                else "one block a (head, row)")
        print(f"[{tag}] K3 bf16 {shape}: the body rule k3_split(B={b}, H={nh}, S={s}) picks {body}")
        dead = c.mask.clone()
        dead[-1] = 0
        errs = [check_close(
            tag, f"K3 decode_attention_stacked bf16 {shape} {label} {name} mask",
            da.decode_attention_stacked(c.q, c.kb, c.vb, mask, 17, **c.kw),
            da.decode_attention_stacked_reference(c.q, c.kb, c.vb, mask, 17, **c.kw), 2e-2)
            for name, mask in (("full", full), ("mid-decode", c.mask))]
        # a fully masked row: -inf max, so NaN, in kernel and twin alike
        out = da.decode_attention_stacked(c.q, c.kb, c.vb, dead, 17, **c.kw)
        ref = da.decode_attention_stacked_reference(c.q, c.kb, c.vb, dead, 17, **c.kw)
        torch.cuda.synchronize()
        assert bool(torch.isnan(out[-1]).all()) and bool(torch.isnan(ref[-1]).all()), "K3 masked row not NaN"
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2, equal_nan=True)
        print(f"[{tag}] K3 bf16 {shape} fully masked row: NaN in kernel and twin")
        if shape == "narration":
            gq = torch.randn(4, 32 * 128, device=dev, generator=g).to(torch.bfloat16)
            gk = torch.randn(2, 4, 2048, 8 * 128, device=dev, generator=g).to(torch.bfloat16)
            gv = torch.randn(2, 4, 2048, 8 * 128, device=dev, generator=g).to(torch.bfloat16)
            gkw = dict(num_heads=32, head_dim=128, kv_heads=8, scale_query=False)
            gm = full.new_ones(4, 2048)
            errs.append(check_close(
                tag, "K3 decode_attention_stacked bf16 GQA (2,4,2048,32 over 8 x128) score-side scale",
                da.decode_attention_stacked(gq, gk, gv, gm, 1, **gkw),
                da.decode_attention_stacked_reference(gq, gk, gv, gm, 1, **gkw), 2e-2))
            del gq, gk, gv
        # torch's fused attention on (B, H, S, D) views of each layer of the cache
        sd_q = c.q.view(b, nh, 1, hd)
        sd_mask = c.mask.bool()[:, None, None, :]
        k3_lib = lambda c=c, sd_q=sd_q, sd_mask=sd_mask, hd=hd: [  # noqa: E731
            _sdpa(sd_q, c.k5[i].transpose(1, 2), c.v5[i].transpose(1, 2), attn_mask=sd_mask, scale=hd**-0.5)
            for i in range(c.dims[0])]
        k3_row = {"name": "decode_attention_stacked_bf16", "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                  "replaces": "eilev_tpu/ops/decode_attention.py:117",
                  "max_abs_err": max(errs), "run": _k3_step(da, c), "plain": _k3_step(da, c, plain=True),
                  "per_call": n_layers, "library": k3_lib, "bound": _decode_bound(c, int8=False)}

        ref = da.decode_attention_stacked_reference(
            c.q, da.dequantize_kv(c.k8[17:18].view(1, b, s, nh, hd), c.ks[17:18]).view(1, b, s, nh * hd),
            da.dequantize_kv(c.v8[17:18].view(1, b, s, nh, hd), c.vs[17:18]).view(1, b, s, nh * hd),
            c.mask, 0, **c.kw)
        errs = [check_close(tag, f"K4 decode_attention_stacked int8 {shape} {label} mid-decode mask"
                            f" (a cluster of {da.cluster_size(b, nh, s)}) vs dequantize_kv + twin",
                            da.decode_attention_stacked(c.q, c.k8, c.v8, c.mask, 17, **c.i8), ref,
                            K4_TOL if shape == "narration" else K4_TIGHT_TOL)]
        k4_row = {"name": "decode_attention_stacked_int8", "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                  "replaces": "eilev_tpu/ops/decode_attention.py:75",
                  "max_abs_err": max(errs), "run": _k4_step(da, c), "plain": _k4_step(da, c, plain=True),
                  "per_call": n_layers,
                  "library": None,  # no single PyTorch call dequantizes and attends
                  "bound": _decode_bound(c, int8=True)}
        if shape == "narration":
            # a fully masked row: -inf max, so NaN, in kernel and twin alike
            out = da.decode_attention_stacked(c.q, c.k8, c.v8, dead, 17, **c.i8)
            ref = da.decode_attention_stacked_reference(c.q, c.k8, c.v8, dead, 17, **c.i8)
            torch.cuda.synchronize()
            assert bool(torch.isnan(out[-1]).all()) and bool(torch.isnan(ref[-1]).all()), "K4 masked row not NaN"
            torch.testing.assert_close(out, ref, atol=K4_TIGHT_TOL, rtol=K4_TIGHT_TOL, equal_nan=True)
            print(f"[{tag}] K4 int8 {shape} fully masked row: NaN in kernel and twin")
            results += [k3_row, k4_row]
        elif shape == "text-LM":
            decode_extra += [dict(k3_row, name=f"{k3_row['name']} at the text-LM shape"),
                             dict(k4_row, name=f"{k4_row['name']} at the text-LM shape")]
        else:  # the narration's batch 1: K3's time printed, K4's by --kernel-times
            decode_extra.append(dict(k3_row, name=f"{k3_row['name']} at the narration's batch 1"))
        del c, k3_row, k4_row, k3_lib, dead, out, ref
    # K4 with fewer slots than a cluster's 32-slot chunks: S = 1 and 5, B = 1,
    # the text LM's heads (32 x 128, score-side scale)
    for s_small in (1, 5):
        q = torch.randn(1, 32 * 128, device=dev, generator=g).to(torch.bfloat16)
        k8, ks = da.quantize_kv(torch.randn(2, 1, s_small, 32, 128, device=dev, generator=g).to(torch.bfloat16))
        v8, vs = da.quantize_kv(torch.randn(2, 1, s_small, 32, 128, device=dev, generator=g).to(torch.bfloat16))
        keep1 = torch.ones(1, s_small, dtype=torch.int32, device=dev)
        kw = dict(num_heads=32, head_dim=128, scale_query=False)
        ref = da.decode_attention_stacked_reference(
            q, da.dequantize_kv(k8, ks).view(2, 1, s_small, -1), da.dequantize_kv(v8, vs).view(2, 1, s_small, -1),
            keep1, 1, **kw)
        check_close(tag, f"K4 decode_attention_stacked int8 (2,1,{s_small},32x128) S < 32 vs dequantize_kv + twin",
                    da.decode_attention_stacked(q, k8.view(2, 1, s_small, -1), v8.view(2, 1, s_small, -1), keep1, 1,
                                                k_scale=ks, v_scale=vs, **kw), ref, K4_TIGHT_TOL)
    del ref

    # K5. Tolerance 2e-2 as for K1-K3: kernel and twin run the same recurrence
    # over the same 128-key blocks, so they differ only in fp32 summation order
    # and exp's last bits, which can move one bf16 rounding of an un-normalised
    # p (a relative 2^-8) and no more.
    errs = []

    def k5_case(label, q, k, v, kw5, body, padded=()):
        """One K5 call against the twin (2e-2); the body the counters say ran
        must be ``body`` (k5_body's name); the first ``padded[i]`` query rows
        of batch row i are wholly left-padded and must be exactly 0."""
        assert fl.k5_body(q, k, v, kw5.get("bias")) == body, (label, body)
        out = k5_counted(body, lambda: fl.flash_attention(q, k, v, **kw5), label)
        for i, n in enumerate(padded):
            assert bool((out[i, :n] == 0).all()), f"K5 {label}: a left-padded row is not exactly 0"
        errs.append(check_close(tag, f"K5 {label} ({K5_BODY_NAMES[body]} body)",
                                out, fl.flash_attention_reference(q, k, v, **kw5), 2e-2))

    for b_a, real in ((1, (LLAMA_PROMPT,)), (4, LLAMA_REAL)):
        # (a) the LLaMA prefill: S = 1984 into a 2048-slot cache, 32 x 128,
        # causal, score-side scale, the cache mask (empty tail, left padding)
        q, k, v, mask = _k5_inputs(dev, g, b_a, LLAMA_PROMPT, LLAMA_CACHE, 32, 128, real, tail_empty=True)
        k5_case(f"(a) LLaMA prefill B={b_a} S=1984 L=2048 32x128 causal real={real}", q, k, v,
                dict(padding_mask=mask, causal=True, scale=128**-0.5), "sm90",
                padded=[LLAMA_PROMPT - n for n in real])
    del q, k, v
    # (b) the T5 form with an fp32 (H, S, L) bias: hd 64, a padding mask, no
    # scale (the mma.sync body, which reads the bias through its strides)
    q, k, v, mask = _k5_inputs(dev, g, 2, 1024, 1024, 32, 64)
    mask[1, 900:] = 0
    bias = torch.randn(32, 1024, 1024, device=dev, generator=g) * 2.0
    k5_case("(b) T5 form B=2 S=L=1024 32x64 fp32 bias + padding, no scale", q, k, v,
            dict(padding_mask=mask, bias=bias), "mma")
    # (b') the same with the bias in bf16 padded rows, as the T5 module
    # builds it (the Hopper body, the bias tiles by TMA)
    bias = padded_bias(32, 1024, 1024, dev, g)
    k5_case("(b') T5 form B=2 S=L=1024 32x64 bf16 padded-row bias + padding, no scale", q, k, v,
            dict(padding_mask=mask, bias=bias), "sm90")
    del bias
    # (c) the Q-Former cross attention: 32 queries over 8 x 257 keys, 12 x 64
    q, k, v, mask = _k5_inputs(dev, g, 17, 32, 2056, 12, 64)
    mask[::3, 1800:] = 0
    k5_case("(c) Q-Former cross B=17 q=32 kv=2056 12x64 padded keys", q, k, v,
            dict(padding_mask=mask, scale=64**-0.5), "sm90")
    # (d) hd 88 at S = L = 257, no mask (the ViT shape)
    q, k, v, _ = _k5_inputs(dev, g, 136, 257, 257, 16, 88)
    k5_case("(d) ViT B=136 S=L=257 16x88 no mask", q, k, v, dict(scale=88**-0.5), "mma")
    # (e) q-side scale, hd 80, causal with q_offset > 0
    q, k, v, _ = _k5_inputs(dev, g, 4, 256, 1022, 32, 80)
    k5_case("(e) q-side scale B=4 S=256 L=1022 q_offset=766 32x80 causal", q, k, v,
            dict(causal=True, q_offset=766, scale=80**-0.5, scale_query_first=True), "mma")
    # (f) 300 queries into 320 slots, row 0 left-padded by 150: its key tile
    # 0 is wholly masked, which the Hopper body skips
    q, k, v, mask = _k5_inputs(dev, g, 2, 300, 320, 32, 128, (150, 300), tail_empty=True)
    k5_case("(f) B=2 S=300 L=320 32x128 causal, row 0 left-padded by 150", q, k, v,
            dict(padding_mask=mask, causal=True, scale=128**-0.5), "sm90", padded=(150,))
    # (g) one query over 766 keys, GQA 32 over 8 at hd 128, score-side
    # scale, a fp32 bias, row 0 with no kept key (exactly 0): the decode body
    q, k, v, mask = _k5_inputs(dev, g, 4, 1, 766, 32, 128)
    k, v = k[:, :, :8].contiguous(), v[:, :, :8].contiguous()
    mask[0] = 0
    mask[2, 400:] = 0
    k5_case("(g) decode B=4 S=1 L=766 32 over 8 x128, fp32 bias, row 0 keeps no key", q, k, v,
            dict(padding_mask=mask, bias=torch.randn(32, 1, 766, device=dev, generator=g), scale=128**-0.5),
            "decode", padded=(1,))

    # timed at (a), batch 1; batch 4 is printed beside it
    timed = {}
    for b_a, real in ((1, (LLAMA_PROMPT,)), (4, LLAMA_REAL)):
        q, k, v, mask = _k5_inputs(dev, g, b_a, LLAMA_PROMPT, LLAMA_CACHE, 32, 128, real, tail_empty=True)
        kw5 = dict(padding_mask=mask, causal=True, scale=128**-0.5)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if b_a == 1:
            # upper-left causal alignment masks the empty tail too: the same function
            lib = (lambda qt=qt, kt=kt, vt=vt: _sdpa(qt, kt, vt, is_causal=True, scale=128**-0.5))
        else:
            keep = mask.bool()[:, None, None, :] & torch.ones(
                LLAMA_PROMPT, LLAMA_CACHE, dtype=torch.bool, device=dev).tril()
            lib = (lambda qt=qt, kt=kt, vt=vt, keep=keep: _sdpa(qt, kt, vt, attn_mask=keep, scale=128**-0.5))
        timed[b_a] = {
            "run": (lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention(q, k, v, **kw5)),
            "plain": (lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention_reference(q, k, v, **kw5)),
            "library": lib, "per_call": 1,
            "bound": bound(*_k5_causal_work(real, LLAMA_PROMPT, 32, 128, LLAMA_CACHE)),
        }
    results.append({"name": "flash_attention", "body": "Hopper", "source": "eilev_tpu_torch/csrc/flash_attention.cu",
                    "replaces": "eilev_tpu/ops/flash_attention.py:157",
                    "max_abs_err": max(errs), **timed[1]})
    results_b4 = {"name": "flash_attention at batch 4", "max_abs_err": max(errs), **timed[4]}

    # K6 at the ViT MLP shape: the frames of one narration request x 257
    # tokens, 1408 -> 6144 -> 1408, with activations of unit scale
    b, s, d, f = 136, 257, 1408, 6144
    k6_args = _k6_args(dev, b, s, d, f)
    k6 = lambda: fm.ln_mlp(*k6_args)  # noqa: E731
    k6_plain = lambda: fm.ln_mlp_reference(*k6_args)  # noqa: E731
    err = check_close(tag, "K6 ln_mlp (136,257,1408 -> 6144) unit-scale activations", k6(), k6_plain(), 2e-2)
    results.append({"name": "ln_mlp", "source": "eilev_tpu_torch/csrc/fused_mlp.cu",
                    "replaces": "eilev_tpu/ops/fused_mlp.py:101",
                    "max_abs_err": err, "run": k6, "plain": k6_plain, "per_call": 1,
                    "library": None,  # no single PyTorch call computes LayerNorm -> MLP
                    "composite": _k6_composite(k6_args),
                    "bound": bound(*_k6_work(b * s, d, f))})

    # the v5e-chosen auto thresholds (q >= 1024, kv >= 2048) on this card: K5
    # against the plain path a LLaMA prefill takes below them, batch 1, 32 x 128
    from eilev_tpu_torch.ops.attention import plain_attention

    for s_q, l_kv in ((LLAMA_PROMPT, LLAMA_CACHE), (1000, 1064), (500, 564), (100, 164)):
        q, k, v, mask = _k5_inputs(dev, g, 1, s_q, l_kv, 32, 128, tail_empty=True)
        kw5 = dict(padding_mask=mask, causal=True, scale=128**-0.5)
        plain = lambda q=q, k=k, v=v, kw5=kw5: plain_attention(q, k, v, softmax_in_fp32=True, **kw5)  # noqa: E731
        flash = lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention(q, k, v, **kw5)  # noqa: E731
        times = [median_ms(f) for f in (plain, flash, flash, plain)]
        print(f"[{tag}] auto threshold probe q={s_q} kv={l_kv} 32x128 causal: plain_path_ms={times[0]},{times[3]} "
              f"K5_ms={times[1]},{times[2]}")
    del q, k, v, mask

    f32_rows, f32_extra = check_f32_kernels(tag, dev, g)
    results += f32_rows
    for r in results + [results_b4] + decode_extra + f32_extra:
        time_row(tag, r)
    return results


def time_row(tag: str, r: dict, reps: int = 10) -> None:
    """Time one kernel row in turns, plain first: plain, kernel, kernel,
    plain, then the library call twice (each the median of ``reps``), and
    fill in its times and bound. The closures are dropped after, so the test
    caches are freed before the main path's peak memory is read."""
    n, run, plain, lib = r.pop("per_call"), r.pop("run"), r.pop("plain"), r.pop("library")
    p1 = median_ms(plain, reps) / n
    k_a = median_ms(run, reps) / n
    k_b = median_ms(run, reps) / n
    p2 = median_ms(plain, reps) / n
    r["ms"], r["plain_ms"] = min(k_a, k_b), min(p1, p2)
    r["library_ms"] = None if lib is None else min(median_ms(lib, reps), median_ms(lib, reps)) / n
    composite = r.pop("composite", None)
    if composite is not None:  # K6: the modules it stands in for, not one call
        r["composite_ms"] = min(median_ms(composite), median_ms(composite))
        r["composite"] = K6_COMPOSITE
    r["bound_ms"], r["bound_by"] = r.pop("bound")
    print(f"[{tag}] {r['name']} kernel_ms={k_a},{k_b} plain_ms={p1},{p2} library_ms={r['library_ms']} "
          + (f"composite_ms={r['composite_ms']} " if composite is not None else "")
          + f"bound_ms={r['bound_ms']} ({r['bound_by']}) of_bound={100 * r['bound_ms'] / r['ms']}% "
          f"max_abs_err={r['max_abs_err']} (per launch)")


def check_beam_decode(tag: str, dev: torch.device) -> list[dict]:
    """Phase 2c: K3 and K4 at the beam decode shapes (BEAM_DECODE_SHAPES: 5
    and 20 cache rows of 798 slots, 780 filled, 32 x 80; 4 rows of 2,048
    slots, 2,040 filled, 32 x 128), layer 17 of a 32-layer cache: K3 against
    the twin at 2e-2 with the full and the mid-decode mask and NaN in a fully
    masked row, K4 against dequantize_kv + the twin at 2e-3 (3e-2 at 20 rows,
    the JAX int8 kernel test's bar), each timed as one decode step's 32
    launches against the twin, SDPA (K3) and the bound. Returns the rows."""
    from eilev_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for shape in BEAM_DECODE_SHAPES:
        c = _decode_case(dev, g, da, shape)
        n_layers, b, s, filled, nh, hd = c.dims
        label = f"({n_layers},{b},{s} with {filled} filled,{nh}x{hd}) layer 17"
        body = (f"the split, a cluster of {da.cluster_size(b, nh, s)}" if da.k3_split(b, nh, s)
                else "one block a (head, row)")
        print(f"[{tag}] K3 bf16 {shape}: the body rule k3_split(B={b}, H={nh}, S={s}) picks {body}")
        full = torch.ones_like(c.mask)
        errs = [check_close(
            tag, f"K3 decode_attention_stacked bf16 {shape} {label} {name} mask",
            da.decode_attention_stacked(c.q, c.kb, c.vb, mask, 17, **c.kw),
            da.decode_attention_stacked_reference(c.q, c.kb, c.vb, mask, 17, **c.kw), 2e-2)
            for name, mask in (("full", full), ("mid-decode", c.mask))]
        dead = c.mask.clone()
        dead[-1] = 0
        out = da.decode_attention_stacked(c.q, c.kb, c.vb, dead, 17, **c.kw)
        ref = da.decode_attention_stacked_reference(c.q, c.kb, c.vb, dead, 17, **c.kw)
        torch.cuda.synchronize()
        assert bool(torch.isnan(out[-1]).all()) and bool(torch.isnan(ref[-1]).all()), "K3 masked row not NaN"
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2, equal_nan=True)
        ref = da.decode_attention_stacked_reference(
            c.q, da.dequantize_kv(c.k8[17:18].view(1, b, s, nh, hd), c.ks[17:18]).view(1, b, s, nh * hd),
            da.dequantize_kv(c.v8[17:18].view(1, b, s, nh, hd), c.vs[17:18]).view(1, b, s, nh * hd),
            c.mask, 0, **c.kw)
        err4 = check_close(tag, f"K4 decode_attention_stacked int8 {shape} {label} mid-decode mask"
                           f" (a cluster of {da.cluster_size(b, nh, s)}) vs dequantize_kv + twin",
                           da.decode_attention_stacked(c.q, c.k8, c.v8, c.mask, 17, **c.i8), ref,
                           K4_TOL if b >= 20 else K4_TIGHT_TOL)
        sd_q = c.q.view(b, nh, 1, hd)
        sd_mask = c.mask.bool()[:, None, None, :]
        k3_lib = lambda c=c, sd_q=sd_q, sd_mask=sd_mask, hd=hd: [  # noqa: E731
            _sdpa(sd_q, c.k5[i].transpose(1, 2), c.v5[i].transpose(1, 2), attn_mask=sd_mask, scale=hd**-0.5)
            for i in range(c.dims[0])]
        pair = [{"name": f"decode_attention_stacked_bf16 at {shape}", "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "eilev_tpu/ops/decode_attention.py:117", "max_abs_err": max(errs),
                 "run": _k3_step(da, c), "plain": _k3_step(da, c, plain=True), "per_call": n_layers,
                 "library": k3_lib, "bound": _decode_bound(c, int8=False)},
                {"name": f"decode_attention_stacked_int8 at {shape}", "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "eilev_tpu/ops/decode_attention.py:75", "max_abs_err": err4,
                 "run": _k4_step(da, c), "plain": _k4_step(da, c, plain=True), "per_call": n_layers,
                 "library": None, "bound": _decode_bound(c, int8=True)}]
        for r in pair:
            time_row(tag, r)
        rows += pair
        del c, pair, k3_lib, dead, out, ref
        torch.cuda.empty_cache()
    return rows


def check_decoding_mode_shapes(tag: str, dev: torch.device) -> list[dict]:
    """Phase 2d: the kernel shapes the decoding modes reach, each against its
    twin at 2e-2 (bf16) and timed against the twin, SDPA and its bound. K3
    over SPEC_DECODE_SHAPES (the narration's speculative caches of 804 slots,
    the target's 32 layers and the 4-layer draft's, at batch 1 and 4; the
    text LM's 4-layer draft cache of 2,054 slots, 32 x 128, score-side
    scale) at the first, a middle and the last layer, full and mid-decode
    masks, and NaN in a fully masked row; K5 at B = 1, the 1,984-token
    prompt into SPEC_K5_SLOTS (2,054 and 2,058 slots: a partial last
    128-key tile), causal with the cache's empty tail, on its Hopper body.
    Returns the rows."""
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for shape in SPEC_DECODE_SHAPES:
        c = _decode_case(dev, g, da, shape)
        n_layers, b, s, filled, nh, hd = c.dims
        body = (f"the split, a cluster of {da.cluster_size(b, nh, s)}" if da.k3_split(b, nh, s)
                else "one block a (head, row)")
        print(f"[{tag}] K3 bf16 {shape}: the body rule k3_split(B={b}, H={nh}, S={s}) picks {body}")
        errs = []
        for layer in sorted({0, n_layers // 2, n_layers - 1}):
            for name, mask in (("full", torch.ones_like(c.mask)), ("mid-decode", c.mask)):
                errs.append(check_close(
                    tag, f"K3 decode_attention_stacked bf16 {shape} ({n_layers},{b},{s} with {filled} filled,"
                    f"{nh}x{hd}) layer {layer} {name} mask",
                    da.decode_attention_stacked(c.q, c.kb, c.vb, mask, layer, **c.kw),
                    da.decode_attention_stacked_reference(c.q, c.kb, c.vb, mask, layer, **c.kw), 2e-2))
        dead = c.mask.clone()
        dead[-1] = 0
        out = da.decode_attention_stacked(c.q, c.kb, c.vb, dead, n_layers - 1, **c.kw)
        ref = da.decode_attention_stacked_reference(c.q, c.kb, c.vb, dead, n_layers - 1, **c.kw)
        torch.cuda.synchronize()
        assert bool(torch.isnan(out[-1]).all()) and bool(torch.isnan(ref[-1]).all()), "K3 masked row not NaN"
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2, equal_nan=True)
        sd_q = c.q.view(b, nh, 1, hd)
        sd_mask = c.mask.bool()[:, None, None, :]
        scale = hd**-0.5
        lib = lambda c=c, sd_q=sd_q, sd_mask=sd_mask, scale=scale: [  # noqa: E731
            _sdpa(sd_q, c.k5[i].transpose(1, 2), c.v5[i].transpose(1, 2), attn_mask=sd_mask, scale=scale)
            for i in range(c.dims[0])]
        r = {"name": f"decode_attention_stacked_bf16 at {shape}", "source": "eilev_tpu_torch/csrc/decode_attention.cu",
             "replaces": "eilev_tpu/ops/decode_attention.py:117", "max_abs_err": max(errs),
             "run": _k3_step(da, c), "plain": _k3_step(da, c, plain=True), "per_call": n_layers,
             "library": lib, "bound": _decode_bound(c, int8=False)}
        time_row(tag, r)
        rows.append(r)
        del c, r, lib, dead, out, ref
        torch.cuda.empty_cache()
    for slots in SPEC_K5_SLOTS:
        q, k, v, mask = _k5_inputs(dev, g, 1, LLAMA_PROMPT, slots, 32, 128, (LLAMA_PROMPT,), tail_empty=True)
        kw5 = dict(padding_mask=mask, causal=True, scale=128**-0.5)
        before = fl.flash_attention.launches_sm90
        out = fl.flash_attention(q, k, v, **kw5)
        torch.cuda.synchronize()
        assert fl.flash_attention.launches_sm90 == before + 1, f"K5 at {slots} slots did not take the Hopper body"
        err = check_close(tag, f"K5 speculative prefill B=1 S={LLAMA_PROMPT} L={slots} 32x128 causal, empty tail "
                          f"(Hopper body; {slots % 128} keys in the last 128-key tile)",
                          out, fl.flash_attention_reference(q, k, v, **kw5), 2e-2)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        r = {"name": f"flash_attention at {slots} slots", "source": "eilev_tpu_torch/csrc/flash_attention.cu",
             "replaces": "eilev_tpu/ops/flash_attention.py:157", "max_abs_err": err, "per_call": 1,
             "run": (lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention(q, k, v, **kw5)),
             "plain": (lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention_reference(q, k, v, **kw5)),
             # upper-left causal alignment masks the empty tail too: the same function
             "library": (lambda qt=qt, kt=kt, vt=vt: _sdpa(qt, kt, vt, is_causal=True, scale=128**-0.5)),
             "bound": bound(*_k5_causal_work((LLAMA_PROMPT,), LLAMA_PROMPT, 32, 128, slots))}
        time_row(tag, r)
        rows.append(r)
        del q, k, v, out, r
        torch.cuda.empty_cache()
    return rows


def _t5_k5_case(dev, g, name: str, dtype):
    """q, k, v and K5's arguments at T5_K5_SHAPES[name]: the (H, S, L) bias in
    the model dtype and layout (as the T5 module builds it: padded rows), the
    decoder's k/v as a layer slice of a stacked cache and its filled-slot
    mask expanded to (B, L), the cross k/v as a layer slice of the stacked
    encoder K/V; the last row of a batch of 4 padded from key 700 (encoder)
    or 500 (cross). Returns (q, k, v, kwargs, real keys a row)."""
    b, s, l = T5_K5_SHAPES[name]
    nh, hd = 32, 64
    q = torch.randn(b, s, nh, hd, device=dev, generator=g).to(dtype)
    mask = torch.ones(b, l, dtype=torch.int32, device=dev)
    bias = None
    if "encoder" in name:
        k = torch.randn(b, l, nh, hd, device=dev, generator=g).to(dtype)
        v = torch.randn(b, l, nh, hd, device=dev, generator=g).to(dtype)
        bias = padded_bias(nh, s, l, dev, g, dtype)
        if b > 1:
            mask[-1, 700:] = 0
    else:
        kv = torch.randn(2, b, l, nh, hd, device=dev, generator=g).to(dtype)
        k, v = kv[0], kv[1]
        if "self" in name:
            bias = padded_bias(nh, s, l, dev, g, dtype)
            mask = (torch.arange(l, device=dev) < T5_DECODE_FILLED).to(torch.int32)[None].expand(b, l)
        else:
            mask[-1, 500:] = 0
    return q, k, v, dict(padding_mask=mask, bias=bias), mask.sum(dim=1).tolist()


def _k5_bias_row(name: str, q, k, v, kw5: dict, err: float, bnd: tuple) -> dict:
    """A kernels-line row of K5 with T5's relative bias, for time_row: K5,
    its twin, and one SDPA call with the bias and the padding mask folded
    into one float attn_mask of the inputs' dtype (scale 1)."""
    from eilev_tpu_torch.ops import flash_attention as fl

    fold = torch.where(kw5["padding_mask"].bool(), 0.0, -torch.inf)[:, None, None, :]
    if kw5["bias"] is not None:
        fold = fold + kw5["bias"].float()[None]
    fold = fold.to(q.dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return {
        "name": name,
        "source": f"eilev_tpu_torch/csrc/{'attention_f32' if q.dtype == torch.float32 else 'flash_attention'}.cu",
        "replaces": "eilev_tpu/ops/flash_attention.py:157", "max_abs_err": err, "per_call": 1,
        "run": (lambda: fl.flash_attention(q, k, v, **kw5)),
        "plain": (lambda: fl.flash_attention_reference(q, k, v, **kw5)),
        "library": (lambda: _sdpa(qt, kt, vt, attn_mask=fold, scale=1.0)),
        "bound": bnd,
    }


def check_t5_shapes(tag: str, dev: torch.device) -> list[dict]:
    """Phase 2e: K5 at the T5 path's forms (T5_K5_SHAPES), bf16 (the encoder
    on the Hopper body with its bias tiles, the one-query steps on the decode
    body) and fp32 (attention_f32.cu's body, TF32 off), and at the Q-Former's
    self and cross attentions (QFORMER_K5_SHAPES, bf16, the Hopper body):
    each against its twin at 2e-2 and F32_TOL, the body by counter, then
    timed as in 3 beside one SDPA call (the bias and the mask folded into one
    float attn_mask, scale 1; the Q-Former's with its scale) and beside its
    bound: q, k, v, out in the model dtype, the bias in the dtype the kernel
    reads (the bf16 rows' bound with the bias counted as fp32, the count the
    parent's wrapper handed its kernel, printed beside it), the mask's int32,
    each once; only the real keys' k/v and products counted. Then the T5
    module's bias build at the encoder (compute_bias, once a forward) timed
    alone."""
    from eilev_tpu_torch.models.t5 import T5Attention
    from eilev_tpu_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(14)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        for name in T5_K5_SHAPES:
            q, k, v, kw5, real = _t5_k5_case(dev, g, name, dtype)
            body = "f32" if f32 else "sm90" if "encoder" in name else "decode"
            out = k5_counted(body, lambda: fl.flash_attention(q, k, v, **kw5), name)
            shape = None if kw5["bias"] is None else tuple(kw5["bias"].shape)
            err = check_close(tag, f"K5 {name}{' fp32' if f32 else ''} (32x64, bias {shape}, "
                                   f"{K5_BODY_NAMES[body]} body)",
                              out, fl.flash_attention_reference(q, k, v, **kw5), F32_TOL if f32 else 2e-2)
            b, s, l = T5_K5_SHAPES[name]
            elem = 4 if f32 else 2
            nbytes = (2 * b * s + 2 * sum(real)) * 32 * 64 * elem + b * l * 4
            flops, peak = 4 * s * sum(real) * 32 * 64, H100_TF32X3_FLOPS if f32 else H100_BF16_FLOPS
            bias_bytes = 0 if kw5["bias"] is None else 32 * s * l
            row = _k5_bias_row(f"flash_attention{'_f32' if f32 else ''} at {name}", q, k, v, kw5, err,
                               bound(flops, nbytes + bias_bytes * elem, peak))
            row["body"] = K5_BODY_NAMES[body]
            if bias_bytes and not f32:
                row["bound_ms_fp32_bias"] = bound(flops, nbytes + bias_bytes * 4, peak)[0]
            rows.append(row)
    for name, (b, s, l) in QFORMER_K5_SHAPES.items():
        q = torch.randn(b, s, 12, 64, device=dev, generator=g).to(torch.bfloat16)
        k, v = (torch.randn(b, l, 12, 64, device=dev, generator=g).to(torch.bfloat16) for _ in range(2))
        out = k5_counted("sm90", lambda: fl.flash_attention(q, k, v, scale=0.125), name)
        err = check_close(tag, f"K5 {name} (12x64, no mask, Hopper body)", out,
                          fl.flash_attention_reference(q, k, v, scale=0.125), 2e-2)
        row = _videomae_k5_row(f"flash_attention at {name}", q, k, v, err,
                               bound(4 * b * 12 * s * l * 64, 2 * (b * s + b * l) * 12 * 64 * 2))
        row["body"] = "Hopper"
        rows.append(row)
    # the T5 module's bias at the encoder, built once a forward in bf16
    # padded rows (flan-t5-xl's 32 heads, 766 tokens)
    att = T5Attention(t5_config().text_config, has_relative_attention_bias=True, device=dev, dtype=torch.bfloat16)
    build_ms = min(median_ms(lambda: att.compute_bias(766, 766, dtype=torch.bfloat16, device=dev)) for _ in range(2))
    print(f"[{tag}] the T5 module's relative bias at the encoder, (32, 766, 766) bf16 into padded rows, built once "
          f"a forward: ms={build_ms}")
    del att
    for r in rows:
        time_row(tag, r)
    return rows


def check_two_pass(tag: str, dev: torch.device, g) -> None:
    """K1 and K2 at long S on the bf16 two-pass body (which takes any S): K2
    at (1, 4,096, 32x80), causal, row 0 left-padded by TWO_PASS_PAD keys, and
    K1 at (1, 3,072, 16x88), each against its twin at atol = rtol = 2e-2 with
    the fully masked rows NaN in both; then timed like the other kernels (in
    turns plain, kernel, kernel, plain; one SDPA call with the same mask and
    scale) beside its bound. Its launches come from this check only: no path
    of the port reaches S > 2,048 (OPT's positions end there, every ViT is
    257). Prints one JSON line."""
    from eilev_tpu_torch.ops import fused_attention as fa

    rows = []
    for name, causal, (b, s, nh, hd) in (("packed_qkv_causal_attention", True, (1, 4096, 32, 80)),
                                         ("packed_qkv_attention", False, (1, 3072, 16, 88))):
        qkv = torch.randn(b, s, 3 * nh * hd, device=dev, generator=g).to(torch.bfloat16)
        assert fa.packed_body(qkv, causal) == "sm90"
        q, k, v = qkv.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        if causal:
            mask = torch.ones(b, s, dtype=torch.int32, device=dev)
            mask[0, :TWO_PASS_PAD] = 0
            keep = mask.bool()[:, None, None, :] & torch.ones(s, s, dtype=torch.bool, device=dev).tril()
            run = lambda qkv=qkv, mask=mask, nh=nh, hd=hd: fa.packed_qkv_causal_attention(qkv, nh, hd, mask)  # noqa: E731
            plain = lambda qkv=qkv, mask=mask, nh=nh, hd=hd: fa.packed_qkv_causal_attention_reference(  # noqa: E731
                qkv, nh, hd, mask, hd**-0.5)
            lib = lambda q=q, k=k, v=v, keep=keep, hd=hd: _sdpa(q, k, v, attn_mask=keep, scale=hd**-0.5)  # noqa: E731
            work = _k5_causal_work((s - TWO_PASS_PAD,), s, nh, hd, s)
            label = f"K2 two-pass ({b},{s},{nh}x{hd}) causal, row 0 left-padded by {TWO_PASS_PAD}"
        else:
            run = lambda qkv=qkv, nh=nh, hd=hd: fa.packed_qkv_attention(qkv, nh, hd)  # noqa: E731
            plain = lambda qkv=qkv, nh=nh, hd=hd: fa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5)  # noqa: E731
            lib = lambda q=q, k=k, v=v, hd=hd: _sdpa(q, k, v, scale=hd**-0.5)  # noqa: E731
            work = (4 * b * nh * s * s * hd, 4 * b * s * nh * hd * 2)
            label = f"K1 two-pass ({b},{s},{nh}x{hd})"
        fn = getattr(fa, name)
        before = fn.launches_sm90
        out, ref = run(), plain()
        torch.cuda.synchronize()
        nan_out, nan_ref = torch.isnan(out).any(-1), torch.isnan(ref).any(-1)
        print(f"[{tag}] {label}: NaN rows kernel={int(nan_out.sum())} twin={int(nan_ref.sum())}")
        assert torch.equal(nan_out, nan_ref) and int(nan_ref.sum()) == (TWO_PASS_PAD if causal else 0)
        err = (out.float() - ref.float())[~nan_ref].abs().max().item()
        print(f"[{tag}] {label} max_abs_err={err} (rows that are not NaN)")
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2, equal_nan=True)
        launches = fn.launches_sm90 - before
        del out, ref
        p1, k_a, k_b, p2 = (median_ms(f) for f in (plain, run, run, plain))
        library = min(median_ms(lib), median_ms(lib))
        bound_ms, bound_by = bound(*work)
        rows.append({"name": f"{name} two-pass body", "shape": [b, s, nh, hd], "causal": causal,
                     "max_abs_err": err, "ms": min(k_a, k_b), "plain_ms": min(p1, p2), "library_ms": library,
                     "bound_ms": bound_ms, "bound_by": bound_by, "launches_sm90": launches})
        print(f"[{tag}] {label} kernel_ms={k_a},{k_b} plain_ms={p1},{p2} library_ms={library} "
              f"bound_ms={bound_ms} ({bound_by}) launches_sm90={launches} (this check only: no path "
              f"reaches S > 2,048)")
        del qkv, q, k, v, run, plain, lib
    print(json.dumps({"two_pass": rows, "card": tag,
                      "launches_note": "from this check only: no path of the port reaches S > 2,048"}))
    torch.cuda.empty_cache()


def check_f32_kernels(tag: str, dev: torch.device, g) -> tuple[list, list]:
    """The fp32 bodies (an fp32 model) against their twins on the card, TF32
    off, atol = rtol = F32_TOL; fully masked rows: the uniform average of
    every V row for K2/K3/K4 (finfo(float32).min is finite), exactly 0 for
    K5. The fp32 attention body (K1, K2, K5: csrc/attention_f32.cu) is held
    at its check shapes, at the full-path shapes (K1 at the fp32 ViT's 136
    frames, K2 at the narration's batch 1 and 4, K5 (a) at batch 4
    left-padded) and at the edges of its tiling (D = 100; grouped-query heads
    with a bias and q_offset > 0; k and v only 4-byte aligned; fully masked
    rows in both modes), each call counted in its wrapper's launches_f32;
    the fp32 decode body (K3, K4) at every decode shape and at the edges of
    its lanes (D = 64 and 128 over grouped-query heads, both scale sides, a
    layer > 0, holes and a fully masked row). Returns the rows of the
    kernels line (timed at K1's, K2's, the narration
    decode at batch 1, which phase 8 runs, K5 (a) and K6's shapes) and extra
    timed rows (the other decode shapes, the full-path shapes)."""
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import flash_attention as fl
    from eilev_tpu_torch.ops import fused_attention as fa
    from eilev_tpu_torch.ops import fused_mlp as fm

    rows, extra = [], []
    f32 = torch.float32

    def row(name, source, replaces, err, run, plain, library, roofline, per_call=1):
        return {"name": name, "source": f"eilev_tpu_torch/csrc/{source}", "replaces": replaces,
                "max_abs_err": err, "run": run, "plain": plain, "per_call": per_call, "library": library,
                "bound": roofline}

    def attn_bound(label, flops, nbytes):
        """The bound of an fp32 body that runs 3xTF32 (the attention body and
        K6): its operations on the tensor cores (H100_TF32X3_FLOPS), its
        bytes at HBM's rate; the bound at the CUDA-core fp32 peak is printed
        beside it, for rows read against that peak."""
        new, old = bound(flops, nbytes, H100_TF32X3_FLOPS), bound(flops, nbytes, H100_F32_FLOPS)
        print(f"[{tag}] {label}: bound_ms={new[0]} ({new[1]}; 3xTF32 at 495/3 TFLOP/s); at the fp32 "
              f"CUDA-core peak (67 TFLOP/s) {old[0]} ({old[1]})")
        return new

    def counted(fn, call):
        """``call()``, which must launch ``fn``'s fp32 body exactly once."""
        before = fn.launches_f32
        out = call()
        assert fn.launches_f32 == before + 1, f"launches_f32 rose by {fn.launches_f32 - before}, not 1"
        return out

    def sdpa_route(label, lib):
        """The kernels one fp32 SDPA call runs (the yardstick's route), by a
        torch.profiler trace of one call."""
        from torch.profiler import ProfilerActivity, profile

        lib()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lib()
            torch.cuda.synchronize()
        kernels = [(e.key, getattr(e, "device_time_total", 0)) for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0) > 0]
        print(f"[{tag}] fp32 SDPA route at {label}: {kernels or 'no device events in the trace'}")

    # K1 (no mask, score-side scale): the check shape and the fp32 ViT's at
    # narration batch 1 (136 frames)
    for b in (2, 136):
        s, nh, hd = 257, 16, 88
        qkv = torch.randn(b, s, 3 * nh * hd, device=dev, generator=g)
        q_, k_, v_ = qkv.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        label = f"K1 fp32 ({b},{s},{nh}x{hd})"
        k1 = lambda nh=nh, hd=hd, qkv=qkv: fa.packed_qkv_attention(qkv, nh, hd)  # noqa: E731
        k1_plain = lambda nh=nh, hd=hd, qkv=qkv: fa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5)  # noqa: E731
        k1_lib = lambda hd=hd, q_=q_, k_=k_, v_=v_: _sdpa(q_, k_, v_, scale=hd**-0.5)  # noqa: E731
        err = check_close(tag, label, counted(fa.packed_qkv_attention, k1), k1_plain(), F32_TOL)
        r = row("packed_qkv_attention_f32", "attention_f32.cu", "eilev_tpu/ops/fused_attention.py:81", err,
                k1, k1_plain, k1_lib, attn_bound(label, 4 * b * nh * s * s * hd, 4 * b * s * nh * hd * 4))
        if b == 2:
            sdpa_route(label, k1_lib)
            rows.append(r)
        else:
            extra.append(dict(r, name=f"packed_qkv_attention_f32 at {label}"))
        del qkv, q_, k_, v_, r

    # K2 (causal, (B, S) padding, q-side scale): the check shape with
    # all-ones and left- and right-padded masks, then the narration's batch 1
    # and 4, unpadded as the narration's prompts are
    for b in (2, 1, 4):
        s, nh, hd = 766, 32, 80
        qkv = torch.randn(b, s, 3 * nh * hd, device=dev, generator=g)
        ones = torch.ones(b, s, dtype=torch.int32, device=dev)
        label = f"K2 fp32 ({b},{s},{nh}x{hd})"
        masks = [("all-ones", ones)]
        if b == 2:
            padded = ones.clone()
            padded[0, :150] = 0  # left: query rows 0-149 of row 0 see no kept key
            padded[1, 600:] = 0  # right
            masks.append(("left- and right-padded", padded))
        errs = [check_close(tag, f"{label} {name} mask",
                            counted(fa.packed_qkv_causal_attention,
                                    lambda m=m: fa.packed_qkv_causal_attention(qkv, nh, hd, m)),
                            fa.packed_qkv_causal_attention_reference(qkv, nh, hd, m, hd**-0.5), F32_TOL)
                for name, m in masks]
        if b == 2:
            out = fa.packed_qkv_causal_attention(qkv, nh, hd, padded)
            v_mean = qkv.view(b, s, 3, nh * hd)[0, :, 2].mean(0)
            torch.testing.assert_close(out[0, :150], v_mean.expand(150, -1), atol=F32_TOL, rtol=F32_TOL)
            print(f"[{tag}] K2 fp32 fully masked rows (uniform = 1): the uniform average of every V row")
            del out, padded
        q_, k_, v_ = qkv.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        k2 = lambda nh=nh, hd=hd, qkv=qkv, m=ones: fa.packed_qkv_causal_attention(qkv, nh, hd, m)  # noqa: E731
        k2_plain = lambda nh=nh, hd=hd, qkv=qkv, m=ones: fa.packed_qkv_causal_attention_reference(  # noqa: E731
            qkv, nh, hd, m, hd**-0.5)
        k2_lib = lambda hd=hd, q_=q_, k_=k_, v_=v_: _sdpa(q_, k_, v_, is_causal=True, scale=hd**-0.5)  # noqa: E731
        r = row("packed_qkv_causal_attention_f32", "attention_f32.cu", "eilev_tpu/ops/fused_attention.py:187",
                max(errs), k2, k2_plain, k2_lib,
                attn_bound(label, 4 * b * nh * hd * s * (s + 1) // 2, 4 * b * s * nh * hd * 4 + b * s * 4))
        if b == 2:
            sdpa_route(label, k2_lib)
            rows.append(r)
        else:
            extra.append(dict(r, name=f"packed_qkv_causal_attention_f32 at {label}"))
        del qkv, q_, k_, v_, r

    # K3 / K4 with an fp32 model at every decode shape
    for shape in DECODE_SHAPES:
        c = _decode_case(dev, g, da, shape, dtype=f32)
        n_layers, b, s, filled, nh, hd = c.dims
        dead = c.mask.clone()
        dead[-1] = 0
        label = f"({n_layers},{b},{s} with {filled} filled,{nh}x{hd}) layer 17"
        errs = [check_close(tag, f"K3 fp32 {shape} {label} {name} mask",
                            da.decode_attention_stacked(c.q, c.kb, c.vb, m, 17, **c.kw),
                            da.decode_attention_stacked_reference(c.q, c.kb, c.vb, m, 17, **c.kw), F32_TOL)
                for name, m in (("mid-decode", c.mask), ("fully masked row", dead))]
        out = da.decode_attention_stacked(c.q, c.kb, c.vb, dead, 17, **c.kw)
        torch.testing.assert_close(out[-1], c.vb[17, -1].mean(0), atol=F32_TOL, rtol=F32_TOL)
        errs8 = [check_close(tag, f"K4 fp32 query {shape} {label} {name} mask",
                             da.decode_attention_stacked(c.q, c.k8, c.v8, m, 17, **c.i8),
                             da.decode_attention_stacked_reference(c.q, c.k8, c.v8, m, 17, **c.i8), F32_TOL)
                 for name, m in (("mid-decode", c.mask), ("fully masked row", dead))]
        print(f"[{tag}] K3/K4 fp32 {shape} fully masked row: the uniform average of every V row")
        sd_q = c.q.view(b, nh, 1, hd)
        sd_mask = c.mask.bool()[:, None, None, :]
        lib = lambda c=c, sd_q=sd_q, sd_mask=sd_mask, hd=hd: [  # noqa: E731
            _sdpa(sd_q, c.k5[i].transpose(1, 2), c.v5[i].transpose(1, 2), attn_mask=sd_mask, scale=hd**-0.5)
            for i in range(c.dims[0])]
        k3 = row("decode_attention_stacked_f32", "decode_attention.cu", "eilev_tpu/ops/decode_attention.py:117",
                 max(errs), _k3_step(da, c), _k3_step(da, c, plain=True), lib, _decode_bound(c, int8=False),
                 per_call=n_layers)
        k4 = row("decode_attention_stacked_int8_f32", "decode_attention.cu", "eilev_tpu/ops/decode_attention.py:75",
                 max(errs8), _k4_step(da, c), _k4_step(da, c, plain=True), None, _decode_bound(c, int8=True),
                 per_call=n_layers)
        if shape == "narration batch 1":  # the shape of phase 8's fp32 narration decode
            rows += [k3, k4]
        else:
            extra += [dict(k3, name=f"{k3['name']} at the {shape} shape"),
                      dict(k4, name=f"{k4['name']} at the {shape} shape")]
        del c, out, lib, k3, k4

    # the fp32 decode body at the edges of its lanes: D = 64 and 128 over
    # grouped-query heads (32 over 8), q side and score side, S a multiple of
    # neither the cluster nor 32, a layer > 0, every third slot masked and the
    # last row fully masked (the uniform average of every V row); K3 and K4,
    # each call counted once, from a generator of their own
    k34, ge = da.decode_attention_stacked, torch.Generator(device=dev).manual_seed(SERVING_LIKE_SEED)
    for n_layers, b, s, hd, sq, layer in ((3, 2, 1001, 64, True, 2), (2, 2, 2047, 128, False, 1)):
        nh, kvh = 32, 8
        k, v = (torch.randn(n_layers, b, s, kvh, hd, device=dev, generator=ge) for _ in range(2))
        q = torch.randn(b, nh * hd, device=dev, generator=ge)
        m = torch.ones(b, s, dtype=torch.int32, device=dev)
        m[:, ::3] = 0
        m[-1] = 0
        kw = dict(num_heads=nh, head_dim=hd, kv_heads=kvh, scale_query=sq)
        k8, ks = da.quantize_kv(k)
        v8, vs = da.quantize_kv(v)
        flat = lambda x: x.reshape(n_layers, b, s, kvh * hd)  # noqa: E731
        for name, args, scales, v_rows, counter in (
                ("K3", (flat(k), flat(v)), {}, v, "launches_f32"),
                ("K4", (flat(k8), flat(v8)), dict(k_scale=ks, v_scale=vs), da.dequantize_kv(v8, vs, f32),
                 "launches_int8_f32")):
            before = getattr(k34, counter)
            out = k34(q, *args, m, layer, **kw, **scales)
            assert getattr(k34, counter) == before + 1, f"{counter} rose by {getattr(k34, counter) - before}, not 1"
            check_close(tag, f"{name} fp32 GQA (32 over 8 x {hd}, {'q' if sq else 'score'} side) S={s} layer {layer}, "
                        f"every third slot masked and a fully masked row", out,
                        da.decode_attention_stacked_reference(q, *args, m, layer, **kw, **scales), F32_TOL)
            want = v_rows[layer, -1].mean(0).repeat_interleave(nh // kvh, dim=0).reshape(-1)
            torch.testing.assert_close(out[-1], want, atol=F32_TOL, rtol=F32_TOL)
        del k, v, q, k8, v8, ks, vs, out
    print(f"[{tag}] K3/K4 fp32 at D = 64 and 128 over grouped-query heads: fully masked rows the uniform average")

    # K5 with an fp32 model: (f) 300 queries into 320 slots with row 0
    # left-padded by 150, whose rows are exactly 0; (a) the LLaMA prefill at
    # B = 1 (the kernels line's row) and at B = 4 left-padded (timed beside
    # it)
    errs = []
    q, k, v, mask = _k5_inputs(dev, g, 2, 300, 320, 32, 128, (150, 300), tail_empty=True)
    q, k, v = q.float(), k.float(), v.float()
    kw5 = dict(padding_mask=mask, causal=True, scale=128**-0.5)
    out = counted(fl.flash_attention, lambda: fl.flash_attention(q, k, v, **kw5))
    torch.cuda.synchronize()
    assert bool((out[0, :150] == 0).all()), "K5 fp32: a left-padded row is not exactly 0"
    errs.append(check_close(tag, "K5 fp32 (f) B=2 S=300 L=320 32x128 causal, row 0 left-padded by 150",
                            out, fl.flash_attention_reference(q, k, v, **kw5), F32_TOL))
    for b_a, real in ((1, (LLAMA_PROMPT,)), (4, LLAMA_REAL)):
        q, k, v, mask = _k5_inputs(dev, g, b_a, LLAMA_PROMPT, LLAMA_CACHE, 32, 128, real, tail_empty=True)
        q, k, v = q.float(), k.float(), v.float()
        kw5 = dict(padding_mask=mask, causal=True, scale=128**-0.5)
        label = f"K5 fp32 (a) LLaMA prefill B={b_a} S={LLAMA_PROMPT} L={LLAMA_CACHE} 32x128 causal real={real}"
        out = counted(fl.flash_attention, lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention(q, k, v, **kw5))
        torch.cuda.synchronize()
        for i, n in enumerate(real):
            assert bool((out[i, : LLAMA_PROMPT - n] == 0).all()), "K5 fp32: a left-padded row is not exactly 0"
        err = check_close(tag, label, out, fl.flash_attention_reference(q, k, v, **kw5), F32_TOL)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        if b_a == 1:
            # upper-left causal alignment masks the empty tail too: the same function
            k5_lib = lambda qt=qt, kt=kt, vt=vt: _sdpa(qt, kt, vt, is_causal=True, scale=128**-0.5)  # noqa: E731
        else:
            keep = mask.bool()[:, None, None, :] & torch.ones(
                LLAMA_PROMPT, LLAMA_CACHE, dtype=torch.bool, device=dev).tril()
            k5_lib = lambda qt=qt, kt=kt, vt=vt, keep=keep: _sdpa(qt, kt, vt, attn_mask=keep,  # noqa: E731
                                                                   scale=128**-0.5)
        r = row("flash_attention_f32", "attention_f32.cu", "eilev_tpu/ops/flash_attention.py:157",
                max(errs + [err]), lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention(q, k, v, **kw5),
                lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention_reference(q, k, v, **kw5), k5_lib,
                attn_bound(label, *_k5_causal_work(real, LLAMA_PROMPT, 32, 128, LLAMA_CACHE, elem=4)))
        if b_a == 1:
            sdpa_route(label, k5_lib)
            rows.append(r)
        else:
            extra.append(dict(r, name="flash_attention_f32 at batch 4"))
        del out, r

    # the edges of the fp32 attention body's tiling, each through the K5
    # wrapper (uniform = 0) and counted: (i) D = 100, a multiple of no 8-wide
    # chunk, S = L = 257 (ragged 16-row and 8-key edges), no mask; (ii) 8
    # query heads over 2 kv heads, an (H, S, L) bias, q_offset = 130 with a
    # q-side scale, causal, batch row 0 left-padded so its query rows 0-9
    # see no kept key (exactly 0); (iii) q, k, v as views of a packed QKV of
    # 3 heads x 33: rows of 297 floats, k and v only 4-byte aligned, so the
    # K/V tiles take 4-byte copies; causal with 30 left-padded keys
    q, k, v, _ = _k5_inputs(dev, g, 2, 257, 257, 4, 100)
    q, k, v = q.float(), k.float(), v.float()
    check_close(tag, "K5 fp32 edge (i) D=100 B=2 S=L=257 4 heads, no mask",
                counted(fl.flash_attention, lambda: fl.flash_attention(q, k, v, scale=100**-0.5)),
                fl.flash_attention_reference(q, k, v, scale=100**-0.5), F32_TOL)
    q = torch.randn(2, 70, 8, 80, device=dev, generator=g)
    k, v = (torch.randn(2, 200, 2, 80, device=dev, generator=g) for _ in range(2))
    mask = torch.ones(2, 200, dtype=torch.int32, device=dev)
    mask[0, :140] = 0
    kw5 = dict(padding_mask=mask, bias=torch.randn(8, 70, 200, device=dev, generator=g) * 2.0, causal=True,
               q_offset=130, scale=80**-0.5, scale_query_first=True)
    out = counted(fl.flash_attention, lambda: fl.flash_attention(q, k, v, **kw5))
    torch.cuda.synchronize()
    assert bool((out[0, :10] == 0).all()), "K5 fp32 edge (ii): a fully masked row is not exactly 0"
    check_close(tag, "K5 fp32 edge (ii) GQA 8 over 2, (H,S,L) bias, q_offset 130, q-side scale, "
                "10 fully masked rows (exactly 0)", out, fl.flash_attention_reference(q, k, v, **kw5), F32_TOL)
    qkv = torch.randn(2, 100, 3 * 3 * 33, device=dev, generator=g)
    q, k, v = qkv.view(2, 100, 3, 3, 33).unbind(2)
    assert k.data_ptr() % 16 and v.data_ptr() % 16, "edge (iii) wants k and v off 16-byte alignment"
    mask = torch.ones(2, 100, dtype=torch.int32, device=dev)
    mask[0, :30] = 0
    kw5 = dict(padding_mask=mask, causal=True, scale=33**-0.5)
    out = counted(fl.flash_attention, lambda: fl.flash_attention(q, k, v, **kw5))
    torch.cuda.synchronize()
    assert bool((out[0, :30] == 0).all()), "K5 fp32 edge (iii): a fully masked row is not exactly 0"
    check_close(tag, f"K5 fp32 edge (iii) packed QKV 3x33, k at {k.data_ptr() % 16} bytes past 16, causal, "
                "30 left-padded keys", out, fl.flash_attention_reference(q, k, v, **kw5), F32_TOL)
    del q, k, v, qkv, out, mask, kw5

    # K6 with an fp32 model, unit-scale inputs: 8 frames of the ViT MLP shape
    # (the kernels line's row) and the fp32 ViT's 136 (narration batch 1,
    # phase 8's shape). Bound: both products as 3xTF32 on the tensor cores
    # (H100_TF32X3_FLOPS), the CUDA-core one printed beside it
    for b in (8, 136):
        s, d, f = 257, 1408, 6144
        args = _k6_args(dev, b, s, d, f, f32)
        k6 = lambda args=args: fm.ln_mlp(*args)  # noqa: E731
        k6_plain = lambda args=args: fm.ln_mlp_reference(*args)  # noqa: E731
        err = check_close(tag, f"K6 ln_mlp fp32 ({b},{s},{d} -> {f})", counted(fm.ln_mlp, k6), k6_plain(), F32_TOL)
        k6_row = row("ln_mlp_f32" if b == 8 else f"ln_mlp_f32 at ({b}, {s})", "fused_mlp.cu",
                     "eilev_tpu/ops/fused_mlp.py:101", err, k6, k6_plain, None,
                     attn_bound(f"K6 fp32 ({b},{s},{d} -> {f})", *_k6_work(b * s, d, f, elem=4)))
        k6_row["composite"] = _k6_composite(args)
        (rows if b == 8 else extra).append(k6_row)
    return rows, extra


def _k5_form_runs(dev, g, fl) -> dict:
    """K5's bf16 forms for ``--kernel-times``, each a call as the tree's own
    models make it: the T5 encoder (B 1, and 4 with a padded row), the
    decoder's cached self step over 33 slots (13 filled, the mask expanded)
    and its cross step over 766 keys, the engine's self (64 slots, dead
    prefixes) and cross (832) steps, VideoMAE (8, 1,568, 12 x 64) and the
    Q-Former's attentions (QFORMER_K5_SHAPES). The bias is what the tree's
    T5 module hands K5: bf16 in padded rows where the tree reads it in place
    (it has ``k5_body``), else the (S, L, H) gather permuted to (H, S, L),
    which the older wrapper copies to fp32 on every call (inside the timed
    window, as on the path). The encoder's are also timed with a contiguous
    fp32 bias ("kernel alone": the older wrapper copies nothing)."""
    in_place = hasattr(fl, "k5_body")

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=g).to(torch.bfloat16)

    def bias(s, l):
        return padded_bias(32, s, l, dev, g) if in_place else rand(s, l, 32).permute(2, 0, 1)

    runs = {}

    def add(name, q, k, v, **kw5):
        runs[f"K5 {name}"] = ((lambda: fl.flash_attention(q, k, v, **kw5)), 1)

    for b in (1, 4):
        q, k, v = rand(b, 766, 32, 64), rand(b, 766, 32, 64), rand(b, 766, 32, 64)
        mask = torch.ones(b, 766, dtype=torch.int32, device=dev)
        if b > 1:
            mask[-1, 700:] = 0
        add(f"T5 encoder B={b} (the model's bias)", q, k, v, padding_mask=mask, bias=bias(766, 766))
        add(f"T5 encoder B={b} (fp32 contiguous bias, kernel alone)", q, k, v, padding_mask=mask,
            bias=torch.randn(32, 766, 766, device=dev, generator=g))
    for name, l_kv, n_filled, with_bias in (("T5 decoder self B=4 (1 over 33)", 33, T5_DECODE_FILLED, True),
                                            ("T5 cross B=4 (1 over 766)", 766, 766, False),
                                            ("T5 engine self (4, 1, 64)", 64, 48, True),
                                            ("T5 engine cross (4, 1, 832)", 832, 790, False)):
        kv = rand(2, 4, l_kv, 32, 64)
        mask = (torch.arange(l_kv, device=dev) < n_filled).to(torch.int32)[None].expand(4, l_kv)
        if "engine self" in name:
            mask = mask.contiguous()
            for r, start in enumerate((0, 9, 20, 31)):
                mask[r, :start] = 0
        add(name, rand(4, 1, 32, 64), kv[0], kv[1], padding_mask=mask, bias=bias(1, l_kv) if with_bias else None)
    x = [rand(8, 1568, 12, 64) for _ in range(3)]
    add("VideoMAE (8, 1568, 12x64)", *x, scale=0.125)
    for name, (b, s, l) in QFORMER_K5_SHAPES.items():
        add(name, rand(b, s, 12, 64), rand(b, l, 12, 64), rand(b, l, 12, 64), scale=0.125)
    return runs


# K1 and K2 in bf16 at every shape of their PERF.md rows: (B, S, heads) at
# head dim 88 (K1: the ViT at narration b1, the v1 chat's 10 frames, TP = 2's
# local heads and a TP serving feature-cache encode, past the whole-row limit
# at 385, 577 and 1,025, and the long check at 3,072) and (B, S, heads, left
# padding) at head dim 80 (K2: the OPT prefill at b4 and b1, the serving
# admission, TP = 2's prefill and admission, the chat's two prefills, the
# long check at 4,096)
K1_TIMED_SHAPES = ((136, 257, 16), (10, 257, 16), (136, 257, 8), (64, 257, 8), (2, 385, 16), (2, 577, 16),
                   (2, 1025, 16), (1, 3072, 16))
K2_TIMED_SHAPES = ((4, 766, 32, 0), (1, 766, 32, 0), (1, 768, 32, 2), (1, 766, 16, 0), (1, 768, 16, 2),
                   (1, 41, 32, 0), (1, 178, 32, 0), (1, 4096, 32, 100))
# the shapes whose host time a call (the wrapper, the tensor maps and the
# launch; the card kept busy) --kernel-times also prints
ENQUEUE_SHAPES = ("K1 bf16 (136,257,16x88)", "K2 bf16 (1,768,32x80) left-padded by 2", "K2 bf16 (1,41,32x80)")


def _packed_form_runs(dev, g, fa) -> dict:
    """K1 and K2 in bf16 at K1_TIMED_SHAPES and K2_TIMED_SHAPES, for
    ``--kernel-times``; K2's left padding on batch row 0."""
    runs = {}
    for b, s, nh in K1_TIMED_SHAPES:
        qkv = torch.randn(b, s, 3 * nh * 88, device=dev, generator=g).to(torch.bfloat16)
        runs[f"K1 bf16 ({b},{s},{nh}x88)"] = ((lambda qkv=qkv, nh=nh: fa.packed_qkv_attention(qkv, nh, 88)), 1)
    for b, s, nh, pad in K2_TIMED_SHAPES:
        qkv = torch.randn(b, s, 3 * nh * 80, device=dev, generator=g).to(torch.bfloat16)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        mask[0, :pad] = 0
        name = f"K2 bf16 ({b},{s},{nh}x80)" + (f" left-padded by {pad}" if pad else "")
        runs[name] = ((lambda qkv=qkv, nh=nh, mask=mask: fa.packed_qkv_causal_attention(qkv, nh, 80, mask)), 1)
    return runs


def enqueue_us(fn, n: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to return, behind a device
    sleep so that no launch waits on the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return host


def kernel_times(tag: str, dev: torch.device, tree: str) -> None:
    """The A/B timing of ``--kernel-times``: K1 and K2 in bf16 at every shape
    of their PERF.md rows (_packed_form_runs), with the host time of a call
    at ENQUEUE_SHAPES; K3 and K4 at the decode shapes, in bf16 and with an
    fp32 model (and the fp32 ones over SERVING_LIKE),
    K5 at (a), batch 1 and 4, K5's bf16 forms of the T5 path, the T5
    serving engine, VideoMAE and the Q-Former (_k5_form_runs), the fp32
    attention body (K1, K2, K5 with fp32 q, k, v) at its check shapes and
    the full-path ones, and K6 (bf16 at the ViT's 136 frames, fp32 at 8 and
    136), on the eilev_tpu_torch that was imported (the one under
    ``tree``), median of 20 twice each, per launch. No check: the full run
    holds every kernel against its twin."""
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import flash_attention as fl
    from eilev_tpu_torch.ops import fused_attention as fa
    from eilev_tpu_torch.ops import fused_mlp as fm

    g = torch.Generator(device=dev).manual_seed(0)
    runs = {}
    for shape in DECODE_SHAPES:
        c = _decode_case(dev, g, da, shape)
        _, b, s, _, nh, _ = c.dims
        if hasattr(da, "k3_split"):
            print(f"[{tag}] {tree} K3 {shape}: k3_split(B={b}, H={nh}, S={s}) = {da.k3_split(b, nh, s)}")
        runs[f"K3 {shape}"] = (_k3_step(da, c), c.dims[0])
        runs[f"K4 {shape}"] = (_k4_step(da, c), c.dims[0])
    # K3 and K4 with an fp32 model at the decode shapes and over a cache masked
    # as phase 11 (c)'s capture, from a generator of their own
    g32 = torch.Generator(device=dev).manual_seed(SERVING_LIKE_SEED)
    for shape in (*DECODE_SHAPES, "serving-like"):
        c = _serving_like_case(dev, g32, da) if shape == "serving-like" else _decode_case(
            dev, g32, da, shape, dtype=torch.float32)
        _, b, s, _, nh, hd = c.dims
        if hasattr(da, "f32_staged"):
            print(f"[{tag}] {tree} fp32 {shape}: a cluster of {da.cluster_size(b, nh, s)}, f32_staged = "
                  f"{da.f32_staged(b, nh, s, hd, False)} (fp32 cache), {da.f32_staged(b, nh, s, hd, True)} (int8)")
        runs[f"K3 fp32 {shape}"] = (_k3_step(da, c), c.dims[0])
        runs[f"K4 fp32 {shape}"] = (_k4_step(da, c), c.dims[0])
    for b_a, real in ((1, (LLAMA_PROMPT,)), (4, LLAMA_REAL)):
        q, k, v, mask = _k5_inputs(dev, g, b_a, LLAMA_PROMPT, LLAMA_CACHE, 32, 128, real, tail_empty=True)
        kw5 = dict(padding_mask=mask, causal=True, scale=128**-0.5)
        runs[f"K5 B={b_a}"] = ((lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention(q, k, v, **kw5)), 1)
        q, k, v = q.float(), k.float(), v.float()
        runs[f"K5 fp32 (a) B={b_a}"] = ((lambda q=q, k=k, v=v, kw5=kw5: fl.flash_attention(q, k, v, **kw5)), 1)
    runs.update(_k5_form_runs(dev, g, fl))
    runs.update(_packed_form_runs(dev, g, fa))
    for b in (2, 136):
        qkv = torch.randn(b, 257, 3 * 16 * 88, device=dev, generator=g)
        runs[f"K1 fp32 ({b},257,16x88)"] = ((lambda qkv=qkv: fa.packed_qkv_attention(qkv, 16, 88)), 1)
    for b in (2, 1, 4):
        qkv = torch.randn(b, 766, 3 * 32 * 80, device=dev, generator=g)
        ones = torch.ones(b, 766, dtype=torch.int32, device=dev)
        runs[f"K2 fp32 ({b},766,32x80)"] = (
            (lambda qkv=qkv, ones=ones: fa.packed_qkv_causal_attention(qkv, 32, 80, ones)), 1)
    # K6 on phase 2's and 2b's inputs
    for b, dtype in ((136, torch.bfloat16), (8, torch.float32), (136, torch.float32)):
        args = _k6_args(dev, b, 257, 1408, 6144, dtype)
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        runs[f"K6 {name} ({b},257,1408->6144)"] = ((lambda args=args: fm.ln_mlp(*args)), 1)
    times = {}
    for name, (fn, n) in runs.items():
        times[name] = [median_ms(fn) / n, median_ms(fn) / n]
        print(f"[{tag}] {tree} {name} kernel_ms={times[name][0]},{times[name][1]} (per launch)")
    host = {name: enqueue_us(runs[name][0]) for name in ENQUEUE_SHAPES}
    for name, us in host.items():
        print(f"[{tag}] {tree} {name} enqueue_us={us} (host, a call)")
    print(json.dumps({"tree": tree, "card": tag, "times_ms": times, "enqueue_us": host}))


class Variants:
    """Decoding knobs on top of a run's inputs: ``variant`` gives the same
    inputs decoded with other GenerationConfig knobs, the decoding mode's
    arguments ``mode`` (``draft``, ``draft_layers``, ``draft_tokens``,
    ``draft_match_len``; ``chunk_tokens`` streams the request through
    ``generate_stream``) and, for sampling, a generator seeded with ``seed``
    anew for every request."""

    knobs: dict = {}
    mode: dict = {}
    seed = None

    def variant(self, seed=None, mode=None, **knobs):
        run = copy.copy(self)
        run.knobs, run.seed, run.mode = knobs, seed, dict(mode or {})
        return run

    @property
    def rows(self) -> int:
        """Rows a request returns: num_return_sequences a batch row."""
        return self.batch * self.knobs.get("num_return_sequences", 1)

    def generator(self, dev: torch.device):
        return None if self.seed is None else torch.Generator(device=dev).manual_seed(self.seed)


class Narration(Variants):
    """The main path's inputs at one batch size, and the calls that drive it."""

    t5 = False
    pad_token_id, eos_token_id = 1, (NEWLINE,)

    def __init__(self, model, cfg, batch: int, dev: torch.device, dtype=torch.bfloat16,
                 new_tokens: int = MAX_NEW_TOKENS):
        ids, mask, vim = build_prompt(cfg.num_query_tokens, batch, t5=self.t5)
        self.model, self.batch, self.dtype, self.new_tokens = model, batch, dtype, new_tokens
        self.n_videos = batch * (SHOTS + 1)
        self.frames = torch.from_numpy(
            np.random.default_rng(1).integers(0, 256, size=(self.n_videos, 3, FRAMES, 224, 224), dtype=np.uint8)
        ).to(dev)
        self.ids = torch.from_numpy(ids).to(dev)
        self.mask = torch.from_numpy(mask).to(dev)
        self.vim = torch.from_numpy(vim).to(dev)

    def rate(self, p50_s: float, new_tokens: int) -> str:
        return f"videos_per_s={self.n_videos / p50_s}"

    def generate(self):
        """The request's tokens; a streamed request's chunks concatenated
        (on the host, where generate_stream yields them)."""
        from eilev_tpu_torch.generation import GenerationConfig, generate, generate_stream
        from eilev_tpu_torch.ops.preprocess import process_videos

        pixel = process_videos(self.frames, dtype=self.dtype)
        kw = dict(input_ids=self.ids, attention_mask=self.mask, pixel_values=pixel, video_input_mask=self.vim,
                  generator=self.generator(self.ids.device),
                  generation_config=GenerationConfig(max_new_tokens=self.new_tokens, pad_token_id=self.pad_token_id,
                                                     eos_token_id=self.eos_token_id, **self.knobs))
        if "chunk_tokens" in self.mode:
            return torch.cat(list(generate_stream(self.model, chunk_tokens=self.mode["chunk_tokens"], **kw)), 1)
        return generate(self.model, **kw, **self.mode)

    @torch.inference_mode()
    def embeds(self):
        from eilev_tpu_torch.ops.preprocess import process_videos

        return self.model.embed_and_scatter(self.ids, process_videos(self.frames, dtype=self.dtype), self.vim)

    @torch.inference_mode()
    def prefill_logits(self, embeds):
        """(B, S, vocab) logits of the prefill into a fresh cache (K2 path)."""
        from eilev_tpu_torch.models import init_cache

        cache = init_cache(self.model.config.text_config, self.batch, embeds.shape[1] + self.new_tokens,
                           dtype=embeds.dtype, device=embeds.device)
        logits, _ = self.model.lm_forward(embeds, attention_mask=self.mask, cache=cache)
        return logits


def drive(tag: str, label: str, run, lm_calls: list, expect: dict, reps: int, stats: dict = None) -> dict:
    """One counted run (counters at 0 just before, read just after), its checks,
    then ``reps`` timed runs. ``expect`` maps every kernel to its launches per
    request, "lm" meaning one per LM layer and one-token forward, a callable
    its launches given the one-token forwards. ``run`` has ``model``,
    ``batch``, ``rows``, ``generate()`` and ``rate(p50_s, new_tokens)``.
    ``stats``, when given, receives the p50, the peak memory, the one-token
    forwards, the counted run's tokens and its K1/K2 launches on their
    Hopper bodies (``sm90``)."""
    n_lm = getattr(run.model.config.text_config, "num_hidden_layers", None)
    torch.cuda.reset_peak_memory_stats()
    lm_calls.clear()
    reset_counters()
    tokens = run.generate()
    torch.cuda.synchronize()
    counts = counters()
    sm90 = {name: fn.launches_sm90 for name, fn in _packed_wrappers().items()}
    one_token = sum(1 for s_len, _ in lm_calls if s_len == 1)
    print(f"[{tag}] {label} batch={run.batch} launches {counts} one_token_lm_forwards={one_token} "
          f"tokens_shape={tuple(tokens.shape)}")
    print(f"[{tag}] {label} batch={run.batch} first tokens={tokens[0, :8].tolist()}")
    want = {name: per(one_token) if callable(per) else n_lm * one_token if per == "lm" else per
            for name, per in expect.items()}
    assert counts == want, f"launch counts {counts}, expected {want}"
    assert one_token >= 1, "no decode step ran"
    assert tokens.shape[0] == run.rows, tokens.shape
    assert lm_calls and all(bool(ok) for _, ok in lm_calls), "non-finite logits"
    print(f"[{tag}] {label} batch={run.batch} all {len(lm_calls)} LM forwards gave finite logits")
    peak = torch.cuda.max_memory_allocated()

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.generate()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    print(f"[{tag}] {label} batch={run.batch} generate_s={times} p50_s={p50} "
          f"{run.rate(p50, one_token + 1)} max_memory_allocated_bytes={peak}")
    if stats is not None:
        stats.update(p50_s=p50, peak_bytes=peak, one_token_forwards=one_token, tokens=tokens, sm90=sm90)
    return counts


def narration_counts(cfg, decode_kernel: str) -> dict:
    """Launches per narration request: K1 once per ViT layer, K2 once per OPT
    layer, ``decode_kernel`` once per layer and one-token forward."""
    want = dict.fromkeys(counters(), 0)
    want.update({"packed_qkv_attention": cfg.vision_config.num_hidden_layers,
                 "packed_qkv_causal_attention": cfg.text_config.num_hidden_layers,
                 decode_kernel: "lm"})
    return want


def run_main_path(tag: str, dev: torch.device, launches: dict):
    """The bf16 path (phase 4). Returns the model, its LM forward log and the
    per-batch inputs, for the serving phases."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation.decoding import _prefill
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration

    cfg = configs.blip2_opt_2_7b()
    t0 = time.perf_counter()
    model = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(42), std=0.02)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] model eilev-blip2-opt-2.7b bf16 params={n_params} init_s={time.perf_counter() - t0}")

    # (sequence length, all logits finite) per LM forward; the flag stays a
    # device tensor, so the hook adds no host synchronisation to timed runs
    lm_calls: list = []
    model.language_model.register_forward_hook(
        lambda mod, args, out: lm_calls.append((args[0].shape[1], torch.isfinite(out[0]).all()))
    )
    runs = {batch: Narration(model, cfg, batch, dev) for batch in (1, 4)}
    for batch, reps in ((1, 5), (4, 3)):
        stats: dict = {}
        counts = drive(tag, "bf16", runs[batch], lm_calls, narration_counts(cfg, "decode_attention_stacked_bf16"),
                       reps, stats)
        # every K1 and K2 launch of the counted run on a Hopper body (wgmma + TMA)
        print(f"[{tag}] bf16 batch={batch} K1/K2 launches_sm90 {stats['sm90']}")
        assert stats["sm90"] == {"packed_qkv_attention": cfg.vision_config.num_hidden_layers,
                                 "packed_qkv_causal_attention": cfg.text_config.num_hidden_layers}, stats["sm90"]
        if batch == 1:
            launches.update({k: counts[k] for k in
                             ("packed_qkv_attention", "packed_qkv_causal_attention", "decode_attention_stacked_bf16")})

    for batch in (1, 4):
        profile_request(tag, "narration bf16", runs[batch])

    # prefill logits through K2 against the plain causal path (no cache) on
    # the same embeddings
    run = runs[1]
    with torch.inference_mode():
        embeds = run.embeds()
        k2_logits, _ = _prefill(model, embeds, run.mask, MAX_NEW_TOKENS)
        plain_logits, _ = model.language_model(embeds, attention_mask=run.mask)
        a, b = k2_logits.float(), plain_logits[:, -1].float()
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
    print(f"[{tag}] prefill logits K2 vs plain: min_cosine={cos} max_rel_err={rel} same_argmax={same}")
    assert cos > 0.999 and rel < 5e-2, (cos, rel)
    return model, lm_calls, runs


def run_generation(tag: str, model, lm_calls: list, runs: dict, launches: dict) -> None:
    """Phase 4d: beam search and sampling on the main path's bf16 model. (a)
    The flagship sample's beam search (5 beams, length_penalty -1, eos
    50118, 32 new tokens) at batch 1 and 4: counted (K1 = 39, K2 = 32, K3 =
    32 per one-token forward over the 5 or 20 beam rows), then p50 of SECONDARY_REPS warm
    requests and peak memory, and a torch.profiler pass at batch 4. (b) The
    VideoBLIP sample's sampling (temperature 0.7, top_p 0.9) at batch 4 with
    2 sequences a row (with a profiler pass), and beam_sample (5 beams) at
    batch 1, each with a generator seeded with GEN_SEED for every request:
    counted and timed the same way, and the same seed gives the same tokens
    twice."""
    want = narration_counts(model.config, "decode_attention_stacked_bf16")
    vocab = model.config.text_config.vocab_size
    for batch in (1, 4):
        counts = drive(tag, "beam-5 (length_penalty -1)", runs[batch].variant(**BEAM_KNOBS), lm_calls, want,
                       reps=SECONDARY_REPS)
        launches[f"decode_attention_stacked_bf16 at beam-5 batch {batch}"] = counts["decode_attention_stacked_bf16"]
        print(f"[{tag}] beam-5 batch={batch}: K3 launches a request={counts['decode_attention_stacked_bf16']}")
    profile_request(tag, "narration beam-5", runs[4].variant(**BEAM_KNOBS))
    for label, run, reps in (
        ("sampling (temperature 0.7, top_p 0.9, 2 sequences a row)",
         runs[4].variant(seed=GEN_SEED, num_return_sequences=2, **SAMPLE_KNOBS), SECONDARY_REPS),
        ("beam_sample (5 beams, temperature 0.7, top_p 0.9)",
         runs[1].variant(seed=GEN_SEED, **BEAM_KNOBS, **SAMPLE_KNOBS), 1),
    ):
        drive(tag, label, run, lm_calls, want, reps)
        if run.batch == 4:
            profile_request(tag, f"narration {label}", run)
        first, second = run.generate(), run.generate()
        same = bool(torch.equal(first, second))
        in_vocab = bool(((first >= 0) & (first < vocab)).all())
        print(f"[{tag}] {label} batch={run.batch}: the same seed gives the same tokens twice={same}; "
              f"tokens in the vocabulary={in_vocab}; row 0 {first[0].tolist()}")
        assert same and in_vocab, (same, in_vocab)


def greedy_with_logits(run):
    """The run's plain greedy tokens (its variant with no knobs and no mode)
    and the last-position logits of each of its LM forwards, in order: the
    logits token t was chosen from are entry t."""
    rec: list = []
    handle = run.model.language_model.register_forward_hook(lambda mod, args, out: rec.append(out[0][:, -1].float()))
    try:
        tokens = run.variant().generate()
    finally:
        handle.remove()
    torch.cuda.synchronize()
    return tokens, rec


@torch.inference_mode()
def forced_logits(run, tokens: torch.Tensor, steps: int) -> list:
    """Teacher forcing: the run's greedy prefill and one-token steps as
    generate runs them (decoding._greedy_sample_decoder_only), fed the first
    ``steps`` - 1 of ``tokens`` (another run's greedy tokens) instead of its
    own choices: the last-position logits of its ``steps`` LM forwards, fp32,
    in order, as greedy_with_logits records them (entry t is what token t
    was chosen from there)."""
    from eilev_tpu_torch.generation.decoding import _prefill

    model, tokens = run.model, tokens.to(run.mask.device)
    logits, cache = _prefill(model, run.embeds(), run.mask, run.new_tokens)
    out = [logits.float()]
    step_mask = torch.ones(run.batch, 1, dtype=torch.int32, device=run.mask.device)
    for t in range(steps - 1):
        nxt, cache = model.lm_forward(model.lm_embed(tokens[:, t : t + 1]), attention_mask=step_mask, cache=cache)
        out.append(nxt[:, -1].float())
    torch.cuda.synchronize()
    return out


def step_agreement(ours: list, ref: list) -> dict:
    """Per-step logits of two runs fed the same tokens: the min cosine over
    the steps and rows, the mean and least share of the reference's top 5
    in ours at a step, and the share of steps with the same argmax."""
    cos, top5, same = [], [], []
    for a, b in zip(ours, ref, strict=True):
        a, b = a.float().cpu(), b.float().cpu()
        cos.append(torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item())
        for ra, rb in zip(a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])):
            ta, tb = set(ra.topk(5).indices.tolist()), set(rb.topk(5).indices.tolist())
            top5.append(len(ta & tb) / 5)
            same.append(float(ra.argmax() == rb.argmax()))
    return {"steps": len(cos), "min_cosine": min(cos), "top5_mean": statistics.mean(top5),
            "top5_min": min(top5), "argmax_share": statistics.mean(same)}


def compare_speculative(tag: str, label: str, tokens, greedy, rec) -> float:
    """Speculative greedy against plain greedy in bf16: the share of
    identical rows; each other row's first divergence must come at a
    near-tie of the plain path's logits (top-2 gap within NEAR_TIE of the
    row's largest |logit|). Returns the share."""
    a, b = tokens.cpu(), greedy.cpu()
    n = min(a.shape[1], b.shape[1])
    same = (a[:, :n] == b[:, :n]).all(dim=1)
    ties = []
    for r in (~same).nonzero().flatten().tolist():
        t = int((a[r, :n] != b[r, :n]).nonzero()[0])
        top2 = rec[t][r].topk(2).values
        gap, scale = (top2[0] - top2[1]).item(), rec[t][r].abs().max().item()
        ties.append({"row": r, "position": t, "top2_gap": gap, "of_max_abs_logit": gap / scale})
        assert gap <= NEAR_TIE * scale, f"{label}: row {r} leaves greedy at {t} with a top-2 gap of {gap}"
    share = same.float().mean().item()
    print(f"[{tag}] {label}: rows identical to plain greedy {int(same.sum())}/{len(same)} (share {share}); "
          f"first divergences at near-ties {ties}")
    return share


def drive_mode(tag: str, label: str, run, lm_calls: list, layer_calls: list, prefill_kernel: str,
               n_vision: int, reps: int):
    """One counted request of a decoding mode (counters at 0 just before,
    read just after), then ``reps`` timed requests. The expected launches
    come from the run's own iterations, read off the LM forwards
    (``lm_calls``: the target's) and the calls of the first decoder layer
    (``layer_calls``: the target's and its self-draft's, which shares the
    layer): K1 once per ViT layer, the prefill kernel once per layer of each
    prefill (the target's, and the draft's), K3 once per layer of every
    one-token forward (the target's: contrastive commits, stream and greedy
    steps; the draft's: gamma + 1 a verify pass); the verify passes
    themselves run plain attention. Returns (tokens, counts)."""
    lm = run.model.language_model
    n_lm = lm.config.num_hidden_layers
    n_draft = run.mode.get("draft_layers") or 0
    gamma = run.mode.get("draft_tokens", 0)
    prompt = run.ids.shape[1]
    torch.cuda.reset_peak_memory_stats()
    lm_calls.clear()
    layer_calls.clear()
    reset_counters()
    tokens = run.generate()
    torch.cuda.synchronize()
    counts = counters()
    target = [s_len for s_len, _ in lm_calls]
    t_prefill, t_step = target.count(prompt), target.count(1)
    t_verify = sum(1 for s_len in target if 1 < s_len < prompt)
    d_prefill, d_step = layer_calls.count(prompt) - t_prefill, layer_calls.count(1) - t_step
    want = dict.fromkeys(counters(), 0)
    want["packed_qkv_attention"] = n_vision
    want[prefill_kernel] = n_lm * t_prefill + n_draft * d_prefill
    if prefill_kernel == "flash_attention":
        want["flash_attention_sm90"] = want[prefill_kernel]
    want["decode_attention_stacked_bf16"] = n_lm * t_step + n_draft * d_step
    print(f"[{tag}] {label} batch={run.batch} launches {counts} expected {want}: target prefills={t_prefill} "
          f"one-token forwards={t_step} verify passes={t_verify}; draft prefills={d_prefill} "
          f"one-token forwards={d_step}")
    assert counts == want, f"launch counts {counts}, expected {want}"
    assert t_prefill == 1 and lm_calls and all(bool(ok) for _, ok in lm_calls), "a prefill missing or non-finite"
    if n_draft:
        assert d_prefill == 1 and t_step == 0 and d_step == (gamma + 1) * t_verify >= gamma + 1
    elif "draft" in run.mode:
        assert d_prefill == d_step == t_step == 0 and t_verify >= 1
    else:
        assert d_prefill == d_step == t_verify == 0 and t_step >= 1
    assert tokens.shape[0] == run.rows
    vocab = lm.config.vocab_size
    assert bool(((tokens >= 0) & (tokens < vocab)).all()), "a token outside the vocabulary"
    accept = ""
    if t_verify:
        live = (tokens != run.model.config.text_config.pad_token_id).any(dim=0).nonzero()
        emitted = min(int(live.max()) + 1 if live.numel() else 1, run.new_tokens)
        accept = f"tokens_per_verify_pass={emitted / t_verify} "
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.generate()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times) if times else float("nan")
    print(f"[{tag}] {label} batch={run.batch} {accept}generate_s={times} p50_s={p50} "
          f"max_memory_allocated_bytes={peak} first tokens={tokens[0, :8].tolist()}")
    return tokens, counts


def _layer_log(lm) -> tuple[list, object]:
    """The sequence length of every call of ``lm``'s first decoder layer (a
    self-draft shares it), and the hook's handle."""
    calls: list = []
    return calls, lm.layers[0].register_forward_pre_hook(lambda mod, args: calls.append(args[0].shape[1]))


def run_decoding_modes(tag: str, model, lm_calls: list, runs: dict, launches: dict) -> None:
    """Phase 4e: the decoding modes on the main path's bf16 model at full
    width, batch 1 and 4: contrastive search (0.6, top_k 4), generate_stream
    (greedy, chunk 4), the self-draft of the first 4 layers (gamma 4) and
    prompt-lookup greedy (gamma 8, match 3), then prompt-lookup sampling
    (temperature 0.7, top_p 0.9) at batch 4 with a generator seeded with
    GEN_SEED. Each counted against its own iterations (drive_mode), p50 of
    SECONDARY_REPS warm requests, peak memory and acceptance, and a torch.profiler pass
    over prompt-lookup greedy at batch 1. The stream's tokens equal
    generate's greedy tokens; the speculative greedy rows equal plain
    greedy's or leave it at a near-tie (compare_speculative); sampling gives
    the same tokens twice for the same seed."""
    n_vit = model.config.vision_config.num_hidden_layers
    layer_calls, handle = _layer_log(model.language_model)
    lookup = DECODING_MODES[f"prompt lookup greedy (gamma {LOOKUP_GAMMA}, match {LOOKUP_MATCH})"][1]
    try:
        for batch in (1, 4):
            greedy, rec = greedy_with_logits(runs[batch])
            for label, (knobs, mode) in DECODING_MODES.items():
                run = runs[batch].variant(mode=mode, **knobs)
                tokens, counts = drive_mode(tag, label, run, lm_calls, layer_calls, "packed_qkv_causal_attention",
                                            n_vit, reps=SECONDARY_REPS)
                if batch == 1 and mode.get("draft") == "prompt_lookup":
                    profile_request(tag, f"narration {label}", run)
                if "chunk_tokens" in mode:
                    g = greedy.cpu()
                    same = bool(torch.equal(tokens, g[:, : tokens.shape[1]])) and bool(
                        (g[:, tokens.shape[1]:] == 1).all())
                    print(f"[{tag}] {label} batch={batch}: the streamed tokens equal generate's greedy={same}")
                    assert same, "the stream differs from generate's greedy tokens"
                elif mode:
                    compare_speculative(tag, f"{label} batch={batch}", tokens, greedy, rec)
                if mode.get("draft_layers"):
                    launches[f"decode_attention_stacked_bf16 at narration 4-layer draft cache, batch {batch}"] = \
                        counts["decode_attention_stacked_bf16"]
            del rec
        label = "prompt lookup sampling (temperature 0.7, top_p 0.9)"
        run = runs[4].variant(seed=GEN_SEED, mode=lookup, **SAMPLE_KNOBS)
        drive_mode(tag, label, run, lm_calls, layer_calls, "packed_qkv_causal_attention", n_vit, reps=SECONDARY_REPS)
        first, second = run.generate(), run.generate()
        same = bool(torch.equal(first, second))
        print(f"[{tag}] {label} batch=4: the same seed gives the same tokens twice={same}; row 0 {first[0].tolist()}")
        assert same
    finally:
        handle.remove()


def run_text_decoding_modes(tag: str, run, lm_calls: list, launches: dict) -> None:
    """Phase 7 (c): the text LM's speculative modes at the Llama-2-7b
    widths (LLAMA_LAYERS deep), bf16, batch 1, the 1,984-token prompt and 64 new tokens:
    prompt lookup (gamma 8: 2,058 slots) and the self-draft of the first 4
    layers (gamma 4: 2,054 slots). K5 (on its Hopper body) once per layer of
    each prefill, the target's and the draft's; K3 over the draft's cache
    only; against plain greedy as in phase 4e; p50 of 2 warm requests."""
    layer_calls, handle = _layer_log(run.model.language_model)
    greedy, rec = greedy_with_logits(run)
    modes = {f"text LM prompt lookup (gamma {LOOKUP_GAMMA}, match {LOOKUP_MATCH})":
             {"draft": "prompt_lookup", "draft_tokens": LOOKUP_GAMMA, "draft_match_len": LOOKUP_MATCH},
             f"text LM self-draft ({DRAFT_LAYERS} layers, gamma {DRAFT_GAMMA})":
             {"draft_layers": DRAFT_LAYERS, "draft_tokens": DRAFT_GAMMA}}
    try:
        for label, mode in modes.items():
            tokens, counts = drive_mode(tag, label, run.variant(mode=mode), lm_calls, layer_calls,
                                        "flash_attention", 0, reps=2)
            compare_speculative(tag, label, tokens, greedy, rec)
            slots = LLAMA_PROMPT + LLAMA_NEW + mode["draft_tokens"] + 2
            launches[f"flash_attention at {slots} slots"] = counts["flash_attention"]
            if mode.get("draft_layers"):
                launches["decode_attention_stacked_bf16 at text-LM 4-layer draft cache"] = \
                    counts["decode_attention_stacked_bf16"]
    finally:
        handle.remove()


def run_decoding_modes_f32(tag: str, run, int8: bool = False) -> None:
    """Phase 8 (b): the decoding modes on the fp32 cut (TF32 off), token for
    token: the self-draft of 1 of its 2 layers (gamma 4), prompt-lookup
    greedy (gamma 8) and the stream (chunk 4) equal the plain path's greedy
    tokens (every wrapper swapped for its twin), and contrastive search the
    plain path's contrastive tokens; over the int8 KV cache (``int8``) the
    two speculative modes, whose draft steps run K4."""
    with plain_kernels():
        greedy = run.variant().generate().cpu()
    modes = {"self-draft (1 layer, gamma 4)": {"draft_layers": 1, "draft_tokens": DRAFT_GAMMA},
             f"prompt lookup greedy (gamma {LOOKUP_GAMMA})": {"draft": "prompt_lookup", "draft_tokens": LOOKUP_GAMMA}}
    if not int8:
        modes[f"stream (chunk {STREAM_CHUNK})"] = {"chunk_tokens": STREAM_CHUNK}
    cache = "int8 KV cache" if int8 else "fp32 cache"
    for label, mode in modes.items():
        reset_counters()
        tokens = run.variant(mode=mode).generate().cpu()
        torch.cuda.synchronize()
        counts = counters()
        same = bool(torch.equal(tokens, greedy[:, : tokens.shape[1]]))
        print(f"[{tag}] fp32 narration {label}, {cache}: launches {counts}; tokens identical to the plain "
              f"path's greedy={same}: {tokens[0].tolist()}")
        assert same, f"fp32 {label} differs from the plain path's greedy tokens"
        if mode.get("draft_layers"):
            k = "decode_attention_stacked_int8_f32" if int8 else "decode_attention_stacked_f32"
            assert counts[k] > 0, f"the fp32 self-draft launched no {k}"
    if not int8:
        _same_tokens_as_plain(tag, "fp32 narration contrastive (0.6, top_k 4)", run.variant(**CONTRASTIVE_KNOBS))


def run_k6_on_vit_layers(tag: str, model, run, launches: dict, tol: float = 2e-2) -> None:
    """K6 over the main-path model's 39 ViT layers at batch 1: each layer's
    input to its MLP branch (captured by a pre-hook on layer_norm2 during one
    encode of the request's frames) through K6 with that layer's weights, the
    counters at 0 just before and read just after. Held against the twin
    (atol = rtol = 2e-2) and against the port's own modules,
    layer.mlp(layer.layer_norm2(x)): those round the fc1 output to bf16
    before gelu, which K6 and the reference do not, so the bar there is the
    min cosine over rows, > 0.999 (a wrong weight, transpose or layer gives
    ~0), and the same cosine against the twin. With an fp32 model (``run.dtype``)
    the fp32 body runs, held to the twin at ``tol``. Then the modules and K6
    are timed in turns on layer 0's input."""
    from eilev_tpu_torch.ops import fused_mlp as fm
    from eilev_tpu_torch.ops.preprocess import process_videos

    layers = model.vision_model.vision.layers
    inputs: list = []
    hooks = [layer.layer_norm2.register_forward_pre_hook(lambda mod, args: inputs.append(args[0].clone()))
             for layer in layers]
    try:
        with torch.inference_mode():
            model.vision_model(process_videos(run.frames, dtype=run.dtype))
    finally:
        for hook in hooks:
            hook.remove()
    assert len(inputs) == len(layers), len(inputs)
    eps = layers[0].layer_norm2.eps
    with torch.inference_mode():
        # the JAX (in, out) layout: nn.Linear keeps (out, in)
        weights = [(layer.layer_norm2.weight, layer.layer_norm2.bias, layer.mlp.fc1.weight.T.contiguous(),
                    layer.mlp.fc1.bias, layer.mlp.fc2.weight.T.contiguous(), layer.mlp.fc2.bias)
                   for layer in layers]
        torch.cuda.synchronize()
        reset_counters()
        outs = [fm.ln_mlp(x, *w, eps=eps) for x, w in zip(inputs, weights)]
        torch.cuda.synchronize()
        counts = counters()
        want = dict.fromkeys(counts, 0)
        want["ln_mlp"] = len(layers)
        f32 = run.dtype == torch.float32
        if f32:
            want["ln_mlp_f32"] = len(layers)
        print(f"[{tag}] K6 over the ViT layers batch=1 x={tuple(inputs[0].shape)} {run.dtype} launches {counts}")
        assert counts == want, f"launch counts {counts}, expected {want}"
        errs, cos_ref, cos_mod = [], [], []
        for layer, x, w, out in zip(layers, inputs, weights, outs):
            ref = fm.ln_mlp_reference(x, *w, eps=eps)
            mod = layer.mlp(layer.layer_norm2(x))
            torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
            assert bool(torch.isfinite(out).all())
            errs.append(((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item())
            cos = torch.nn.functional.cosine_similarity
            cos_ref.append(cos(out.float().flatten(0, 1), ref.float().flatten(0, 1), dim=-1).min().item())
            cos_mod.append(cos(out.float().flatten(0, 1), mod.float().flatten(0, 1), dim=-1).min().item())
    print(f"[{tag}] K6 over {len(layers)} ViT layers: max_rel_err_vs_twin={max(errs)} "
          f"min_cosine_vs_twin={min(cos_ref)} min_cosine_vs_modules={min(cos_mod)}")
    assert min(cos_ref) > 0.999 and min(cos_mod) > 0.999, (min(cos_ref), min(cos_mod))
    launches["ln_mlp_f32" if f32 else "ln_mlp"] = counts["ln_mlp_f32" if f32 else "ln_mlp"]

    # what the ViT runs today in K6's place (layer_norm2, then fc1, gelu, fc2
    # as modules in the model's dtype), in turns with K6, on layer 0's input:
    # the question whether to route the ViT through K6
    x, w, layer = inputs[0], weights[0], layers[0]
    with torch.inference_mode():
        modules = [median_ms(f) for f in (lambda: layer.mlp(layer.layer_norm2(x)),
                                          lambda: fm.ln_mlp(x, *w, eps=eps),
                                          lambda: fm.ln_mlp(x, *w, eps=eps),
                                          lambda: layer.mlp(layer.layer_norm2(x)))]
    print(f"[{tag}] ViT MLP branch at {tuple(x.shape)} {run.dtype}: modules_ms={modules[0]},{modules[3]} "
          f"K6_ms={modules[1]},{modules[2]} (not counted: timing only)")


class WordTokenizer:
    """A word-level tokenizer with OPT's special ids (bos = eos = 2, pad = 1,
    newline NEWLINE): words are numbered from 1,000 in the order first seen,
    so every id is an OPT id (below 50,272). No OPT tokenizer is in the
    repository; the ICL phase needs token ids of the right count and shape,
    not their text."""

    bos_token_id = 2
    pad_token_id = 1
    eos_token_id = 2

    def __init__(self):
        self.vocab = {"\n": NEWLINE}

    def __call__(self, text: str, add_special_tokens: bool = True, **kwargs):
        ids = [self.vocab.setdefault(w, 999 + len(self.vocab)) for w in re.findall(r"\n|\S+", text)]
        assert max(ids, default=0) < 50272, "word ids past OPT's vocabulary"
        return {"input_ids": ([self.bos_token_id] if add_special_tokens else []) + ids}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.batch_decode([ids], skip_special_tokens)[0]

    def batch_decode(self, rows, skip_special_tokens: bool = True) -> list:
        """Known ids back to their words, others as ``<id>`` (the narration
        CLI decodes with it)."""
        words = {i: w for w, i in self.vocab.items()}
        special = {self.bos_token_id, self.pad_token_id, self.eos_token_id}
        return [" ".join(words.get(int(i), f"<{int(i)}>") for i in row
                         if not (skip_special_tokens and int(i) in special)) for row in rows]


def icl_class_sets() -> tuple[dict, dict]:
    """The vendored class sets: 187 verb prompts and 788 noun prompts."""
    from eilev_tpu_torch.eval import load_prompt_map

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "ego4d", "eval-data")
    verbs = load_prompt_map(os.path.join(root, "structured_verb_prompt.csv"), "structured_verb")
    nouns = load_prompt_map(os.path.join(root, "structured_noun_prompt.csv"), "structured_noun")
    assert (len(verbs), len(nouns)) == (187, 788), (len(verbs), len(nouns))
    return verbs, nouns


class IclBatch:
    """One ICL classify request: ICL_BATCH rows of SHOTS shot videos + 1 query
    video (FRAMES x 224^2 uint8 frames from a seed), each shot followed by its
    narration, then the stage's question. ``narrations[r]`` are row r's shot
    narrations; rows of equal length are unpadded, a shorter row is
    left-padded, as the evaluator pads."""

    def __init__(self, model, tok, narrations: list, dev: torch.device, dtype=torch.bfloat16):
        self.model, self.tok, self.narrations, self.dev, self.dtype = model, tok, narrations, dev, dtype
        self.batch = len(narrations)
        self.n_videos = self.batch * (SHOTS + 1)
        self.keys = [f"row{r}|video{v}" for r in range(self.batch) for v in range(SHOTS + 1)]
        self.frames = torch.from_numpy(
            np.random.default_rng(2).integers(0, 256, size=(self.n_videos, 3, FRAMES, 224, 224), dtype=np.uint8)
        ).to(dev)
        self._classes: dict = {}

    def pixel(self):
        from eilev_tpu_torch.ops.preprocess import process_videos

        img = self.model.config.vision_config.image_size
        return process_videos(self.frames, height=img, width=img, dtype=self.dtype)

    def prompt(self, suffix: str):
        """(ids, mask, video_input_mask) of the stage's prompt "... Answer:" +
        ``suffix``, left-padded to the longest row."""
        from eilev_tpu_torch.data import clean_narration_text, generate_input_ids_and_labels_from_interleaved
        from eilev_tpu_torch.eval.icl import FEW_SHOT_PROMPT

        builts = [generate_input_ids_and_labels_from_interleaved(
            self.tok, [(" ".join([FEW_SHOT_PROMPT, clean_narration_text(n)]), 1) for n in narrs]
            + [(FEW_SHOT_PROMPT + suffix, 1)], None, self.model.config.num_query_tokens,
            self.model.config.use_decoder_only_language_model)
            for narrs in self.narrations]
        n = max(len(b["input_ids"]) for b in builts)
        ids = np.full((self.batch, n), self.tok.pad_token_id, np.int64)
        mask, vim = np.zeros_like(ids), np.zeros_like(ids)
        for r, b in enumerate(builts):
            k = len(b["input_ids"])
            ids[r, n - k:], mask[r, n - k:], vim[r, n - k:] = b["input_ids"], 1, b["video_input_mask"]
        return tuple(torch.from_numpy(x).to(self.dev) for x in (ids, mask, vim))

    def classes(self, prompts: list):
        """(ids, mask) of the class continuations " " + prompt, right-padded."""
        key = tuple(prompts)
        if key not in self._classes:
            enc = [self.tok(" " + c, add_special_tokens=False)["input_ids"] for c in prompts]
            ids = np.full((len(enc), max(map(len, enc))), self.tok.pad_token_id, np.int64)
            mask = np.zeros_like(ids)
            for i, e in enumerate(enc):
                ids[i, : len(e)], mask[i, : len(e)] = e, 1
            self._classes[key] = tuple(torch.from_numpy(x).to(self.dev) for x in (ids, mask))
        return self._classes[key]

    def classify(self, suffix: str, prompts: list, **kw):
        """The stage through the public entry point, ``generation.classify``
        (the pixels unless ``video_features`` is given)."""
        from eilev_tpu_torch.generation import classify

        ids, mask, vim = self.prompt(suffix)
        class_ids, class_mask = self.classes(prompts)
        if "video_features" not in kw:
            kw["pixel_values"] = self.pixel()
        return classify(self.model, prompt_input_ids=ids, class_input_ids=class_ids, prompt_attention_mask=mask,
                        prompt_video_input_mask=vim, class_attention_mask=class_mask, **kw)

    @torch.inference_mode()
    def staged(self, suffix: str, prompts: list, encode):
        """classify's three parts with CUDA events between them: encode
        (``encode()``: uint8 frames -> video features), the prompt prefill
        into a fresh cache (embed, scatter, the OPT layers through K2) and the
        class scoring. Returns the scores and the parts' ms."""
        from eilev_tpu_torch.generation.classify import _prefill_prompt, _score_classes

        ids, mask, vim = self.prompt(suffix)
        class_ids, class_mask = self.classes(prompts)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events[0].record()
        feats = encode()
        events[1].record()
        last, cache = _prefill_prompt(self.model, ids, mask, None, vim, feats)
        events[2].record()
        scores = _score_classes(self.model, class_ids, class_mask, last, cache)
        events[3].record()
        events[3].synchronize()
        return scores, [events[i].elapsed_time(events[i + 1]) for i in range(3)]


def score_bar(tag: str, label: str, ours, ref, tol: float = ICL_SCORE_TOL) -> float:
    """(B, C) mean log-likelihoods held to a reference: all finite, cosine of
    the flattened matrices > ICL_MIN_COSINE, max abs error < ``tol``, and the
    argmax equal wherever the reference's top-2 margin exceeds twice the
    measured max error."""
    a, b = ours.float(), ref.float()
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all()), f"{label}: non-finite scores"
    err = (a - b).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
    top2 = b.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    same = bool((a.argmax(-1) == b.argmax(-1))[decided].all())
    print(f"[{tag}] {label}: scores {tuple(a.shape)} max_abs_err={err} cosine={cos} "
          f"argmax_equal_where_decided={same} (decided rows {int(decided.sum())}/{a.shape[0]}; "
          f"argmax kernel {a.argmax(-1).tolist()} reference {b.argmax(-1).tolist()})")
    assert cos > ICL_MIN_COSINE and err < tol and same, (label, cos, err, same)
    return err


def icl_narrations(verbs: dict, nouns: dict, rng, short: bool = False) -> list:
    """SHOTS shot narrations "#C C <verb prompt> <noun prompt>" from the class
    sets (``short``: the verb prompt only, so the row is shorter)."""
    vs, ns = list(verbs), list(nouns)
    return [f"#C C {vs[rng.integers(len(vs))]}" + ("" if short else f" {ns[rng.integers(len(ns))]}")
            for _ in range(SHOTS)]


def run_icl(tag: str, dev: torch.device, model, narration_run) -> None:
    """The ICL classify phase on the main path's bf16 eilev-blip2-opt-2.7b
    model (full width and depth, random weights): (a) both stages through
    classify with kernels against the plain path on the card; (b) class
    batches of 64 against unchunked; (c) the VideoFeatureCache: the noun
    stage all hits (K1 = 0), scores against the pixel path, and greedy
    generate(video_features=...) and generate(vision_chunks=4) against the
    pixel path; (d) IclEvaluator end to end in fp32 at the phase-8 depth, on
    the kernels and on the plain path; (e) the bf16 left-padded row's NaN
    scores (the reference behaviour). Then each stage's p50 split into
    encode, prefill and class scoring, with and without the feature cache."""
    from eilev_tpu_torch.generation import GenerationConfig, generate
    from eilev_tpu_torch.serving import VideoFeatureCache

    verbs, nouns = icl_class_sets()
    verb_prompts, noun_prompts = list(verbs), list(nouns)
    tok = WordTokenizer()
    narrs = icl_narrations(verbs, nouns, np.random.default_rng(5))
    req = IclBatch(model, tok, [narrs] * ICL_BATCH, dev)
    verb_q = " The camera wearer"
    n_vit = model.config.vision_config.num_hidden_layers
    n_lm = model.config.text_config.num_hidden_layers

    # (a) both stages, kernels against the plain path; counted through classify
    reset_counters()
    verb_k = req.classify(verb_q, verb_prompts)
    torch.cuda.synchronize()
    counts = counters()
    ids, mask, _ = req.prompt(verb_q)
    print(f"[{tag}] ICL verb stage batch={req.batch} prompt_tokens={ids.shape[1]} unpadded={bool(mask.all())} "
          f"classes={len(verb_prompts)} launches {counts}")
    want = dict.fromkeys(counts, 0)
    want.update({"packed_qkv_attention": n_vit, "packed_qkv_causal_attention": n_lm})
    assert counts == want, f"launch counts {counts}, expected {want}"
    # the noun stage's question on row 0's predicted verb for every row, so the
    # rows stay unpadded
    noun_q = f"{verb_q} {verb_prompts[int(verb_k[0].argmax())]}"
    noun_k = req.classify(noun_q, noun_prompts)
    reset_counters()
    with plain_kernels():
        verb_p = req.classify(verb_q, verb_prompts)
        noun_p = req.classify(noun_q, noun_prompts)
    torch.cuda.synchronize()
    assert not any(counters().values()), f"the plain path launched a kernel: {counters()}"
    score_bar(tag, "ICL (a) verb stage bf16, kernels vs plain path", verb_k, verb_p)
    score_bar(tag, "ICL (a) noun stage bf16, kernels vs plain path", noun_k, noun_p)
    del verb_p, noun_p

    # (b) class batches of 64 against unchunked
    score_bar(tag, "ICL (b) verb stage class_batch_size=64 vs unchunked",
              req.classify(verb_q, verb_prompts, class_batch_size=64), verb_k)
    score_bar(tag, "ICL (b) noun stage class_batch_size=64 vs unchunked",
              req.classify(noun_q, noun_prompts, class_batch_size=64), noun_k)

    # (c) the feature cache: the verb stage encodes (misses), the noun stage
    # finds every video (no pixels given: a miss would raise)
    cache = VideoFeatureCache(model)
    with torch.inference_mode():
        feats = cache.features(req.keys, req.pixel())
    verb_c = req.classify(verb_q, verb_prompts, video_features=feats)
    reset_counters()
    noun_c = req.classify(noun_q, noun_prompts, video_features=cache.features(req.keys))
    torch.cuda.synchronize()
    counts = counters()
    print(f"[{tag}] ICL (c) noun stage with the feature cache: hits={cache.hits} misses={cache.misses} "
          f"hit_rate={cache.hit_rate} launches {counts}")
    assert counts["packed_qkv_attention"] == 0 and counts["packed_qkv_causal_attention"] == n_lm, counts
    assert cache.misses == req.n_videos and cache.hits == req.n_videos and len(cache) == req.n_videos
    score_bar(tag, "ICL (c) verb stage feature cache vs pixels", verb_c, verb_k)
    score_bar(tag, "ICL (c) noun stage feature cache vs pixels", noun_c, noun_k)
    del feats, cache, verb_c, noun_c
    run = narration_run
    gen_cfg = GenerationConfig(max_new_tokens=run.new_tokens, pad_token_id=1, eos_token_id=(NEWLINE,))
    with torch.inference_mode():
        from eilev_tpu_torch.ops.preprocess import process_videos

        run_pixel = process_videos(run.frames, dtype=run.dtype)
        tokens = run.generate()
        feats = VideoFeatureCache(model).features([f"n{i}" for i in range(run.n_videos)], run_pixel)
        by_features = generate(model, input_ids=run.ids, attention_mask=run.mask, video_input_mask=run.vim,
                               video_features=feats, generation_config=gen_cfg)
        by_chunks = generate(model, input_ids=run.ids, attention_mask=run.mask, video_input_mask=run.vim,
                             pixel_values=run_pixel, vision_chunks=4, generation_config=gen_cfg)
    same_f, same_c = bool(torch.equal(by_features, tokens)), bool(torch.equal(by_chunks, tokens))
    print(f"[{tag}] ICL (c) narration batch={run.batch} {run.new_tokens} greedy tokens: "
          f"video_features identical={same_f}, vision_chunks=4 identical={same_c}; row 0 {tokens[0].tolist()}")
    assert same_f and same_c, "generate(video_features / vision_chunks) tokens differ from the pixel path"
    del run_pixel, feats, tokens, by_features, by_chunks
    torch.cuda.empty_cache()

    # (e) bf16, row 0 left-padded: every score of row 0 NaN on both paths (the
    # reference behaviour: the prompt cache holds NaN k/v at the padded slots
    # from layer 2, and the additive prefix bias carries them into every
    # class score), rows 1-3 finite
    short = icl_narrations(verbs, nouns, np.random.default_rng(6), short=True)
    padded = IclBatch(model, tok, [short] + [narrs] * (ICL_BATCH - 1), dev)
    pad = int((padded.prompt(verb_q)[1][0] == 0).sum())
    scores_k = padded.classify(verb_q, verb_prompts)
    with plain_kernels():
        scores_p = padded.classify(verb_q, verb_prompts)
    for name, sc in (("kernels", scores_k), ("plain path", scores_p)):
        nan_rows = torch.isnan(sc).all(-1).tolist()
        print(f"[{tag}] ICL (e) bf16 row 0 left-padded by {pad}, {name}: all-NaN rows {nan_rows}, rows 1-3 "
              f"finite={bool(torch.isfinite(sc[1:]).all())} (the reference behaviour, kept on purpose)")
        assert pad > 0 and nan_rows == [True] + [False] * (ICL_BATCH - 1) and bool(torch.isfinite(sc[1:]).all())
    del padded, scores_k, scores_p

    # timings: each stage's parts, p50 over ICL_REPS warm requests, without
    # the feature cache (both stages encode) and with a cold one (the verb
    # stage encodes its misses in buckets of 8, the noun stage hits)
    for mode in ("no cache", "feature cache"):
        parts: dict = {"verb": [], "noun": []}
        for rep in range(ICL_REPS + 1):
            cache = VideoFeatureCache(model)
            encode_verb = ((lambda: cache.features(req.keys, req.pixel())) if mode == "feature cache"
                           else (lambda: model.encode_videos(req.pixel())))
            encode_noun = ((lambda: cache.features(req.keys)) if mode == "feature cache"
                           else (lambda: model.encode_videos(req.pixel())))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            t0 = time.perf_counter()
            _, verb_ms = req.staged(verb_q, verb_prompts, encode_verb)
            _, noun_ms = req.staged(noun_q, noun_prompts, encode_noun)
            wall = time.perf_counter() - t0
            if rep == 0:  # warm-up; its launches and peak memory are the request's
                counts, peak = counters(), torch.cuda.max_memory_allocated()
                continue
            parts["verb"].append(verb_ms + [wall])
            parts["noun"].append(noun_ms)
        p50 = {stage: [statistics.median(x[i] for x in rows) for i in range(len(rows[0]))]
               for stage, rows in parts.items()}
        print(f"[{tag}] ICL request batch={req.batch} ({mode}), p50 over {ICL_REPS} warm requests: "
              f"verb stage ({len(verb_prompts)} classes) encode_ms={p50['verb'][0]} prefill_ms={p50['verb'][1]} "
              f"class_scoring_ms={p50['verb'][2]}; noun stage ({len(noun_prompts)} classes) "
              f"encode_ms={p50['noun'][0]} prefill_ms={p50['noun'][1]} class_scoring_ms={p50['noun'][2]}; "
              f"request_wall_s={p50['verb'][3]}; max_memory_allocated_bytes={peak}; launches a request: "
              f"K1={counts['packed_qkv_attention']} K2={counts['packed_qkv_causal_attention']}")
        # K1 once per ViT layer and encode: both stages' encodes, or the
        # cache's buckets of the verb stage's misses
        encodes = -(-req.n_videos // cache.bucket) if mode == "feature cache" else 2
        assert counts["packed_qkv_attention"] == encodes * n_vit, counts
        assert counts["packed_qkv_causal_attention"] == 2 * n_lm, counts
        del cache
    torch.cuda.empty_cache()


def run_int8_serving(tag: str, model, lm_calls: list, runs: dict, launches: dict) -> None:
    """Phases 5 and 6: the int8 serving modes, quantized in place on the card."""
    from eilev_tpu_torch.ops.gelu import set_gelu_impl
    from eilev_tpu_torch.ops.quantization import quantize_model_

    int8_counts = narration_counts(model.config, "decode_attention_stacked_int8")
    # the bf16 model's prefill logits on the embeddings the int8 LM will see
    # (the vision tower and Q-Former stay bf16 in this mode)
    embeds = {batch: run.embeds() for batch, run in runs.items()}
    bf16_logits = {batch: run.prefill_logits(embeds[batch]) for batch, run in runs.items()}

    t0 = time.perf_counter()
    quantize_model_(model, int8_lm=True, int8_kv=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[{tag}] quantized the LM in place (int8_lm, int8_kv) in {time.perf_counter() - t0} s; "
          f"memory_allocated_bytes={torch.cuda.memory_allocated()}")
    for batch, reps in ((1, 3), (4, 2)):
        run = runs[batch]
        counts = drive(tag, "int8 serving", run, lm_calls, int8_counts, reps)
        if batch == 1:
            launches["decode_attention_stacked_int8"] = counts["decode_attention_stacked_int8"]
        a = run.prefill_logits(embeds[batch]).float().flatten(0, 1)
        b = bf16_logits[batch].float().flatten(0, 1)
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        print(f"[{tag}] int8 serving batch={batch} prefill logits vs bf16 over {a.shape[0]} positions: "
              f"min_cosine={cos.min().item()} mean_cosine={cos.mean().item()} same_argmax_share={same}")
        assert bool(torch.isfinite(a).all()), "non-finite int8 prefill logits"
        assert cos.min().item() > INT8_MIN_COSINE, cos.min().item()
    del bf16_logits, embeds
    # the flagship beam search over the int8 cache: K4 at 5 beam rows, its
    # scales reordered with the int8 k/v
    counts = drive(tag, "int8 serving beam-5 (length_penalty -1)", runs[1].variant(**BEAM_KNOBS), lm_calls,
                   int8_counts, reps=2)
    launches["decode_attention_stacked_int8 at beam-5 batch 1"] = counts["decode_attention_stacked_int8"]

    quantize_model_(model, int8_lm=True, int8_kv=True, w8a8_prefill=True, int8_vision=True, int8_qformer=True)
    torch.cuda.empty_cache()
    set_gelu_impl("fast")
    try:
        drive(tag, "every serving mode (int8 LM+KV, W8A8 prefill/vision/Q-Former, fast gelu)",
              runs[4], lm_calls, int8_counts, reps=2)
    finally:
        set_gelu_impl("exact")


class TextRun(Variants):
    """A text-LM batch of left-padded token ids (bos, then random ids from a
    seed), decoded (greedily unless a variant says otherwise) through the
    calls ``TextLM.generate`` makes."""

    def __init__(self, module, lengths: tuple, prompt_len: int, dev: torch.device, seed: int,
                 new_tokens: int = LLAMA_NEW):
        rng = np.random.default_rng(seed)
        ids = np.zeros((len(lengths), prompt_len), np.int64)  # LLaMA pad id 0
        mask = np.zeros_like(ids)
        for i, n in enumerate(lengths):
            ids[i, prompt_len - n] = 1  # bos
            ids[i, prompt_len - n + 1 :] = rng.integers(3, 32000, size=n - 1)
            mask[i, prompt_len - n :] = 1
        self.model, self.batch, self.new_tokens = module, len(lengths), new_tokens
        self.ids = torch.from_numpy(ids).to(dev)
        self.mask = torch.from_numpy(mask).to(dev)

    def rate(self, p50_s: float, new_tokens: int) -> str:
        return f"new_tokens_per_row={new_tokens} tokens_per_s={self.batch * new_tokens / p50_s}"

    @torch.inference_mode()
    def generate(self):
        """As TextLM.generate decodes: a speculative mode (``mode``) where it
        applies, else the greedy/sampling loop or beam search."""
        from eilev_tpu_torch.generation import GenerationConfig
        from eilev_tpu_torch.generation.decoding import _decode, _speculative

        embeds = self.model.embed_and_scatter(self.ids)
        cfg = GenerationConfig(max_new_tokens=self.new_tokens, pad_token_id=0, eos_token_id=(LLAMA_EOS,),
                               **self.knobs)
        gen = self.generator(self.ids.device)
        tokens = None
        if self.mode and cfg.num_beams == 1:
            m = self.mode
            tokens = _speculative(self.model.language_model, self.ids, None, embeds, self.mask, cfg, gen,
                                  m.get("draft"), m.get("draft_layers"), m.get("draft_tokens", 4),
                                  m.get("draft_match_len", 3), None)
        return _decode(self.model, embeds, self.mask, cfg, gen) if tokens is None else tokens

    @torch.inference_mode()
    def prefill_logits(self):
        """(B, S, vocab) logits of the prefill into a fresh LLAMA_CACHE-slot cache."""
        from eilev_tpu_torch.models import init_cache

        embeds = self.model.embed_and_scatter(self.ids)
        cache = init_cache(self.model.config.text_config, self.batch, self.ids.shape[1] + LLAMA_NEW,
                           dtype=embeds.dtype, device=embeds.device)
        logits, _ = self.model.lm_forward(embeds, attention_mask=self.mask, cache=cache)
        return logits


def profile_request(tag: str, label: str, run) -> dict:
    """torch.profiler over one warm request: device kernel time, launches, the
    idle share of the profiled window and of an unprofiled run, the top
    kernels. Returns the numbers printed. It records the device's activity
    only: CPU op events change none of these numbers (the same kernel time
    and launches, measured on the card at the text LM's 92,700 launches)
    and cost three times the post-processing (59 s against 19 there)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run.generate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.generate()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    print(f"[{tag}] profile {label} batch={run.batch}: device_kernel_ms={dev_us / 1e3} launches={n_launch} "
          f"profiled_wall_s={wall_prof} idle_share_profiled={1 - dev_us / 1e6 / wall_prof} "
          f"unprofiled_wall_s={wall} idle_share_vs_unprofiled={1 - dev_us / 1e6 / wall}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:90]}")
    return {"device_kernel_ms": dev_us / 1e3, "launches": n_launch, "unprofiled_wall_s": wall,
            "idle_share_vs_unprofiled": 1 - dev_us / 1e6 / wall}


def run_llama(tag: str, dev: torch.device, launches: dict, phase16: dict) -> None:
    """The LLaMA text-LM path at the Llama-2-7b widths, LLAMA_LAYERS deep (random bf16 weights):
    K5 on every long-prompt prefill layer, K3 (bf16) or K4 (int8) on every
    decode step, phase 16 (d) (the sentence tools, into ``phase16``), then
    the int8 serving mode quantized in place."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation.text_lm import _TextOnlyModule
    from eilev_tpu_torch.ops.attention import set_default_attention_impl
    from eilev_tpu_torch.ops.quantization import quantize_model_

    cfg = configs.VideoBlipConfig(text_config=configs.LlamaConfig(num_hidden_layers=LLAMA_LAYERS))
    t0 = time.perf_counter()
    module = _TextOnlyModule(cfg, device=dev, dtype=torch.bfloat16).eval()
    random_init_(module, torch.Generator(device=dev).manual_seed(43), std=0.02)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in module.parameters())
    print(f"[{tag}] model llama-2-7b widths, {LLAMA_LAYERS} layers, bf16 params={n_params} "
          f"init_s={time.perf_counter() - t0}")
    lm_calls: list = []
    module.language_model.register_forward_hook(
        lambda mod, args, out: lm_calls.append((args[0].shape[1], torch.isfinite(out[0]).all()))
    )
    runs = {1: TextRun(module, (LLAMA_PROMPT,), LLAMA_PROMPT, dev, seed=3),
            4: TextRun(module, LLAMA_REAL, LLAMA_PROMPT, dev, seed=4)}
    n_layers = cfg.text_config.num_hidden_layers
    bf16 = dict.fromkeys(counters(), 0)
    bf16.update({"flash_attention": n_layers, "flash_attention_sm90": n_layers, "decode_attention_stacked_bf16": "lm"})
    for batch, reps in ((1, 5), (4, 3)):
        counts = drive(tag, "llama bf16", runs[batch], lm_calls, bf16, reps)
        if batch == 1:
            launches["flash_attention"] = counts["flash_attention"]
    # a short prompt: auto takes the plain path, as the JAX package does
    short = TextRun(module, (LLAMA_SHORT,), LLAMA_SHORT, dev, seed=5)
    drive(tag, f"llama bf16 {LLAMA_SHORT}-token prompt", short, lm_calls,
          dict(bf16, flash_attention=0, flash_attention_sm90=0), reps=1)
    profile_request(tag, "llama bf16", runs[1])
    # beam-4 at batch 1: K5 in the prefill, K3 over the 4 beam rows
    beam = TextRun(module, (LLAMA_BEAM_PROMPT,), LLAMA_BEAM_PROMPT, dev, seed=6, new_tokens=LLAMA_BEAM_NEW)
    counts = drive(tag, f"llama bf16 beam-4 ({LLAMA_BEAM_PROMPT}-token prompt, {LLAMA_BEAM_NEW} new tokens)",
                   beam.variant(num_beams=4), lm_calls, bf16, reps=SECONDARY_REPS)
    launches["decode_attention_stacked_bf16 at text-LM beam-4"] = counts["decode_attention_stacked_bf16"]
    run_text_decoding_modes(tag, runs[1], lm_calls, launches)
    t0 = time.perf_counter()
    run_sentence_tools(tag, module, lm_calls, launches, phase16)
    _phase16_took(tag, "(d)", t0)

    # prefill logits through K5 against the plain path on the same ids
    k5_logits = runs[1].prefill_logits()
    set_default_attention_impl("xla")
    try:
        plain_logits = runs[1].prefill_logits()
    finally:
        set_default_attention_impl("auto")
    a, b = k5_logits[0].float(), plain_logits[0].float()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    rel = ((a - b).abs().max() / b.abs().max()).item()
    same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"[{tag}] llama prefill logits K5 vs plain over {a.shape[0]} positions: min_cosine={cos} "
          f"max_rel_err={rel} same_argmax_share={same}")
    assert bool(torch.isfinite(a).all()) and cos > 0.999 and rel < 5e-2, (cos, rel)
    del plain_logits, a, b

    t0 = time.perf_counter()
    quantize_model_(module, int8_lm=True, int8_kv=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"[{tag}] llama quantized in place (int8_lm, int8_kv) in {time.perf_counter() - t0} s; "
          f"memory_allocated_bytes={torch.cuda.memory_allocated()}")
    int8 = dict.fromkeys(counters(), 0)
    int8.update({"flash_attention": n_layers, "flash_attention_sm90": n_layers, "decode_attention_stacked_int8": "lm"})
    drive(tag, "llama int8 serving", runs[1], lm_calls, int8, reps=SECONDARY_REPS)
    profile_request(tag, "llama int8 serving", runs[1])
    a = runs[1].prefill_logits()[0].float()
    b = k5_logits[0].float()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"[{tag}] llama int8 prefill logits vs bf16 over {a.shape[0]} positions: "
          f"min_cosine={cos.min().item()} mean_cosine={cos.mean().item()} same_argmax_share={same}")
    assert bool(torch.isfinite(a).all()), "non-finite int8 prefill logits"
    assert cos.min().item() > INT8_MIN_COSINE, cos.min().item()


def _same_tokens_as_plain(tag: str, label: str, run) -> None:
    """The run's tokens through the kernels equal those of the same model on
    the plain path (every wrapper swapped for its twin, which launches
    nothing; a sampling run's generator is seeded anew for each, so both
    draw the same noise), and its prefill logits agree to 1e-4 relative."""
    reset_counters()
    tokens = run.generate()
    logits = run.prefill_logits() if isinstance(run, TextRun) else run.prefill_logits(run.embeds())
    torch.cuda.synchronize()
    assert any(counters().values()), "the kernel path launched no kernel"
    reset_counters()
    with plain_kernels():
        plain_tokens = run.generate()
        plain_logits = run.prefill_logits() if isinstance(run, TextRun) else run.prefill_logits(run.embeds())
    torch.cuda.synchronize()
    assert not any(counters().values()), f"the plain path launched a kernel: {counters()}"
    a, b = logits.float(), plain_logits.float()
    rel = ((a - b).abs().max() / b.abs().max()).item()
    same = bool(torch.equal(tokens, plain_tokens))
    print(f"[{tag}] {label}: tokens {tokens[0].tolist()} vs plain path {plain_tokens[0].tolist()}: "
          f"identical={same}; prefill logits max_rel_err={rel}")
    assert same, "tokens differ from the plain path"
    assert bool(torch.isfinite(a).all()) and rel < 1e-4, rel


def f32_cut_config():
    """The eilev-blip2-opt-2.7b widths with F32_LAYERS ViT, Q-Former and OPT
    layers: the fp32 runs' model."""
    from eilev_tpu_torch import configs

    base = configs.blip2_opt_2_7b()
    return dataclasses.replace(
        base,
        vision_config=dataclasses.replace(base.vision_config, num_hidden_layers=F32_LAYERS),
        qformer_config=dataclasses.replace(base.qformer_config, num_hidden_layers=F32_LAYERS),
        text_config=dataclasses.replace(base.text_config, num_hidden_layers=F32_LAYERS))


def run_icl_evaluator_f32(tag: str, dev: torch.device) -> None:
    """ICL (d): IclEvaluator end to end in fp32 (its default dtype) on the
    fp32 model of the eilev-blip2-opt-2.7b widths at F32_LAYERS layers a
    stack (built on the card by default): 8 eval datapoints of synthesized
    uint8 videos (FRAMES x 224^2) with labels from the class sets, 4 shots a
    row drawn with replacement from 8 train datapoints, batch 4, the 187 verb
    and 788 noun prompts, with and without the feature cache. The prompts are
    left-padded to 64-multiples, so the fp32 K1/K2 bodies run on padded rows.
    Predictions and both F1s must equal the same evaluator's on the plain
    path on the card."""
    from eilev_tpu_torch.eval import IclEvaluator
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration

    cfg = f32_cut_config()
    model = VideoBlipForConditionalGeneration(cfg).eval()
    assert next(model.parameters()).dtype == torch.float32
    random_init_(model, torch.Generator(device=dev).manual_seed(46), std=0.02)
    verbs, nouns = icl_class_sets()
    rng = np.random.default_rng(7)
    verb_keys, noun_keys = list(verbs), list(nouns)

    def datapoint(i):
        v, n = verb_keys[rng.integers(len(verb_keys))], noun_keys[rng.integers(len(noun_keys))]
        return {"frame_path": f"clip{i}|0", "narration_text": f"#C C {v} {n}", "structured_verb": verbs[v],
                "structured_noun": nouns[n],
                "video": rng.integers(0, 256, (3, FRAMES, 224, 224), dtype=np.uint8)}

    eval_ds = [datapoint(i) for i in range(8)]
    train = [datapoint(100 + i) for i in range(8)]
    kw = dict(verb_prompts=verbs, noun_prompts=nouns, verbs=sorted(set(verbs.values())),
              nouns=sorted(set(nouns.values())), num_shot=4, device=dev)
    n = F32_LAYERS
    for vision_cache in (None, 64):
        results = {}
        for path in ("kernels", "plain path"):
            reset_counters()
            with plain_kernels() if path == "plain path" else contextlib.nullcontext():
                ev = IclEvaluator(model, WordTokenizer(), rng=random.Random(42), vision_cache=vision_cache, **kw)
                results[path] = ev.evaluate(eval_ds, train, batch_size=ICL_BATCH)
            torch.cuda.synchronize()
            counts = counters()
            print(f"[{tag}] ICL (d) fp32 IclEvaluator (2+2+2 layers, vision_cache={vision_cache}), {path}: "
                  f"verb_f1={results[path].verb_f1} noun_f1={results[path].noun_f1} launches {counts}")
            if path == "plain path":
                assert not any(counts.values()), counts
                continue
            # two batches of 4, two stages each: K2 once per OPT layer and
            # stage; K1 once per ViT layer and encode (each stage's, or the
            # cache's buckets of misses); all through the fp32 bodies
            assert counts["packed_qkv_causal_attention"] == counts["packed_qkv_causal_attention_f32"] == 4 * n
            assert counts["packed_qkv_attention"] == counts["packed_qkv_attention_f32"] > 0
            if vision_cache is None:
                assert counts["packed_qkv_attention"] == 4 * n, counts
        ours, ref = results["kernels"], results["plain path"]
        same = (ours.verb_predictions == ref.verb_predictions and ours.noun_predictions == ref.noun_predictions
                and (ours.verb_f1, ours.noun_f1) == (ref.verb_f1, ref.noun_f1))
        print(f"[{tag}] ICL (d) vision_cache={vision_cache}: predictions and F1s identical to the plain path="
              f"{same}; verb predictions {[p['prediction'] for p in ours.verb_predictions]}")
        assert same, "the fp32 evaluator's predictions differ from the plain path's"
    del model
    gc.collect()
    torch.cuda.empty_cache()


def run_f32_paths(tag: str, dev: torch.device, launches: dict) -> None:
    """Phase 8: the fp32 bodies on the main paths. The narration model by its
    default construction, VideoBlipForConditionalGeneration(cfg) with no
    device or dtype (the card, fp32), at the eilev-blip2-opt-2.7b widths with
    F32_LAYERS ViT, Q-Former and OPT layers, batch 1, F32_NEW_TOKENS new
    tokens: K1, K2 and K3 through their fp32 bodies, tokens identical to the
    plain path's; K6's fp32 body over its ViT layers; then its int8 KV cache
    (K4 with an fp32 query). Then the text-only module of TextLM in fp32 at
    the Llama-2-7b widths with F32_LAYERS layers and the 1,984-token prompt,
    so that auto takes K5: K5 and K3 through their fp32 bodies, tokens
    identical to the plain path's."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation.text_lm import _TextOnlyModule
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops.quantization import quantize_model_

    cfg = f32_cut_config()
    model = VideoBlipForConditionalGeneration(cfg).eval()
    param = next(model.parameters())
    assert param.dtype == torch.float32 and param.is_cuda, (param.dtype, param.device)
    random_init_(model, torch.Generator(device=dev).manual_seed(44), std=0.02)
    lm_calls: list = []
    model.language_model.register_forward_hook(
        lambda mod, args, out: lm_calls.append((args[0].shape[1], torch.isfinite(out[0]).all()))
    )
    run = Narration(model, cfg, 1, dev, dtype=torch.float32, new_tokens=F32_NEW_TOKENS)
    want = dict.fromkeys(counters(), 0)
    want.update({"packed_qkv_attention": F32_LAYERS, "packed_qkv_attention_f32": F32_LAYERS,
                 "packed_qkv_causal_attention": F32_LAYERS, "packed_qkv_causal_attention_f32": F32_LAYERS,
                 "decode_attention_stacked_f32": "lm"})
    counts = drive(tag, "fp32 narration (default construction, 2+2+2 layers)", run, lm_calls, want, reps=1)
    launches.update({k: counts[k] for k in
                     ("packed_qkv_attention_f32", "packed_qkv_causal_attention_f32", "decode_attention_stacked_f32")})
    _same_tokens_as_plain(tag, "fp32 narration", run)
    for label, variant in (
        ("beam-5", run.variant(**BEAM_KNOBS)),
        ("beam_sample", run.variant(seed=GEN_SEED, **BEAM_KNOBS, **SAMPLE_KNOBS)),
        ("sampling, 2 sequences a row", run.variant(seed=GEN_SEED, num_return_sequences=2, **SAMPLE_KNOBS)),
    ):
        _same_tokens_as_plain(tag, f"fp32 narration {label}", variant)
    run_decoding_modes_f32(tag, run)
    run_k6_on_vit_layers(tag, model, run, launches, tol=F32_TOL)

    quantize_model_(model, int8_kv=True)
    want.update({"decode_attention_stacked_f32": 0, "decode_attention_stacked_int8": "lm",
                 "decode_attention_stacked_int8_f32": "lm"})
    counts = drive(tag, "fp32 narration, int8 KV cache", run, lm_calls, want, reps=1)
    launches["decode_attention_stacked_int8_f32"] = counts["decode_attention_stacked_int8_f32"]
    _same_tokens_as_plain(tag, "fp32 narration, int8 KV cache", run)
    run_decoding_modes_f32(tag, run, int8=True)
    del model, run, lm_calls
    gc.collect()
    torch.cuda.empty_cache()

    cfg = configs.VideoBlipConfig(text_config=configs.LlamaConfig(num_hidden_layers=F32_LAYERS))
    module = _TextOnlyModule(cfg, device=dev, dtype=torch.float32).eval()
    random_init_(module, torch.Generator(device=dev).manual_seed(45), std=0.02)
    lm_calls = []
    module.language_model.register_forward_hook(
        lambda mod, args, out: lm_calls.append((args[0].shape[1], torch.isfinite(out[0]).all()))
    )
    run = TextRun(module, (LLAMA_PROMPT,), LLAMA_PROMPT, dev, seed=3)
    want = dict.fromkeys(counters(), 0)
    want.update({"flash_attention": F32_LAYERS, "flash_attention_f32": F32_LAYERS,
                 "decode_attention_stacked_f32": "lm"})
    counts = drive(tag, "fp32 text LM (Llama-2-7b widths, 2 layers)", run, lm_calls, want, reps=1)
    launches["flash_attention_f32"] = counts["flash_attention_f32"]
    _same_tokens_as_plain(tag, "fp32 text LM", run)
    _same_tokens_as_plain(tag, "fp32 text LM beam-4", run.variant(num_beams=4))


# ---------------------------------------------------------------------------
# phase 8b: the T5 family
# ---------------------------------------------------------------------------


class T5Narration(Narration):
    """The main path's inputs for the flan-t5 LM: build_prompt's T5 layout
    (766 tokens), pad 0, eos flan-t5's; tokens start with the decoder start
    token."""

    t5 = True
    pad_token_id, eos_token_id = 0, (T5_EOS,)

    @torch.inference_mode()
    def prefill_logits(self, embeds):
        """The prompt's pass, the encoder states (B, S, d_model) (T5 has no
        prefill: what _same_tokens_as_plain holds to 1e-4 besides the tokens)."""
        return self.model.t5_encode(embeds, self.mask)


class T5WordTokenizer(WordTokenizer):
    """WordTokenizer with flan-t5's special ids (pad 0, eos 1 appended, no
    bos; "\n" its whitespace token), every id below its vocabulary."""

    bos_token_id = None
    pad_token_id = 0
    eos_token_id = T5_EOS

    def __init__(self):
        self.vocab = {"\n": T5_NEWLINE}

    def __call__(self, text: str, add_special_tokens: bool = True, **kwargs):
        ids = [self.vocab.setdefault(w, 999 + len(self.vocab)) for w in re.findall(r"\n|\S+", text)]
        assert max(ids, default=0) < 32128, "word ids past flan-t5's vocabulary"
        return {"input_ids": ids + ([self.eos_token_id] if add_special_tokens else [])}


def t5_config(layers=None):
    """eilev-blip2-flan-t5-xl's geometry, each stack cut to ``layers`` when given."""
    from eilev_tpu_torch import configs

    cfg = configs.blip2_flan_t5_xl()
    if layers is None:
        return cfg
    return dataclasses.replace(
        cfg,
        vision_config=dataclasses.replace(cfg.vision_config, num_hidden_layers=layers),
        qformer_config=dataclasses.replace(cfg.qformer_config, num_hidden_layers=layers),
        text_config=dataclasses.replace(cfg.text_config, num_layers=layers, num_decoder_layers=layers))


def t5_step_log(model) -> list:
    """(tokens in, all logits finite) of every T5 decoder step, read at the
    LM head, so that drive counts the steps as one-token forwards."""
    calls: list = []
    model.language_model.lm_head.register_forward_hook(
        lambda mod, args, out: calls.append((args[0].shape[1], torch.isfinite(out).all())))
    return calls


def t5_counts(cfg, flash: bool, f32: bool = False) -> dict:
    """Launches per T5 request: K1 once per ViT layer; under "flash" K5 once
    per Q-Former attention (self in every layer, cross every
    cross_attention_frequency), per encoder layer, and twice per decoder
    layer and step (self and cross); nothing else. In bf16 the Q-Former's
    and the encoder's take K5's Hopper body, the decoder steps its decode
    body."""
    want = dict.fromkeys(counters(), 0)
    names = ["packed_qkv_attention"] + (["packed_qkv_attention_f32"] if f32 else [])
    want.update(dict.fromkeys(names, cfg.vision_config.num_hidden_layers))
    if flash:
        q, t = cfg.qformer_config, cfg.text_config
        n_qf = q.num_hidden_layers + len(range(0, q.num_hidden_layers, q.cross_attention_frequency))

        def k5(steps: int) -> int:
            return n_qf + t.num_layers + 2 * t.num_decoder_layers * steps

        want.update(dict.fromkeys(["flash_attention"] + (["flash_attention_f32"] if f32 else []), k5))
        if not f32:
            want["flash_attention_sm90"] = n_qf + t.num_layers
            want["flash_attention_decode"] = lambda steps: 2 * t.num_decoder_layers * steps
    return want


def t5_greedy_with_logits(run):
    """The run's greedy tokens and the last-position logits of each of its
    decoder steps, in order (entry t chose generated token t)."""
    rec: list = []
    handle = run.model.language_model.lm_head.register_forward_hook(
        lambda mod, args, out: rec.append(out[:, -1].float()))
    try:
        tokens = run.variant().generate()
    finally:
        handle.remove()
    torch.cuda.synchronize()
    return tokens, rec


@contextlib.contextmanager
def attention_impl(impl: str):
    """The dispatcher's default set to ``impl``, and back to "auto"."""
    from eilev_tpu_torch.ops.attention import set_default_attention_impl

    set_default_attention_impl(impl)
    try:
        yield
    finally:
        set_default_attention_impl("auto")


def t5_step_counts(cfg, flash: bool, f32: bool) -> dict:
    """Launches of one T5 decoder step: under "flash" K5 twice a decoder
    layer (self and cross), on its decode body in bf16, its fp32 body in
    fp32; nothing else (under "auto" the steps are plain)."""
    want = dict.fromkeys(counters(), 0)
    if flash:
        n = 2 * cfg.text_config.num_decoder_layers
        want.update(dict.fromkeys(["flash_attention", "flash_attention_f32" if f32 else "flash_attention_decode"], n))
    return want


def _clone_cache(cache: dict) -> dict:
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in cache.items()}


@torch.inference_mode()
def t5_candidates_check(tag: str, label: str, run, cfg, flash: bool, f32: bool) -> dict:
    """8b (f): contrastive search's T5 helpers on the run's model (which
    generate does not reach: JAX and the port refuse T5 contrastive search).
    Encode the request, commit T5_COMMITTED decoder steps (the start token,
    then greedy) through t5_decode_step_hidden, each counted (counters at 0
    just before, read just after: t5_step_counts) and its logits equal to
    t5_decode_step's on a clone of the cache, bit for bit; then expand the
    top T5_CANDIDATES tokens of the last step's logits with t5_candidates:
    no launch (plain einsums, as in JAX), every cache tensor and the index
    unchanged (torch.equal), and each candidate's hidden against the hidden
    t5_decode_step_hidden gives when that token is committed on a clone of
    the cache: bf16 min cosine > 0.999, fp32 within F32_TOL. Returns the
    numbers, the candidates' and a committed step's host times beside."""
    from eilev_tpu_torch.generation.decoding import _t5_cache

    t0 = time.perf_counter()
    model = run.model
    mask = run.mask
    cache = _t5_cache(model, run.embeds(), mask, run.new_tokens)
    tok = torch.full((run.batch, 1), cfg.text_config.decoder_start_token_id, dtype=torch.int64, device=mask.device)
    want = t5_step_counts(cfg, flash, f32)
    for step in range(T5_COMMITTED):
        plain, _ = model.t5_decode_step(tok, None, mask, _clone_cache(cache))
        reset_counters()
        logits, hidden, cache = model.t5_decode_step_hidden(tok, None, mask, cache)
        torch.cuda.synchronize()
        counts = counters()
        assert counts == want, (label, step, counts, want)
        assert torch.equal(logits, plain), f"{label}: t5_decode_step_hidden's logits differ from t5_decode_step's"
        assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(hidden).all()), (label, step)
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
    top = logits[:, -1].float().topk(T5_CANDIDATES, dim=-1).indices  # (B, C)
    before = _clone_cache(cache)
    reset_counters()
    cand = model.t5_candidates(top, mask, cache)
    torch.cuda.synchronize()
    assert not any(counters().values()), f"{label}: t5_candidates launched a kernel: {counters()}"
    assert cand.shape == (run.batch, T5_CANDIDATES, cfg.text_config.d_model), cand.shape
    assert cache.keys() == before.keys() and cache["index"] == before["index"] == T5_COMMITTED, cache["index"]
    for key in ("k", "v", "cross_k", "cross_v"):
        assert torch.equal(cache[key], before[key]), f"{label}: t5_candidates wrote the cache's {key}"
    cosines, errs = [], []
    for c in range(T5_CANDIDATES):
        _, committed, _ = model.t5_decode_step_hidden(top[:, c : c + 1], None, mask, _clone_cache(cache))
        a, b = cand[:, c].float(), committed[:, 0].float()
        cosines.append(torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item())
        errs.append((a - b).abs().max().item())
    out = {"batch": run.batch, "committed_steps": T5_COMMITTED, "candidates": T5_CANDIDATES,
           "step_launches": {k: v for k, v in want.items() if v}, "candidates_launches": 0,
           "min_cosine": min(cosines), "max_abs_err": max(errs)}

    def host_ms(fn) -> float:
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    out["candidates_host_ms"] = host_ms(lambda: model.t5_candidates(top, mask, cache))
    # a shallow copy: the step writes slot `index` (which candidates never
    # read) and advances only the copy's index
    out["committed_step_host_ms"] = host_ms(lambda: model.t5_decode_step_hidden(top[:, :1], None, mask, dict(cache)))
    out["seconds"] = time.perf_counter() - t0
    print(f"[{tag}] T5 (f) {label}: {json.dumps(out)}")
    if f32:
        assert out["max_abs_err"] <= F32_TOL, out
    else:
        assert out["min_cosine"] > 0.999, out
    return out


def run_t5(tag: str, dev: torch.device, launches: dict) -> dict:
    """Phase 8b: the T5 path at the eilev-blip2-flan-t5-xl widths (1408,
    768, 2048, 32 heads x 64, gated-gelu FFN 5,120, vocab 32,128, untied
    head), T5_LAYERS a stack, with random bf16 weights N(0, 0.02) from
    T5_SEED: (a) greedy narration, 32 new tokens, at batch 1 and 4 under
    "auto" (K1 = T5_LAYERS, nothing else), p50 of SECONDARY_REPS warm requests, peak
    memory, a profiler pass at batch 1; (b) the same under "flash" (K5 for
    each Q-Former attention and encoder layer, two a decoder layer and step;
    the bias form on every T5 attention), the encoder states' min cosine against (a)'s > 0.999, tokens
    equal to (a)'s or parting at a near-tie (NEAR_TIE); (c) beam-5 at batch 1 (the reorder
    gathers the cross K/V too), p50; (d) seq2seq classify of the 187-verb
    stage at batch 4 against the plain path (score_bar); (e) the fp32 model
    at F32_LAYERS a stack by its default construction, greedy tokens and
    encoder states equal to the plain twins' under "auto" and "flash" (K5's
    fp32 body with the bias); (f) contrastive search's helpers
    (t5_candidates_check) on (b)'s batch-4 request under "flash" and on (e)'s
    under both. Depth cuts: T5_LAYERS (6) a stack for (a)-(d) and (f) in
    bf16, F32_LAYERS (2) for (e) and (f) in fp32 (flan-t5-xl has 24 + 24,
    its ViT 39). Returns the numbers for the T5 JSON line."""
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration

    t_phase = time.perf_counter()
    result: dict = {"model": f"eilev-blip2-flan-t5-xl widths, {T5_LAYERS} layers a stack, random bf16 N(0, 0.02)"}
    cfg = t5_config(T5_LAYERS)
    model = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(T5_SEED), std=0.02)
    print(f"[{tag}] T5 model eilev-blip2-flan-t5-xl bf16 params={sum(p.numel() for p in model.parameters())}")
    calls = t5_step_log(model)
    runs = {batch: T5Narration(model, cfg, batch, dev) for batch in (1, 4)}
    n_dec = cfg.text_config.num_decoder_layers

    # (a) auto, (b) flash, at batch 1 and 4
    for batch in (1, 4):
        run = runs[batch]
        stats: dict = {}
        counts = drive(tag, "T5 (a) greedy bf16 auto", run, calls, t5_counts(cfg, flash=False), reps=SECONDARY_REPS,
                       stats=stats)
        launches["packed_qkv_attention at the T5 path"] = counts["packed_qkv_attention"]
        result[f"greedy_b{batch}"] = {"p50_s": stats["p50_s"], "videos_per_s": run.n_videos / stats["p50_s"],
                                      "peak_bytes": stats["peak_bytes"], "decoder_steps": stats["one_token_forwards"]}
        if batch == 1:
            result["profile_b1"] = profile_request(tag, "T5 narration bf16 auto", run)
        greedy, rec = t5_greedy_with_logits(run)
        enc = run.prefill_logits(run.embeds())
        with attention_impl("flash"):
            stats = {}
            counts = drive(tag, "T5 (b) greedy bf16 flash", run, calls, t5_counts(cfg, flash=True),
                           reps=SECONDARY_REPS, stats=stats)
            steps = stats["one_token_forwards"]
            flash_tokens, flash_enc = stats["tokens"], run.prefill_logits(run.embeds())
        cos = torch.nn.functional.cosine_similarity(flash_enc.float(), enc.float(), dim=-1).min().item()
        print(f"[{tag}] T5 (b) batch={batch} encoder states flash vs auto: min_cosine over positions={cos}")
        assert cos > 0.999, cos
        share = compare_speculative(tag, f"T5 (b) flash vs auto greedy batch {batch}", flash_tokens[:, 1:],
                                    greedy[:, 1:], rec)
        result[f"flash_b{batch}"] = {"p50_s": stats["p50_s"], "encoder_min_cosine": cos,
                                     "rows_identical_share": share, "k5_launches": counts["flash_attention"]}
        launches[f"flash_attention at T5 encoder, batch {batch}"] = cfg.text_config.num_layers
        if batch == 4:
            q_cfg = cfg.qformer_config
            launches["flash_attention at T5 decoder self, batch 4"] = n_dec * steps
            launches["flash_attention at T5 cross, batch 4"] = n_dec * steps
            launches["flash_attention at Q-Former self, 68 videos"] = q_cfg.num_hidden_layers
            launches["flash_attention at Q-Former cross, 68 videos"] = len(
                range(0, q_cfg.num_hidden_layers, q_cfg.cross_attention_frequency))

    print(f"[{tag}] T5 (a) and (b) took {time.perf_counter() - t_phase} s")

    # (c) beam-5 at batch 1
    stats = {}
    drive(tag, "T5 (c) beam-5 (length_penalty -1)", runs[1].variant(**BEAM_KNOBS), calls,
          t5_counts(cfg, flash=False), reps=SECONDARY_REPS, stats=stats)
    result["beam5_b1"] = {"p50_s": stats["p50_s"], "peak_bytes": stats["peak_bytes"]}

    # (d) seq2seq classify, the verb stage at batch 4, kernels vs plain path
    verbs, nouns = icl_class_sets()
    req = IclBatch(model, T5WordTokenizer(), [icl_narrations(verbs, nouns, np.random.default_rng(5))] * ICL_BATCH,
                   dev)
    reset_counters()
    scores = req.classify(" The camera wearer", list(verbs))
    torch.cuda.synchronize()
    counts = counters()
    want = t5_counts(cfg, flash=False)
    assert counts == want, (counts, want)
    with plain_kernels():
        ref = req.classify(" The camera wearer", list(verbs))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        req.classify(" The camera wearer", list(verbs))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    err = score_bar(tag, "T5 (d) seq2seq classify, verb stage bf16 batch 4, kernels vs plain path", scores, ref)
    print(f"[{tag}] T5 (d) classify verb stage batch 4: launches {counts} classify_s={times}")
    result["classify_verbs_b4"] = {"p50_s": statistics.median(times), "max_abs_err": err}

    # (f) contrastive search's helpers, bf16 batch 4 under "flash"
    with attention_impl("flash"):
        result["candidates_bf16_flash_b4"] = t5_candidates_check(tag, "bf16 flash batch 4", runs[4], cfg, True, False)
    del model, runs, req, calls
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] T5 (a)-(d) took {time.perf_counter() - t_phase} s")

    # (e) fp32 at the phase-8 cut, both dispatches, against the plain twins
    cfg = t5_config(F32_LAYERS)
    model = VideoBlipForConditionalGeneration(cfg).eval()
    assert next(model.parameters()).dtype == torch.float32
    random_init_(model, torch.Generator(device=dev).manual_seed(T5_SEED + 1), std=0.02)
    calls = t5_step_log(model)
    run = T5Narration(model, cfg, 1, dev, dtype=torch.float32, new_tokens=F32_NEW_TOKENS)
    for impl in ("auto", "flash"):
        with attention_impl(impl):
            counts = drive(tag, f"T5 (e) fp32 {impl} (2+2+2+2 layers)", run, calls,
                           t5_counts(cfg, flash=impl == "flash", f32=True), reps=1)
            _same_tokens_as_plain(tag, f"T5 (e) fp32 {impl}", run)
            result[f"candidates_f32_{impl}_b1"] = t5_candidates_check(tag, f"fp32 {impl} batch 1", run, cfg,
                                                                     impl == "flash", True)
        if impl == "flash":
            launches["flash_attention_f32 at the T5 path"] = counts["flash_attention_f32"]
            launches["flash_attention_f32 at T5 encoder, batch 1"] = cfg.text_config.num_layers
    del model, run, calls
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] T5 phase took {time.perf_counter() - t_phase} s")
    return result


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------


def _train_batch(cfg, micro: int, dev, dtype=torch.bfloat16, seq: int = TRAIN_SEQ) -> dict:
    """The JAX training bench's batch (benchmarks/train_step_bench.py): bench's
    16-shot prompt for ``micro`` datapoints padded to ``seq`` tokens, labels
    -100 on the video slots and the padding, uint8 frames from a seed through
    process_videos; a leading micro-batch axis of 1."""
    from eilev_tpu_torch.ops.preprocess import process_videos

    ids, mask, vim = build_prompt(cfg.num_query_tokens, micro)
    pad = ((0, 0), (0, seq - ids.shape[1]))
    ids, mask, vim = np.pad(ids, pad, constant_values=1), np.pad(mask, pad), np.pad(vim, pad)
    labels = np.where((vim == 1) | (mask == 0), -100, ids)
    frames = np.random.default_rng(2).integers(0, 256, size=(micro * (SHOTS + 1), 3, FRAMES, 224, 224),
                                               dtype=np.uint8)
    batch = {k: torch.from_numpy(v).to(dev)[None] for k, v in
             (("input_ids", ids), ("attention_mask", mask), ("video_input_mask", vim), ("labels", labels))}
    batch["pixel_values"] = process_videos(torch.from_numpy(frames).to(dev), dtype=dtype)[None]
    return batch


def _loss_and_grads(model, batch: dict, seed) -> tuple[torch.Tensor, dict]:
    """The training forward's loss and trainable gradients on micro-batch 0;
    dropout on with masks from a generator seeded ``seed``, off for None."""
    from eilev_tpu_torch.ops.dropout import DropoutRng
    from eilev_tpu_torch.training import partition_params

    trainable, _ = partition_params(dict(model.named_parameters()))
    model.train(seed is not None)
    rng = None if seed is None else DropoutRng.seeded(seed, next(model.parameters()).device)
    loss = model(**{k: v[0] for k, v in batch.items()}, dropout_rng=rng)["loss"]
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return loss.detach().float(), {k: g.float() for k, g in zip(trainable, grads)}


def unit_norms_(model: torch.nn.Module) -> None:
    """Every LayerNorm's scale 1 and bias 0, as the models' own initialisation
    sets them. The full-width gradient checks run so: at bench.py's
    N(0, 0.02) scales the gradient fades back through the Q-Former's 12
    post-LN layers to rounding noise in half of its leaves, which leaves
    nothing to compare."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


# the attention key biases: a bias on every key shifts a whole score row,
# which softmax ignores, so the exact gradient is 0 and each path's is
# rounding noise with no direction to compare
KEY_BIAS = ".attention.key.bias"


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine of two gradients in float64, without F.cosine_similarity's
    1e-8 floor on the norms' product (a small leaf's norms are below it)."""
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = float(a.norm()), float(b.norm())
    return 1.0 if na == nb == 0.0 else float(a @ b) / (na * nb)


def _compare_grads(tag: str, label: str, loss, ref_loss, grads, ref, loss_tol: float, zero_share: float,
                   min_cos=None, rel_tol=None):
    """The loss within ``loss_tol`` relative of the reference path's; the
    whole trainable gradient (every leaf, concatenated) and each leaf but the
    key biases by cosine (> ``min_cos``) or by error relative to the leaf's
    largest element (< ``rel_tol``); each key bias's norm below
    ``zero_share`` of the largest leaf norm on both paths."""
    loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    top = max(float(g.norm()) for g in ref.values())
    whole_cos = _cosine(torch.cat([g.flatten() for g in grads.values()]),
                        torch.cat([ref[k].flatten() for k in grads]))
    worst_cos, worst_rel, zero, rows = 1.0, 0.0, {}, []
    for name, g in grads.items():
        r = ref[name]
        if name.endswith(KEY_BIAS):
            zero[name] = max(float(g.norm()), float(r.norm())) / top
            continue
        cos, rel = _cosine(g, r), float((g - r).abs().max() / r.abs().max())
        rows.append((cos, rel, name, float(g.norm()), float(r.norm())))
        worst_cos, worst_rel = min(worst_cos, cos), max(worst_rel, rel)
    print(f"[{tag}] {label}: loss={float(loss)} reference_loss={float(ref_loss)} loss_rel_err={loss_rel} "
          f"leaves={len(grads)} whole_gradient_cosine={whole_cos} compared_leaves={len(rows)} "
          f"min_leaf_cosine={worst_cos} max_leaf_rel_err={worst_rel} key_bias_leaves={len(zero)} "
          f"(max norm share {max(zero.values(), default=0.0)}) largest_leaf_norm={top}")
    for cos, rel, name, gnorm, rnorm in sorted(rows)[:3]:
        print(f"[{tag}]   leaf {name}: cosine={cos} rel_err={rel} norm={gnorm} reference_norm={rnorm}")
    assert bool(torch.isfinite(loss)) and loss_rel < loss_tol, loss_rel
    assert len(rows) + len(zero) == len(ref) and zero, (len(rows), len(zero), len(ref))
    assert min_cos is None or (worst_cos > min_cos and whole_cos > min_cos), (worst_cos, whole_cos)
    assert rel_tol is None or worst_rel < rel_tol, worst_rel
    assert all(share < zero_share for share in zero.values()), zero
    return {"loss": float(loss), "reference_loss": float(ref_loss), "loss_rel_err": loss_rel,
            "whole_gradient_cosine": whole_cos, "min_leaf_cosine": worst_cos, "max_leaf_rel_err": worst_rel}


def _worst_leaf_err(a: tuple, b: tuple) -> tuple[float, str]:
    """The largest error, over every leaf but the key biases, of ``a``'s
    gradient against ``b``'s, relative to the leaf's largest element in ``b``."""
    return max((float((a[1][k] - g).abs().max() / g.abs().max()), k) for k, g in b[1].items()
               if not k.endswith(KEY_BIAS))


def _assert_bit_identical(tag: str, label: str, a: tuple, b: tuple) -> None:
    """The loss and every trainable gradient of ``a`` equal to ``b``'s, bit for bit."""
    loss, grads = a
    ref_loss, ref = b
    unequal = [k for k, g in grads.items() if not torch.equal(g, ref[k])]
    print(f"[{tag}] {label}: loss={float(loss)} reference_loss={float(ref_loss)} leaves={len(grads)} "
          f"bit_identical_leaves={len(grads) - len(unequal)} loss_bit_identical={bool(torch.equal(loss, ref_loss))}")
    assert torch.equal(loss, ref_loss) and not unequal and grads.keys() == ref.keys(), unequal[:5]


class TrainRun:
    """One train step of a variant, shaped for ``profile_request`` (which
    calls ``generate`` and reads ``batch``)."""

    def __init__(self, model, batch: dict, micro: int):
        from eilev_tpu_torch.training import (OptimizerConfig, TrainState, make_optimizer, make_train_step,
                                              partition_params)

        trainable, _ = partition_params(dict(model.named_parameters()))
        self.state = TrainState.create(trainable, make_optimizer(OptimizerConfig()))
        self.step_fn = make_train_step(model, accum_steps=1, dropout=True)
        self.batch_tensors, self.batch = batch, micro
        self.metrics = None

    def generate(self):
        self.state, self.metrics = self.step_fn(self.state, self.batch_tensors)


def run_train_variants(tag: str, dev, cfg) -> tuple[list, dict]:
    """Phase 9 (a), (b), (e) and (f) (a), (c) on the full eilev-blip2-opt-2.7b
    geometry. Returns one row of numbers a variant, and (f)'s numbers."""
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops import fused_attention as fa
    from eilev_tpu_torch.training import freeze_towers

    t0 = time.perf_counter()
    model = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16, trainable_dtype=torch.float32)
    random_init_(model, torch.Generator(device=dev).manual_seed(47), std=0.02)
    trainable, frozen = freeze_towers(model)
    frozen_before = {k: p.detach().to("cpu") for k, p in frozen.items()}  # on the host: out of the peak
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in trainable.values())
    print(f"[{tag}] training model eilev-blip2-opt-2.7b bf16, fp32 trainable masters: trainable_params={n_train} "
          f"frozen_params={sum(p.numel() for p in frozen.values())} init_s={time.perf_counter() - t0}")
    n_vit = cfg.vision_config.num_hidden_layers
    lm = model.language_model
    rows = []
    for variant in TRAIN_VARIANTS:
        micro, remat = int(variant.rstrip("r")), variant.endswith("r")
        lm.config = dataclasses.replace(lm.config, remat=remat)
        run = TrainRun(model, _train_batch(cfg, micro, dev), micro)
        reset_counters()
        run.generate()  # the warm step, counted
        torch.cuda.synchronize()
        counts = counters()
        want = dict.fromkeys(counts, 0)
        want["packed_qkv_attention"] = n_vit  # 39 a micro-batch forward, no grad; K2-K6 never
        assert counts == want, f"training launches {counts}, expected {want}"
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            run.generate()
        torch.cuda.synchronize()
        s_step = (time.perf_counter() - t1) / TRAIN_STEPS
        loss, gnorm = float(run.metrics["loss"]), float(run.metrics["grad_norm"])
        print(f"[{tag}] training variant={variant} micro={micro} remat={remat} seq={TRAIN_SEQ} s_per_step={s_step} "
              f"datapoints_per_s={micro / s_step} videos_per_s={micro * (SHOTS + 1) / s_step} "
              f"max_memory_allocated_bytes={torch.cuda.max_memory_allocated()} loss={loss} grad_norm={gnorm} "
              f"launches {counts}")
        assert np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0, (loss, gnorm)
        rows.append({"variant": variant, "micro": micro, "remat": remat, "seq": TRAIN_SEQ, "s_per_step": s_step,
                     "videos_per_s": micro * (SHOTS + 1) / s_step,
                     "peak_bytes": torch.cuda.max_memory_allocated(), "k1_launches": counts["packed_qkv_attention"]})
        if variant == "1":
            profile_request(tag, "training step, variant 1", run)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    lm.config = dataclasses.replace(lm.config, remat=False)
    same = all(torch.equal(p.cpu(), frozen_before[k]) for k, p in frozen.items())
    print(f"[{tag}] training: frozen weights unchanged after {len(TRAIN_VARIANTS) * (TRAIN_STEPS + 1)} steps={same}")
    assert same, "a frozen weight moved"
    del frozen_before

    # the gradient checks, at unit LayerNorm scales: 1 against 1r on the same
    # dropout seed, bit-identical (so within 1e-3 and cosine > 0.9999 too)
    unit_norms_(model)
    batch = _train_batch(cfg, 1, dev)
    plain = _loss_and_grads(model, batch, TRAIN_DROPOUT_SEED)
    lm.config = dataclasses.replace(lm.config, remat=True)
    remat = _loss_and_grads(model, batch, TRAIN_DROPOUT_SEED)
    lm.config = dataclasses.replace(lm.config, remat=False)
    _assert_bit_identical(tag, f"training (a) 1r vs 1, dropout seed {TRAIN_DROPOUT_SEED}", remat, plain)

    # (b) K1 against its plain twin at full width, dropout off
    reset_counters()
    kernels = _loss_and_grads(model, batch, None)
    assert counters()["packed_qkv_attention"] == n_vit
    with plain_kernels():
        reset_counters()
        ref = _loss_and_grads(model, batch, None)
        assert not any(counters().values()), counters()
    _compare_grads(tag, "training (b) bf16 kernels vs plain path, dropout off", kernels[0], ref[0], kernels[1],
                   ref[1], loss_tol=2e-2, zero_share=BF16_ROUNDOFF, min_cos=0.99)

    # (e) the guard: K1 under grad on a tensor that requires grad
    qkv = torch.randn(2, 257, 3 * 16 * 88, device=dev, dtype=torch.bfloat16, requires_grad=True)
    reset_counters()
    try:
        fa.packed_qkv_attention(qkv, 16, 88)
        raised = False
    except RuntimeError as e:
        raised = "packed_qkv_attention_reference" in str(e)
    print(f"[{tag}] training (e) K1 under grad on a tensor that requires grad raised={raised} "
          f"launches={counters()['packed_qkv_attention']}")
    assert raised and counters()["packed_qkv_attention"] == 0
    del batch, plain, remat, kernels, ref
    gc.collect()
    torch.cuda.empty_cache()
    run_trainer_full(tag, dev, cfg, model, rows[0])
    parallel = run_pipeline_full(tag, dev, cfg, model)
    parallel["nccl"] = run_nccl_zero(tag, dev, cfg, model)
    del model, trainable, frozen
    gc.collect()
    torch.cuda.empty_cache()
    return rows, parallel


def _pp_loss_and_grads(model, batch: dict, stages: int, microbatches: int, dev) -> tuple[torch.Tensor, dict]:
    """``_loss_and_grads`` through training/pipeline_step's forward, the LM
    trunk a GPipe schedule of ``stages`` stages on ``dev`` (repeated), dropout
    off."""
    from eilev_tpu_torch.parallel import make_pipeline_mesh, shard_stacked
    from eilev_tpu_torch.training import partition_params
    from eilev_tpu_torch.training.pipeline_step import make_pp_forward, pp_partition_frozen

    trainable, _ = partition_params(dict(model.named_parameters()))
    mesh = make_pipeline_mesh(stages, devices=[dev] * stages)
    _, stacked = pp_partition_frozen(model, stages)
    stacked = {k: shard_stacked(v, mesh) for k, v in stacked.items()}
    model.train(False)
    loss = make_pp_forward(model, mesh, num_microbatches=microbatches)(stacked, {k: v[0] for k, v in batch.items()},
                                                                      None)
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return loss.detach().float(), {k: g.float() for k, g in zip(trainable, grads)}


def _timed_steps(step, steps: int) -> tuple[float, int, dict]:
    """One counted warm step of ``step`` (a closure over its state and
    batch), then ``steps`` timed: (s/step, peak bytes, the warm step's launches)."""
    reset_counters()
    step()
    torch.cuda.synchronize()
    counts = counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps, torch.cuda.max_memory_allocated(), counts


def run_pipeline_full(tag: str, dev, cfg, model) -> dict:
    """Phase 9 (f) (a): the full-depth OPT trunk as a PP_STAGES-stage GPipe
    schedule on the one card, PP_MICROBATCHES micro-batches of a PP_MICRO
    datapoint micro-batch; its loss and trainable gradients against the
    plain step's on the same batch, dropout off; both steps timed."""
    from eilev_tpu_torch.parallel import make_pipeline_mesh, shard_stacked
    from eilev_tpu_torch.training import (OptimizerConfig, TrainState, make_optimizer, make_train_step,
                                          partition_params)
    from eilev_tpu_torch.training.pipeline_step import make_pp_train_step, pp_partition_frozen

    t0 = time.perf_counter()
    n_vit = cfg.vision_config.num_hidden_layers
    batch = _train_batch(cfg, PP_MICRO, dev)
    reset_counters()
    pp = _pp_loss_and_grads(model, batch, PP_STAGES, PP_MICROBATCHES, dev)
    pp_counts = counters()
    plain = _loss_and_grads(model, batch, None)
    label = (f"training (f) (a) OPT trunk, {cfg.text_config.num_hidden_layers} layers as a {PP_STAGES}-stage GPipe "
             f"schedule of {PP_MICROBATCHES} micro-batches on one card vs the plain step, bf16, dropout off")
    cmp = _compare_grads(tag, label, pp[0], plain[0], pp[1], plain[1], loss_tol=2e-2, zero_share=BF16_ROUNDOFF,
                         min_cos=0.99)
    del pp, plain
    gc.collect()
    torch.cuda.empty_cache()
    want = dict.fromkeys(pp_counts, 0)
    want["packed_qkv_attention"] = n_vit  # the frozen ViT, once a micro-batch; the trunk runs plain attention
    assert pp_counts == want, f"pipeline launches {pp_counts}, expected {want}"

    trainable, _ = partition_params(dict(model.named_parameters()))
    mesh = make_pipeline_mesh(PP_STAGES, devices=[dev] * PP_STAGES)
    _, stacked = pp_partition_frozen(model, PP_STAGES)
    stacked = {k: shard_stacked(v, mesh) for k, v in stacked.items()}
    out = {"stages": PP_STAGES, "microbatches": PP_MICROBATCHES, "micro": PP_MICRO, "seq": TRAIN_SEQ,
           "devices": [str(d) for d in mesh.devices], "bubble": (PP_STAGES - 1) / (PP_MICROBATCHES + PP_STAGES - 1),
           **cmp}
    for name, make in (("pipeline", lambda: make_pp_train_step(model, mesh, stacked, dropout=False,
                                                                num_microbatches=PP_MICROBATCHES)),
                       ("plain", lambda: make_train_step(model, dropout=False))):
        runs = {"state": TrainState.create(trainable, make_optimizer(OptimizerConfig())), "step": make()}

        def step(runs=runs):
            runs["state"], runs["metrics"] = runs["step"](runs["state"], batch)

        s_step, peak, counts = _timed_steps(step, PP_STEPS)
        loss = float(runs["metrics"]["loss"])
        assert np.isfinite(loss) and counts["packed_qkv_attention"] == n_vit, (loss, counts)
        out[f"{name}_s_per_step"], out[f"{name}_peak_bytes"] = s_step, peak
        out[f"{name}_k1_launches"] = counts["packed_qkv_attention"]
        print(f"[{tag}] training (f) (a) {name} step, micro {PP_MICRO} x {TRAIN_SEQ} tokens, dropout off: "
              f"s_per_step={s_step} videos_per_s={PP_MICRO * (SHOTS + 1) / s_step} max_memory_allocated_bytes={peak} "
              f"loss={loss} launches {counts}")
        del runs
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[{tag}] training (f) (a) took {out['seconds']} s")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_nccl_zero(tag: str, dev, cfg, model) -> dict:
    """Phase 9 (f) (c): the process group on NCCL with a world of one (NCCL
    takes one rank a card), two Trainer steps with zero_shard_opt_state
    against two without, from the same weights: the trainable leaves and the
    optimizer state bit-identical; the all-reduce of the gradient's size and
    the all-gather of the ZeRO update timed."""
    import itertools
    import tempfile

    import torch.distributed as dist

    from eilev_tpu_torch.parallel import distributed
    from eilev_tpu_torch.training.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    started = distributed.initialize(dev, init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    assert started and dist.get_backend() == "nccl", dist.get_backend()
    try:
        start = {k: p.detach().clone() for k, p in model.named_parameters() if p.requires_grad}
        batch = _train_batch(cfg, 1, dev)
        runs = {}
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
            for zero in (False, True):
                with torch.no_grad():
                    for k, p in model.named_parameters():
                        if k in start:
                            p.copy_(start[k])
                conf = TrainerConfig(output_dir=os.path.join(root, str(zero)), num_train_steps=NCCL_STEPS,
                                     gradient_accumulation_steps=1, eval_steps=0, save_steps=0, log_steps=1,
                                     load_best_model_at_end=False, zero_shard_opt_state=zero)
                logs = []
                trainer = Trainer(model, conf, lambda seed: itertools.repeat(batch),
                                  logger=lambda step, m, logs=logs: logs.append(m))
                trainer.train()
                torch.cuda.synchronize()
                runs[zero] = ({k: p.detach().clone() for k, p in trainer.state.trainable.items()},
                              trainer.state.opt_state, [m["loss"] for m in logs])
                del trainer
        (a, a_opt, a_loss), (b, b_opt, b_loss) = runs[False], runs[True]

        def leaves(tree, prefix=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    yield from leaves(v, f"{prefix}{k}.")
            else:
                yield prefix, tree

        opt_a, opt_b = dict(leaves(a_opt)), dict(leaves(b_opt))
        unequal = [k for k in a if not torch.equal(a[k], b[k])]
        unequal_opt = [k for k in opt_a if not (torch.equal(opt_a[k], opt_b[k]) if isinstance(opt_a[k], torch.Tensor)
                                                 else opt_a[k] == opt_b[k])]
        # the collectives at the step's sizes: the gradient all-reduce, the ZeRO parameter all-gather
        n = sum(p.numel() for p in a.values())
        flat = torch.ones(n, dtype=torch.float32, device=dev)
        parts = [torch.empty_like(flat)]
        all_reduce_ms = median_ms(lambda: dist.all_reduce(flat), reps=5, warmup=2)
        all_gather_ms = median_ms(lambda: dist.all_gather(parts, flat), reps=5, warmup=2)
        out = {"backend": dist.get_backend(), "world": dist.get_world_size(), "steps": NCCL_STEPS,
               "trainable_elements": n, "losses": a_loss, "zero_losses": b_loss,
               "trainable_bit_identical": not unequal, "opt_state_bit_identical": not unequal_opt,
               "opt_state_leaves": len(opt_a), "all_reduce_ms": all_reduce_ms, "all_gather_ms": all_gather_ms}
        print(f"[{tag}] training (f) (c) NCCL world of one, {NCCL_STEPS} Trainer steps with zero_shard_opt_state vs "
              f"without: {out} unequal={unequal[:3]} unequal_opt={unequal_opt[:3]}")
        assert not unequal and not unequal_opt and opt_a.keys() == opt_b.keys() and a_loss == b_loss, out
        del runs, a, b, a_opt, b_opt, opt_a, opt_b, flat, parts
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _t5_train_batch(cfg, micro: int, dev, dtype=torch.float32) -> dict:
    """The T5 leg's batch: bench's 16-shot flan-t5 prompt (766 tokens) for
    ``micro`` datapoints, T5_TARGET decoder labels a row (row 0's last 8
    -100), frames from a seed; a leading micro-batch axis of 1."""
    from eilev_tpu_torch.ops.preprocess import process_videos

    ids, mask, vim = build_prompt(cfg.num_query_tokens, micro, t5=True)
    rng = np.random.default_rng(3)
    labels = rng.integers(1000, 32000, size=(micro, T5_TARGET))
    labels[0, -8:] = -100
    frames = rng.integers(0, 256, size=(micro * (SHOTS + 1), 3, FRAMES, 224, 224), dtype=np.uint8)
    batch = {k: torch.from_numpy(v).to(dev)[None] for k, v in
             (("input_ids", ids), ("attention_mask", mask), ("video_input_mask", vim), ("labels", labels))}
    batch["pixel_values"] = process_videos(torch.from_numpy(frames).to(dev), dtype=dtype)[None]
    return batch


def run_pipeline_f32(tag: str, dev) -> dict:
    """Phase 9 (f) (b): fp32 depth cuts, TF32 off: the eilev-blip2-opt-2.7b
    widths with PP_F32_LAYERS OPT layers over 2 and 4 stages, and
    eilev-blip2-flan-t5-xl with PP_F32_LAYERS encoder and decoder layers
    over 2; the loss and every trainable leaf's gradient against the plain
    step's within 1e-5 (relative to the leaf's largest element), dropout
    off, unit LayerNorm scales."""
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.training import freeze_towers

    t0 = time.perf_counter()
    base = f32_cut_config()
    opt_cfg = dataclasses.replace(base, text_config=dataclasses.replace(base.text_config,
                                                                        num_hidden_layers=PP_F32_LAYERS))
    out = {}
    for name, cfg, make_batch, stage_counts in (
            ("opt", opt_cfg, _train_batch, (2, 4)),
            ("t5", t5_config(layers=PP_F32_LAYERS), _t5_train_batch, (2,))):
        model = VideoBlipForConditionalGeneration(cfg, device=dev)  # fp32
        random_init_(model, torch.Generator(device=dev).manual_seed(49), std=0.02)
        unit_norms_(model)
        freeze_towers(model)
        batch = make_batch(cfg, PP_F32_MICRO, dev, dtype=torch.float32)
        ref = _loss_and_grads(model, batch, None)
        for stages in stage_counts:
            got = _pp_loss_and_grads(model, batch, stages, PP_F32_MICRO, dev)
            out[f"{name}_{stages}_stages"] = _compare_grads(
                tag, f"training (f) (b) fp32 {name} cut, {PP_F32_LAYERS} LM layers a stack as {stages} stages x "
                f"{PP_F32_MICRO} micro-batches vs the plain step", got[0], ref[0], got[1], ref[1], loss_tol=1e-5,
                zero_share=1e-5, rel_tol=1e-5)
        del model, batch, ref, got
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"[{tag}] training (f) (b) took {out['seconds']} s")
    return out


def _train_dataset(n: int, shots: int, seed: int) -> list:
    """In-memory interleaved datapoints: ``shots`` examples + a query, uint8
    clips (3, FRAMES, 224, 224) from a seed, narrations from a small word
    pool (no imageio or PIL needed)."""
    rng = np.random.default_rng(seed)
    verbs, nouns = ("picks up", "cuts", "washes", "opens", "stirs"), ("the knife", "an onion", "the pot", "a cup")

    def item():
        text = f"#C C {verbs[rng.integers(len(verbs))]} {nouns[rng.integers(len(nouns))]}"
        return {"narration_text": text,
                "video": rng.integers(0, 256, size=(3, FRAMES, 224, 224), dtype=np.uint8)}

    return [{"items": [item() for _ in range(shots + 1)]} for _ in range(n)]


def run_trainer_full(tag: str, dev, cfg, model, bare: dict) -> None:
    """The Trainer at variant 1 on the full geometry: batches from
    train_batch_iterator over in-memory 16-shot datapoints, augmented on the
    card in the prefetch thread while the steps run; its step time beside the
    bare step's (``bare``, variant 1's row). Updates ``model``'s trainable
    weights."""
    import tempfile

    from eilev_tpu_torch.training.data_module import train_batch_iterator
    from eilev_tpu_torch.training.trainer import Trainer, TrainerConfig

    data = _train_dataset(TRAINER_FULL_STEPS + 1, SHOTS, seed=6)

    def train_batches(seed):
        return train_batch_iterator(data, WordTokenizer(), num_query_tokens=cfg.num_query_tokens,
                                    decoder_only_lm=True, accum_steps=1, micro_batch_size=1, max_length=TRAIN_SEQ,
                                    num_frames=FRAMES, seed=seed, dtype=torch.bfloat16, device=dev)

    logs = []
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        conf = TrainerConfig(output_dir=root, num_train_steps=TRAINER_FULL_STEPS + 1, gradient_accumulation_steps=1,
                             eval_steps=0, save_steps=0, log_steps=1, load_best_model_at_end=False)
        trainer = Trainer(model, conf, train_batches, logger=lambda step, m: logs.append(m))
        trainer.train()
        torch.cuda.synchronize()
    steps = [m["step_time_sec"] for m in logs[1:]]  # the first waits for the prefetch's first batch
    mean = float(np.mean(steps))
    print(f"[{tag}] training Trainer variant 1 (train_batch_iterator, {SHOTS + 1} clips a datapoint augmented on "
          f"the card in the prefetch thread): step_time_sec={steps} mean={mean} "
          f"videos_per_s={(SHOTS + 1) / mean} bare_step_s={bare['s_per_step']} "
          f"ratio_to_bare={mean / bare['s_per_step']} losses={[m['loss'] for m in logs]}")
    assert len(steps) == TRAINER_FULL_STEPS and all(np.isfinite(m["loss"]) for m in logs), logs
    del trainer


def run_train_f32(tag: str, dev) -> None:
    """Phase 9 (c) and (d) on the fp32 model at the phase-8 depth cut."""
    import itertools
    import tempfile

    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops.preprocess import apply_train_transform, draw_train_transform
    from eilev_tpu_torch.training import OptimizerConfig, freeze_towers
    from eilev_tpu_torch.training.data_module import train_batch_iterator
    from eilev_tpu_torch.training.trainer import Trainer, TrainerConfig

    cfg = f32_cut_config()

    def model_f32():
        model = VideoBlipForConditionalGeneration(cfg, device=dev)  # fp32
        random_init_(model, torch.Generator(device=dev).manual_seed(48), std=0.02)
        freeze_towers(model)
        return model

    # (c) kernels against the plain path, dropout on, the same seed on both
    model = model_f32()
    batch = _train_batch(cfg, 1, dev, dtype=torch.float32)
    reset_counters()
    kernels = _loss_and_grads(model, batch, TRAIN_DROPOUT_SEED)
    counts = counters()
    assert counts["packed_qkv_attention"] == counts["packed_qkv_attention_f32"] == F32_LAYERS, counts
    with plain_kernels():
        ref = _loss_and_grads(model, batch, TRAIN_DROPOUT_SEED)
    _compare_grads(tag, "training (c) fp32 2+2+2 kernels vs plain path, dropout on", kernels[0], ref[0],
                   kernels[1], ref[1], loss_tol=1e-4, zero_share=1e-5, rel_tol=1e-4)
    # at unit LayerNorm scales neither fp32 path comes within 1e-4 of an fp64
    # evaluation (worst element against its leaf's largest): there the kernel
    # path is held to fp64 no farther than twice the plain path is
    unit_norms_(model)
    kernels = _loss_and_grads(model, batch, TRAIN_DROPOUT_SEED)
    with plain_kernels():
        ref = _loss_and_grads(model, batch, TRAIN_DROPOUT_SEED)
        model.double()  # the dropout masks are drawn in fp32 whatever the dtype: the same ones
        exact = _loss_and_grads(model, {k: v.double() if v.is_floating_point() else v for k, v in batch.items()},
                                TRAIN_DROPOUT_SEED)
    err_k, err_p = _worst_leaf_err(kernels, exact), _worst_leaf_err(ref, exact)
    print(f"[{tag}] training (c) fp32 2+2+2 at unit LayerNorm scales, dropout on, against the plain path in fp64: "
          f"kernels worst_leaf_rel_err={err_k[0]} ({err_k[1]}) plain worst_leaf_rel_err={err_p[0]} ({err_p[1]}) "
          f"kernels vs plain worst_leaf_rel_err={_worst_leaf_err(kernels, ref)[0]}")
    assert err_k[0] <= 2 * err_p[0], (err_k, err_p)
    del model, batch, kernels, ref, exact

    # the augmentation on the card: one bench datapoint, 17 clips
    clips = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(SHOTS + 1, 3, FRAMES, 224, 224),
                                                               dtype=np.uint8)).to(dev)
    gen = torch.Generator().manual_seed(0)

    def augment():
        return [apply_train_transform(c, draw_train_transform(gen)) for c in clips]

    augment()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        out = augment()
    torch.cuda.synchronize()
    aug_ms = (time.perf_counter() - t0) / 3 * 1e3
    assert all(bool(torch.isfinite(o).all()) and o.shape == (3, FRAMES, 224, 224) for o in out)
    print(f"[{tag}] training augmentation (train_transform, {SHOTS + 1} clips of {FRAMES} x 224^2): "
          f"ms_per_datapoint={aug_ms}")

    # (d) the Trainer: loss falls; a run saved at TRAINER_SAVE_AT and resumed
    # ends where the uninterrupted run ends
    data = _train_dataset(TRAINER_DATAPOINTS, TRAINER_SHOTS, seed=4)
    tok = WordTokenizer()

    def train_batches(seed):
        it = train_batch_iterator(data, tok, num_query_tokens=cfg.num_query_tokens, decoder_only_lm=True,
                                  accum_steps=2, micro_batch_size=1, max_length=TRAINER_MAX_LEN,
                                  num_frames=FRAMES, seed=11, device=dev)
        return itertools.islice(it, seed - TRAINER_SEED, None)

    def trainer_run(out_dir, steps, **kw):
        logs = []
        conf = dict(output_dir=out_dir, num_train_steps=steps, gradient_accumulation_steps=2,
                    optimizer=OptimizerConfig(learning_rate=TRAINER_LR, warmup_steps=0, total_steps=TRAINER_STEPS),
                    eval_steps=0, save_steps=0, log_steps=1, seed=TRAINER_SEED)
        conf = TrainerConfig(**{**conf, **kw})
        trainer = Trainer(model_f32(), conf, train_batches, logger=lambda step, m: logs.append(m))
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        return trainer, logs, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        straight, logs, wall = trainer_run(os.path.join(root, "a"), TRAINER_STEPS)
        losses = [m["loss"] for m in logs]
        print(f"[{tag}] training (d) Trainer fp32 2+2+2, {TRAINER_STEPS} steps of 2 datapoints "
              f"({TRAINER_SHOTS + 1} videos each, augmented on the card): losses={losses} wall_s={wall} "
              f"last step_time_sec={logs[-1]['step_time_sec']} videos_per_sec={logs[-1]['videos_per_sec']}")
        assert all(np.isfinite(losses)) and np.mean(losses[-2:]) < np.mean(losses[:2]), losses
        first, _, _ = trainer_run(os.path.join(root, "b"), TRAINER_SAVE_AT, save_steps=TRAINER_SAVE_AT)
        del first
        resumed, _, _ = trainer_run(os.path.join(root, "b"), TRAINER_STEPS, resume_from_checkpoint=True)
        same = all(torch.equal(p, resumed.state.trainable[k]) for k, p in straight.state.trainable.items())
        print(f"[{tag}] training (d) saved at step {TRAINER_SAVE_AT}, resumed to {resumed.state.step}: "
              f"final trainable state equal to the uninterrupted run's={same}")
        assert resumed.state.step == straight.state.step == TRAINER_STEPS and same
        del straight, resumed
    gc.collect()
    torch.cuda.empty_cache()


def run_training(tag: str, dev) -> tuple[list, dict]:
    """Phase 9. Returns the variants' rows and (f)'s numbers."""
    from eilev_tpu_torch import configs

    t0 = time.perf_counter()
    rows, parallel = run_train_variants(tag, dev, configs.blip2_opt_2_7b())
    run_train_f32(tag, dev)
    parallel["f32_cuts"] = run_pipeline_f32(tag, dev)
    parallel["card"] = tag
    print(f"[{tag}] training phase took {time.perf_counter() - t0} s")
    return rows, parallel


# ---------------------------------------------------------------------------
# phase 10: checkpoints and CLIs
# ---------------------------------------------------------------------------


T5_HF_FIELDS = ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers", "num_decoder_layers", "num_heads",
                "relative_attention_num_buckets", "relative_attention_max_distance", "layer_norm_epsilon",
                "tie_word_embeddings", "pad_token_id", "eos_token_id", "decoder_start_token_id")


def hf_config_dict(cfg) -> dict:
    """The HF Blip2Config dict (config.json) of an OPT- or T5-backed VideoBlipConfig."""
    v, q, t = cfg.vision_config, cfg.qformer_config, cfg.text_config
    fields = {
        "vision_config": (v, ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                              "image_size", "patch_size", "layer_norm_eps", "qkv_bias", "hidden_act")),
        "qformer_config": (q, ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
                               "cross_attention_frequency", "encoder_hidden_size", "layer_norm_eps", "hidden_act")),
        "text_config": (t, ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads", "ffn_dim",
                            "max_position_embeddings", "word_embed_proj_dim", "do_layer_norm_before",
                            "activation_function", "bos_token_id", "eos_token_id", "pad_token_id")),
    }
    if not cfg.use_decoder_only_language_model:
        fields["text_config"] = (t, T5_HF_FIELDS)
    out = {"model_type": "blip-2", "num_query_tokens": cfg.num_query_tokens}
    for key, (sub, names) in fields.items():
        out[key] = {name: getattr(sub, name) for name in names}
    if cfg.use_decoder_only_language_model:
        out["text_config"]["model_type"] = "opt"
    else:
        assert t.is_gated_act and t.dense_act_fn == "gelu_new", "flan-t5's FFN"
        out["text_config"].update(model_type="t5", feed_forward_proj="gated-gelu")
    return out


def write_hf_checkpoint(tag: str, model, cfg, path: str) -> float:
    """``model`` exported with the port's export_hf_safetensors plus a
    config.json written here; returns the file's bytes."""
    from eilev_tpu_torch.models.auto import config_from_hf_dict
    from eilev_tpu_torch.training.checkpoint import export_hf_safetensors

    hf = hf_config_dict(cfg)
    back = config_from_hf_dict(hf)
    for sub in ("vision_config", "qformer_config", "text_config"):
        want = {k: getattr(getattr(cfg, sub), k) for k in hf[sub] if hasattr(getattr(cfg, sub), k)}
        assert {k: getattr(getattr(back, sub), k) for k in want} == want, sub
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = export_hf_safetensors(model, cfg, path)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf, fh)
    secs = time.perf_counter() - t0
    size = os.path.getsize(f)
    print(f"[{tag}] checkpoints (a) export_hf_safetensors: {size} bytes (fp32) in {secs} s = {size / secs / 1e9} GB/s")
    return size


def timed_load(tag: str, label: str, path: str, size: int, dev, **kw):
    """load_model onto ``dev``, timed to the last tensor's arrival."""
    from eilev_tpu_torch.models.auto import load_model

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, cfg = load_model(path, device=dev, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"[{tag}] checkpoints {label} load_model({kw}): {secs} s, {size / secs / 1e9} GB/s of the file, "
          f"memory_allocated_bytes={torch.cuda.memory_allocated()}")
    return model, cfg


def lm_forward_log(model) -> list:
    """(sequence length, all logits finite) of every LM forward, as phase 4 logs them."""
    calls: list = []
    model.language_model.register_forward_hook(
        lambda mod, args, out: calls.append((args[0].shape[1], torch.isfinite(out[0]).all())))
    return calls


def prefill_cosine(tag: str, label: str, run, ref_logits, bar: float) -> None:
    """Every prompt position's prefill logits held to ``ref_logits`` by cosine."""
    a = run.prefill_logits(run.embeds()).float().flatten(0, 1)
    b = ref_logits.float().flatten(0, 1)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"[{tag}] checkpoints {label} prefill logits vs (b) over {a.shape[0]} positions: "
          f"min_cosine={cos.min().item()} mean_cosine={cos.mean().item()} same_argmax_share={same}")
    assert bool(torch.isfinite(a).all()) and cos.min().item() > bar, (label, cos.min().item())


def run_narration_cli(tag: str, model, frames: np.ndarray, out_dir: str, dev) -> None:
    """(e) cli.generate_narration_texts.run, bf16 at batch 4: 4 datapoints of
    SHOTS shots + a query over phase 4's frames, greedy 32 tokens. Every
    narration has the same word count, so the 4 prompts are of one length
    and unpadded: a left-padded bf16 row decodes from NaN logits, as the
    reference does (the NaN k/v of its padded slots)."""
    from eilev_tpu_torch.cli import generate_narration_texts as cli

    tok = WordTokenizer()
    rng = np.random.default_rng(3)
    verbs, nouns = ("takes", "cuts", "washes", "opens"), ("the knife", "an onion", "the pot", "a cup")
    data = []
    for d in range(4):
        items = []
        for s in range(SHOTS + 1):
            i = d * (SHOTS + 1) + s
            items.append({"frame_path": f"clip{i}|0", "video_uid": f"clip{i}", "clip_index": "0",
                          "narration_text": f"#C C {verbs[rng.integers(4)]} {nouns[rng.integers(4)]}",
                          "video": frames[i]})
        data.append({"items": items})
    out_csv = os.path.join(out_dir, "narration.csv")
    args = cli.parse_args(["--model", "unused", "--eval_frames_dir", "unused", "--in_context_query_map_file",
                           "unused", "--in_context_example_frames_dir", "unused", "--batch_size", "4",
                           "--generation_config", json.dumps({"max_new_tokens": MAX_NEW_TOKENS,
                                                              "eos_token_id": NEWLINE}),
                           "--output_csv", out_csv, "--device", str(dev)])
    lm_calls = lm_forward_log(model)
    reset_counters()
    t0 = time.perf_counter()
    rows = cli.run(args, model, tok, {"dataset": data})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = counters()
    one_token = sum(1 for s_len, _ in lm_calls if s_len == 1)
    want = narration_counts(model.config, "decode_attention_stacked_bf16")
    want["decode_attention_stacked_bf16"] = model.config.text_config.num_hidden_layers * one_token
    with open(out_csv, newline="") as f:
        written = list(csv.DictReader(f))
    print(f"[{tag}] checkpoints (e) narration CLI run, bf16 batch 4: wall_s={secs} rows={len(written)} "
          f"launches {counts} one_token_lm_forwards={one_token} first row={written[0]}")
    assert counts == want, (counts, want)
    assert one_token >= 1 and all(bool(ok) for _, ok in lm_calls), "non-finite logits"
    assert len(written) == len(rows) == 4
    assert [r["frame_path"] for r in written] == [f"clip{d * (SHOTS + 1) + SHOTS}|0" for d in range(4)]
    assert all(r["in_context_frame_paths"].count("|0") == SHOTS for r in written)


def run_icl_cli(tag: str, model, frames: np.ndarray, out_dir: str, dev) -> None:
    """(e) cli.icl_eval.run, bf16 at batch 4: 4 eval datapoints, one shot
    each from 4 train datapoints (the videos are phase 4's frames), the
    vendored class sets and the taxonomy they cover. The shots' narrations
    are sized so that every verb-stage prompt fills its 64-token bucket
    exactly (no left padding: finite scores); the noun stage adds the
    predicted verb's words, so its rows are left-padded and score NaN on
    every class, the reference behaviour, and are held to exactly that."""
    import eilev_tpu_torch.eval.icl as icl_mod
    from eilev_tpu_torch.cli import icl_eval as cli
    from eilev_tpu_torch.data import clean_narration_text, generate_input_ids_and_labels_from_interleaved
    from eilev_tpu_torch.eval.icl import FEW_SHOT_PROMPT

    verbs, nouns = icl_class_sets()
    tok = WordTokenizer()
    q = model.config.num_query_tokens

    def verb_stage_len(words: int) -> int:
        narration = "#C C " + " ".join(["w"] * words)
        built = generate_input_ids_and_labels_from_interleaved(
            tok, [(" ".join([FEW_SHOT_PROMPT, clean_narration_text(narration)]), 1),
                  (FEW_SHOT_PROMPT + " The camera wearer", 1)], None, q, True)
        return len(built["input_ids"])

    words = next(k for k in range(1, 65) if verb_stage_len(k) % 64 == 0)
    vlist, nlist = sorted(set(verbs.values())), sorted(set(nouns.values()))

    def datapoint(i: int) -> dict:
        return {"frame_path": f"clip{i}|0", "narration_text": "#C C " + " ".join([f"word{i}"] * words),
                "structured_verb": vlist[i % len(vlist)], "structured_noun": nlist[i % len(nlist)],
                "video": frames[i]}

    datasets = {"taxonomy": {"verbs": vlist, "nouns": nlist}, "verb_prompts": verbs, "noun_prompts": nouns,
                "train": [datapoint(i) for i in range(4)], "eval": [datapoint(4 + i) for i in range(4)]}
    out_json = os.path.join(out_dir, "icl.json")
    args = cli.parse_args(["--model", "unused", "--fho_lta_taxonomy", "unused", "--fho_main", "unused",
                           "--train_narrated_actions_dir", "unused", "--eval_narrated_actions_dir", "unused",
                           "--num_shot", "1", "--output_json", out_json, "--device", str(dev)])
    seen = []
    inner = icl_mod.classify

    def recording(m, **kw):
        out = inner(m, **kw)
        seen.append((out.float().cpu(), kw["prompt_attention_mask"].cpu()))
        return out

    icl_mod.classify = recording
    try:
        reset_counters()
        t0 = time.perf_counter()
        result = cli.run(args, model, tok, datasets)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = counters()
    finally:
        icl_mod.classify = inner
    with open(out_json) as f:
        written = json.load(f)
    n_vit, n_lm = model.config.vision_config.num_hidden_layers, model.config.text_config.num_hidden_layers
    print(f"[{tag}] checkpoints (e) ICL CLI run, bf16 batch 4 (1 shot, shot narrations of {words} words): "
          f"wall_s={secs} verb_f1={written['verb_f1']} noun_f1={written['noun_f1']} launches {counts}")
    assert counts["packed_qkv_attention"] == 2 * n_vit and counts["packed_qkv_causal_attention"] == 2 * n_lm, counts
    assert written["verb_f1"] == result.verb_f1 and len(written["noun_predictions"]) == 4
    (verb_scores, verb_mask), (noun_scores, noun_mask) = seen
    assert bool((verb_mask == 1).all()) and bool(torch.isfinite(verb_scores).all()), "verb stage not clean"
    padded = noun_mask[:, 0] == 0
    print(f"[{tag}] checkpoints (e) ICL verb stage: {tuple(verb_scores.shape)} scores finite, unpadded; "
          f"noun stage: {int(padded.sum())}/4 rows left-padded, NaN exactly there")
    assert bool(torch.equal(torch.isnan(noun_scores), padded[:, None].expand_as(noun_scores)))


def run_train_cli(tag: str, dev, out_dir: str) -> None:
    """(f) cli.train_v2.run at phase 8's fp32 cut, 2 steps with --export_hf,
    from a checkpoint of that cut loaded as the CLI loads it; the export
    reloaded through load_model gives the trainer's trainable tensors."""
    from eilev_tpu_torch.cli import train_v2 as cli
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.models.auto import load_model
    from eilev_tpu_torch.training import partition_params

    cfg = f32_cut_config()
    src = VideoBlipForConditionalGeneration(cfg, device=dev)  # fp32
    random_init_(src, torch.Generator(device=dev).manual_seed(49), std=0.02)
    ckpt = os.path.join(out_dir, "cut")
    size = write_hf_checkpoint(tag, src, cfg, ckpt)
    del src
    model, _ = timed_load(tag, "(f) fp32 cut", ckpt, size, dev, dtype=torch.float32)
    train_out = os.path.join(out_dir, "train")
    args = cli.parse_args(["--model_name_or_path", ckpt, "--train_frames_dir", "unused", "--val_frames_dir", "unused",
                           "--dtype", "fp32", "--output_dir", train_out, "--num_train_steps", "2",
                           "--per_device_train_batch_size", "1", "--gradient_accumulation_steps", "2",
                           "--max_length", str(TRAINER_MAX_LEN), "--num_subsample_frames", str(FRAMES),
                           "--train_num_in_context_examples_per_sample", str(TRAINER_SHOTS),
                           "--learning_rate", str(TRAINER_LR), "--warmup_steps", "0", "--eval_steps", "2",
                           "--save_steps", "2", "--logging_steps", "1", "--export_hf", "--device", str(dev)])
    datasets = {"train": _train_dataset(4, TRAINER_SHOTS, seed=8), "val": _train_dataset(1, TRAINER_SHOTS, seed=9)}
    reset_counters()
    t0 = time.perf_counter()
    trainer = cli.run(args, model, WordTokenizer(), datasets)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = counters()
    print(f"[{tag}] checkpoints (f) train CLI run, fp32 2+2+2, 2 steps + eval + export: wall_s={secs} "
          f"launches {counts}")
    assert trainer.state.step == 2
    assert counts["packed_qkv_attention_f32"] > 0 and counts["packed_qkv_attention"] == counts[
        "packed_qkv_attention_f32"], counts
    trained, _ = partition_params(dict(trainer.model.named_parameters()))
    del trainer, model
    reloaded, _ = timed_load(tag, "(f) the export", os.path.join(train_out, "hf"),
                             os.path.getsize(os.path.join(train_out, "hf", "model.safetensors")), dev,
                             dtype=torch.float32)
    state = reloaded.state_dict()
    same = all(torch.equal(state[k], p.detach()) for k, p in trained.items())
    print(f"[{tag}] checkpoints (f) the export reloaded: {len(trained)} trainable tensors equal to the "
          f"trainer's={same}")
    assert same
    del reloaded, state, trained


def run_samples(tag: str, model, ckpt: str, size: int, dev) -> None:
    """Phase 10 (g): the two samples' ``run`` on the card with synthetic uint8
    frames and the ICL phase's word tokenizer (the native decoder is not
    used here). EILeV's (beam 5, length_penalty -1, eos 50118) on the
    CLI-default model: two videos of 8 frames interleaved with text, K1 =
    ViT layers (one encode), K2 = OPT layers, K3 = OPT layers per one-token
    forward over the 5 beam rows. VideoBLIP's (sampling, 128 new tokens) on
    the checkpoint loaded as the v1 model (features prepended): one video of
    10 frames, counted the same way, the same text twice (its generator is
    seeded with 0 on the card for each request)."""
    from eilev_tpu_torch.samples import eilev_generate_action_narration as eilev
    from eilev_tpu_torch.samples import video_blip_generate_action_narration as vblip

    n_vit, n_lm = model.config.vision_config.num_hidden_layers, model.config.text_config.num_hidden_layers
    rng = np.random.default_rng(5)
    clips = [rng.integers(0, 256, (3, eilev.NUM_FRAMES, 224, 224), dtype=np.uint8) for _ in range(2)]
    prompts = [("What is the camera wearer doing? He opens a drawer.", 1), ("What is the camera wearer doing?", 1)]
    v1, _ = timed_load(tag, "(g) the v1 model", ckpt, size, dev, version="v1", dtype=torch.bfloat16)
    frames = rng.integers(0, 256, (3, 10, 224, 224), dtype=np.uint8)
    for label, mdl, call in (
        ("EILeV sample run (beam 5)", model, lambda: eilev.run(model, WordTokenizer(), prompts, clips)),
        ("VideoBLIP sample run (v1, sampling)", v1,
         lambda: vblip.run(v1, WordTokenizer(), frames, "What is the camera wearer doing?")),
    ):
        calls = lm_forward_log(mdl)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = counters()
        one_token = sum(1 for s_len, _ in calls if s_len == 1)
        want = narration_counts(mdl.config, "decode_attention_stacked_bf16")
        want["packed_qkv_attention"] = n_vit
        want["decode_attention_stacked_bf16"] = n_lm * one_token
        print(f"[{tag}] checkpoints (g) {label}: {secs} s, launches {counts}, one-token forwards {one_token}, "
              f"text {text[:120]!r}")
        assert counts == want, (counts, want)
        assert one_token >= 1 and all(bool(ok) for _, ok in calls), "no decode step, or non-finite logits"
        again = call()
        assert again == text, "the same request gave another text"
    del v1
    gc.collect()
    torch.cuda.empty_cache()


def run_t5_checkpoint(tag: str, dev, root: str) -> None:
    """(h) A bf16 VideoBLIP-T5 at the eilev-blip2-flan-t5-xl widths, F32_LAYERS
    a stack, N(0, 0.02) weights from a seed: exported (convert_t5's inverse)
    beside its config.json, loaded with bf16 weights, every tensor equal to
    the source's, bit for bit, and greedy narration at batch 1 (K1 =
    F32_LAYERS, nothing else) token-identical to the source model."""
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration

    cfg = t5_config(F32_LAYERS)
    src = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16).eval()
    random_init_(src, torch.Generator(device=dev).manual_seed(CKPT_SEED + 1), std=0.02)
    path = os.path.join(root, "t5")
    size = write_hf_checkpoint(tag, src, cfg, path)
    loaded, _ = timed_load(tag, "(h) T5 bf16", path, size, dev, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    ref_state, state = src.state_dict(), loaded.state_dict()
    bits = set(ref_state) == set(state) and all(
        state[k].dtype == v.dtype and torch.equal(state[k], v) for k, v in ref_state.items())
    print(f"[{tag}] checkpoints (h) T5: {len(state)} tensors equal to the source's, bit for bit={bits}")
    assert bits
    src_tokens = T5Narration(src, cfg, 1, dev).generate()
    run = T5Narration(loaded, cfg, 1, dev)
    drive(tag, "checkpoints (h) T5 bf16 load", run, t5_step_log(loaded), t5_counts(cfg, flash=False), reps=1)
    tokens = run.generate()
    same = bool(torch.equal(tokens, src_tokens))
    print(f"[{tag}] checkpoints (h) T5 greedy batch 1, 32 new tokens, token-identical to the source model={same}: "
          f"{tokens[0].tolist()}")
    assert same
    del src, loaded, run, ref_state, state
    gc.collect()
    torch.cuda.empty_cache()


def run_checkpoints(tag: str, dev) -> None:
    """Phase 10: HF checkpoints and the three CLIs at the eilev-blip2-opt-2.7b
    widths, depth cut to CKPT_LAYERS."""
    import tempfile

    from eilev_tpu_torch import configs
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration

    t_phase = time.perf_counter()
    base = configs.blip2_opt_2_7b()
    n_vit, n_qf, n_lm = CKPT_LAYERS
    cfg = dataclasses.replace(
        base,
        vision_config=dataclasses.replace(base.vision_config, num_hidden_layers=n_vit),
        qformer_config=dataclasses.replace(base.qformer_config, num_hidden_layers=n_qf),
        text_config=dataclasses.replace(base.text_config, num_hidden_layers=n_lm))
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        # (a) the source model, bf16, N(0, 0.02), exported as fp32
        src = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16).eval()
        random_init_(src, torch.Generator(device=dev).manual_seed(CKPT_SEED), std=0.02)
        n_params = sum(p.numel() for p in src.parameters())
        print(f"[{tag}] checkpoints (a) source model: eilev-blip2-opt-2.7b widths, {CKPT_LAYERS} ViT/Q-Former/OPT "
              f"layers, {n_params} params, bf16")
        ckpt = os.path.join(root, "ckpt")
        size = write_hf_checkpoint(tag, src, cfg, ckpt)

        # (b) bf16 weights: every tensor bit for bit, greedy tokens identical
        loaded, _ = timed_load(tag, "(b) bf16", ckpt, size, dev, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
        ref_state, state = src.state_dict(), loaded.state_dict()
        bits = set(ref_state) == set(state) and all(
            state[k].dtype == v.dtype and torch.equal(state[k], v) for k, v in ref_state.items())
        print(f"[{tag}] checkpoints (b) {len(state)} tensors equal to the source's, bit for bit={bits}")
        assert bits
        del ref_state, state
        src_tokens = Narration(src, cfg, 1, dev).generate()
        del src
        run_b = Narration(loaded, cfg, 1, dev)
        drive(tag, "checkpoints (b) bf16 load", run_b, lm_forward_log(loaded),
              narration_counts(cfg, "decode_attention_stacked_bf16"), reps=1)
        tokens = run_b.generate()
        same = bool(torch.equal(tokens, src_tokens))
        print(f"[{tag}] checkpoints (b) greedy batch 1, 32 new tokens, token-identical to the source model={same}: "
              f"{tokens[0].tolist()}")
        assert same
        ref_logits = run_b.prefill_logits(run_b.embeds())

        # (c) the CLIs' default: fp32 weights, bf16 compute
        cli_model, _ = timed_load(tag, "(c) fp32 weights, bf16 compute", ckpt, size, dev, dtype=torch.bfloat16)
        assert all(p.dtype == torch.float32 for p in cli_model.parameters())
        run_c = Narration(cli_model, cfg, 1, dev)
        drive(tag, "checkpoints (c) fp32 weights, bf16 compute", run_c, lm_forward_log(cli_model),
              narration_counts(cfg, "decode_attention_stacked_bf16"), reps=1)
        prefill_cosine(tag, "(c)", run_c, ref_logits, 0.999)

        # (d) int8 LM + int8 KV cache
        int8_model, _ = timed_load(tag, "(d) int8_lm + int8_kv", ckpt, size, dev, dtype=torch.bfloat16,
                                   int8_lm=True, int8_kv=True)
        run_d = Narration(int8_model, cfg, 1, dev)
        drive(tag, "checkpoints (d) int8_lm + int8_kv", run_d, lm_forward_log(int8_model),
              narration_counts(cfg, "decode_attention_stacked_int8"), reps=1)
        prefill_cosine(tag, "(d)", run_d, ref_logits, INT8_MIN_COSINE)
        del int8_model, run_d, loaded, run_b, ref_logits
        gc.collect()
        torch.cuda.empty_cache()

        # (e) the narration and ICL CLIs on the CLI-default model, phase 4's frames
        frames = np.random.default_rng(1).integers(0, 256, size=(4 * (SHOTS + 1), 3, FRAMES, 224, 224),
                                                   dtype=np.uint8)
        run_narration_cli(tag, cli_model, frames, root, dev)
        run_icl_cli(tag, cli_model, frames, root, dev)
        run_samples(tag, cli_model, ckpt, size, dev)
        t0 = time.perf_counter()
        run_eval_clis(tag, cli_model, ckpt, size, frames, root, dev)
        print(f"[{tag}] checkpoints (i) the evaluation CLIs took {time.perf_counter() - t0} s")
        del cli_model, run_c
        gc.collect()
        torch.cuda.empty_cache()

        # (f) the train CLI at the fp32 cut
        run_train_cli(tag, dev, root)
        # (h) a T5 checkpoint at the fp32 cut's depth
        run_t5_checkpoint(tag, dev, root)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] checkpoints phase took {time.perf_counter() - t_phase} s")


# ---------------------------------------------------------------------------
# phase 11: serving (serving/engine.py, serving/session.py, cli/serve.py)
# ---------------------------------------------------------------------------

# (a)'s engine: 4 slots, chunks of 8, prompt buckets of 64, 32 new tokens, a
# max_len that holds one wave of admissions and makes a later admission
# compact; the query text's extra tokens past the 766-token prompt (P = 766
# ... 790), and the engine step each request is submitted before (two at
# once, then one a step, the last two once the first wave is decoding)
SERVE_SLOTS = 4
SERVE_CHUNK = 8
SERVE_BUCKET = 64
SERVE_MAX_LEN = 960
SERVE_EXTRA = (0, 5, 10, 15, 20, 24)
SERVE_ARRIVAL = (0, 0, 1, 2, 5, 6)
SERVE_SEED = 15
# (b): 12 requests through the serve CLI at its defaults, all at once, then
# at half the rate the first leg sustained; the bucket-2 leg's requests
SERVE_CLI_REQUESTS = 12
SERVE_UNPADDED = 4
# (c): the captured cache's requests sample at most this many tokens (more
# than 7 speculative passes of 9 slots can emit)
SERVE_CAPTURE_NEW = 64
# (d) T5: 8 requests (two at once, then one a step), a decoder cache of 64
# slots (later admissions compact), the cross buffers 832 wide; (e) the
# chat session's turns
T5_SERVE_REQUESTS = 8
T5_SERVE_ARRIVAL = (0, 0, 1, 2, 3, 4, 5, 6)
T5_SERVE_MAX_LEN = 64
T5_SERVE_PROMPT = 832
SESSION_TURNS = 3


def serving_requests(q: int, pixel, extras, seed: int, t5: bool = False, keys: bool = False) -> list:
    """Requests of bench's 16-shot layout (build_prompt) over the videos
    ``pixel``: each with its own query text (the last 12 tokens drawn anew)
    and ``extras[i]`` more text tokens (before T5's closing eos), P = 766 +
    extras[i]; ``keys`` names the videos for a feature cache."""
    from eilev_tpu_torch.serving import Request

    ids, _, vim = build_prompt(q, 1, t5=t5)
    ids, vim = ids[0], vim[0]
    body, tail = (ids[:-1], ids[-1:]) if t5 else (ids, ids[:0])
    rng = np.random.default_rng(seed)
    high = 32000 if t5 else 40000
    requests = []
    for n in extras:
        text = body.copy()
        text[-TEXT_TOKENS_PER_SHOT:] = rng.integers(1000, high, size=TEXT_TOKENS_PER_SHOT)
        full = np.concatenate([text, rng.integers(1000, high, size=n), tail])
        mask = np.concatenate([vim[: len(body)], np.zeros(n + len(tail), vim.dtype)])
        requests.append(Request(input_ids=full, pixel_values=pixel, video_input_mask=mask,
                                feature_keys=[f"video{j}" for j in range(SHOTS + 1)] if keys else None))
    return requests


def serving_frames(dev, n: int = SHOTS + 1, seed: int = 1) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, size=(n, 3, FRAMES, 224, 224), dtype=np.uint8)).to(dev)


def lm_call_log(model) -> tuple[list, object]:
    """(tokens in, an append, a left-padded prefill, all logits finite) of
    every LM forward; the flags stay device tensors until read."""
    calls: list = []

    def hook(mod, args, kwargs, out):
        mask = kwargs.get("attention_mask")
        padded = None if mask is None else (mask == 0).any()
        calls.append((args[0].shape[1], bool(kwargs.get("cache_append", False)), padded,
                      torch.isfinite(out[0]).all()))

    return calls, model.language_model.register_forward_hook(hook, with_kwargs=True)


def prefills(calls: list) -> list:
    """(left-padded, finite) of each admission prefill in ``calls``."""
    return [(bool(p), bool(ok)) for s_len, app, p, ok in calls if s_len > 1 and not app]


def serve_leg(tag: str, label: str, eng, requests: list, arrivals, calls: list, total: dict,
              watch=None) -> tuple:
    """One counted engine run (counters at 0 just before, read just after):
    request i submitted before step arrivals[i]; ``watch(eng)`` after each
    step. Adds the counts to ``total``. Returns (completions by rid,
    counts, seconds, steps)."""
    done, pending, steps = {}, list(range(len(requests))), 0
    calls.clear()
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or not eng.idle:
        for i in [i for i in pending if arrivals[i] <= steps]:
            assert eng.submit(dataclasses.replace(requests[i])) == i
            pending.remove(i)
        done.update((c.rid, c) for c in eng.step())
        if watch is not None:
            watch(eng)
        steps += 1
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = counters()
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n
    one_token = sum(1 for s_len, _, _, _ in calls if s_len == 1)
    print(f"[{tag}] serving {label}: {len(requests)} requests in {steps} steps, wall_s={secs} stats={eng.stats} "
          f"admissions={len(prefills(calls))} one_token_forwards={one_token} launches {counts}")
    return done, counts, secs, steps


def serving_counts(model, calls: list, vision_encodes: int, f32: bool, int8_kv: bool = False) -> dict:
    """The launches a serving leg must give: K1 per ViT layer and encode, K2
    per OPT layer and admission prefill, K3 (K4 over an int8 cache) per
    layer and one-token forward; the verify passes of speculation attend by
    plain attention (no kernel), as in JAX."""
    cfg = model.config
    n_lm = cfg.text_config.num_hidden_layers
    admissions = len(prefills(calls))
    one_token = sum(1 for s_len, _, _, _ in calls if s_len == 1)
    want = dict.fromkeys(counters(), 0)
    k1 = vision_encodes * cfg.vision_config.num_hidden_layers
    want["packed_qkv_attention"] = k1
    want["packed_qkv_causal_attention"] = n_lm * admissions
    if f32:
        want["packed_qkv_attention_f32"] = k1
        want["packed_qkv_causal_attention_f32"] = n_lm * admissions
    if int8_kv:
        want["decode_attention_stacked_int8"] = n_lm * one_token
        if f32:
            want["decode_attention_stacked_int8_f32"] = n_lm * one_token
    else:
        want["decode_attention_stacked_f32" if f32 else "decode_attention_stacked_bf16"] = n_lm * one_token
    return want


def isolated_rows(model, requests: list, gen_cfg, t5: bool = False, video_features=None,
                  pad_to: int = 0) -> tuple[list, list]:
    """Each request's isolated ``generate`` as an engine row (its new tokens,
    pad after), and the last-position logits each token was chosen from.
    ``pad_to`` > 0 right-pads each prompt to the next multiple (with its
    attention mask), as the T5 engine's admission encodes it."""
    from eilev_tpu_torch.generation import generate

    dev = next(model.parameters()).device
    rows, recs = [], []
    for req in requests:
        ids, vim = req.input_ids, req.video_input_mask
        mask = np.ones_like(ids)
        if pad_to:
            pad = -len(ids) % pad_to
            ids, vim, mask = (np.concatenate([a, np.zeros(pad, a.dtype)]) for a in (ids, vim, mask))
        rec: list = []
        if t5:
            handle = model.language_model.lm_head.register_forward_hook(
                lambda mod, args, out: rec.append(out[:, -1].float()))
        else:
            handle = model.language_model.register_forward_hook(
                lambda mod, args, out: rec.append(out[0][:, -1].float()))
        kw = {"video_features": video_features} if video_features is not None else {"pixel_values": req.pixel_values}
        try:
            out = generate(model, input_ids=torch.from_numpy(ids[None]).to(dev),
                           attention_mask=torch.from_numpy(mask[None]).to(dev),
                           video_input_mask=torch.from_numpy(vim[None]).to(dev),
                           generation_config=gen_cfg, **kw)[0].cpu().numpy()
        finally:
            handle.remove()
        out = out[1:] if t5 else out
        row = np.full(gen_cfg.max_new_tokens, gen_cfg.pad_token_id, np.int32)
        row[: len(out)] = out
        rows.append(row)
        recs.append(rec)
    return rows, recs


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def compare_rows(tag: str, label: str, done: dict, rows: list, recs: list = None, rule: str = "identical",
                 rids=None) -> int:
    """Engine rows against the isolated rows: identical, or (``rule`` "ulp":
    a top-2 gap of at most one bf16 ulp of the larger logit, the speculative modes' rule;
    "near-tie": within NEAR_TIE of the largest |logit|) parting at a near-tie
    of the isolated run's logits. Returns the identical rows."""
    same, ties = 0, []
    for rid, row in enumerate(rows):
        if rids is not None and rid not in rids:
            continue
        got = done[rid].tokens
        if np.array_equal(got, row):
            same += 1
            continue
        t = int(np.nonzero(got != row)[0][0])
        assert rule != "identical", f"{label}: request {rid} {got.tolist()} != isolated {row.tolist()} (at {t})"
        logits = recs[rid][t][0]
        top2 = logits.topk(2).values
        gap = (top2[0] - top2[1]).item()
        bar = bf16_ulp(top2[0].item()) if rule == "ulp" else NEAR_TIE * logits.abs().max().item()
        ties.append({"request": rid, "position": t, "top2_gap": gap, "near_tie_bar": bar})
        assert gap <= bar, f"{label}: request {rid} leaves isolated generate at {t}, top-2 gap {gap} > {bar}"
    print(f"[{tag}] serving {label}: rows identical to isolated generate {same}/{len(rows if rids is None else rids)}; "
          f"near-tie partings {ties}")
    return same


def serving_opt_f32(tag: str, dev, total: dict, result: dict) -> None:
    """(a) The eilev-blip2-opt-2.7b model in fp32 at full depth (its default
    construction, random N(0, 0.02) from SERVE_SEED): six staggered requests
    (P = 766 ... 790) through the engine, plain and prompt-lookup
    speculative, every row token-identical to the isolated fp32 generate of
    its request. The 17 videos are encoded once, by a VideoFeatureCache
    the engine and the isolated runs share, so every run scatters the same
    features."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops.preprocess import process_videos
    from eilev_tpu_torch.serving import ContinuousBatchingEngine, VideoFeatureCache

    cfg = configs.blip2_opt_2_7b()
    model = VideoBlipForConditionalGeneration(cfg, device=dev).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(SERVE_SEED), std=0.02)
    pixel = process_videos(serving_frames(dev), dtype=torch.float32)
    requests = serving_requests(cfg.num_query_tokens, pixel, SERVE_EXTRA, SERVE_SEED, keys=True)
    gen_cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, pad_token_id=1, eos_token_id=(NEWLINE,))
    cache = VideoFeatureCache(model, bucket=SHOTS + 1)
    calls, handle = lm_call_log(model)
    legs = {}
    for spec in (None, "prompt_lookup"):
        label = f"(a) fp32 full depth, {spec or 'plain'}"
        eng = ContinuousBatchingEngine(model, gen_cfg, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                                       chunk_tokens=SERVE_CHUNK, prefill_bucket=SERVE_BUCKET, feature_cache=cache,
                                       speculative=spec, spec_gamma=LOOKUP_GAMMA, spec_match_len=LOOKUP_MATCH)
        misses = cache.misses
        done, counts, secs, steps = serve_leg(tag, label, eng, requests, SERVE_ARRIVAL, calls, total)
        encodes = int(cache.misses > misses)
        assert counts == serving_counts(model, calls, encodes, f32=True), (counts, encodes)
        assert len(done) == len(requests) > SERVE_SLOTS  # slots were reused
        if spec is None:
            assert eng.stats["compactions"] >= 1, eng.stats
        legs[spec or "plain"] = (done, dict(eng.stats, wall_s=secs, steps=steps,
                                            admissions=len(prefills(calls))))
    handle.remove()
    feats = cache.features(requests[0].feature_keys)
    rows, _ = isolated_rows(model, requests, gen_cfg, video_features=feats)
    print(f"[{tag}] serving (a) prompt lengths {[len(r.input_ids) for r in requests]}; isolated rows "
          f"{[r[:8].tolist() for r in rows]}")
    for name, (done, stats) in legs.items():
        compare_rows(tag, f"(a) fp32 {name}", done, rows)
        result[f"opt_f32_{name}"] = stats
    del cache, feats
    serving_capture(tag, dev, model, cfg, pixel, result)


def serving_dataset(n: int, frames: np.ndarray, seed: int) -> list:
    """``n`` datapoints of SHOTS shots + a query over ``frames`` (17 uint8
    videos), each shot narrated in 4 words, for the serve CLI's run."""
    rng = np.random.default_rng(seed)
    verbs, nouns = ("takes", "cuts", "washes", "opens"), ("the knife", "an onion", "the pot", "a cup")
    data = []
    for d in range(n):
        items = [{"frame_path": f"clip{d}-{s}|0", "video_uid": f"clip{d}-{s}", "clip_index": "0",
                  "narration_text": f"#C C {verbs[rng.integers(4)]} {nouns[rng.integers(4)]}", "video": frames[s]}
                 for s in range(SHOTS + 1)]
        data.append({"items": items})
    return data


def serving_bf16(tag: str, dev, total: dict, result: dict) -> None:
    """(b) The bf16 model at full depth through cli/serve.py's run at its
    defaults, then the profiled chunk, the bucket-2 leg and (e) the chat
    session."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.cli import serve as cli
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops.preprocess import process_videos
    from eilev_tpu_torch.serving import ContinuousBatchingEngine

    cfg = configs.blip2_opt_2_7b()
    model = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(42), std=0.02)
    frames = serving_frames(dev)
    data = serving_dataset(SERVE_CLI_REQUESTS, frames.cpu().numpy(), seed=3)
    calls, handle = lm_call_log(model)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out_dir, exist_ok=True)
    rate = 0.0
    for leg in ("saturation", "half rate"):
        argv = ["--model", "unused", "--eval_frames_dir", "unused", "--in_context_query_map_file", "unused",
                "--in_context_example_frames_dir", "unused", "--num_eval_datapoints", str(SERVE_CLI_REQUESTS),
                "--arrival_rate", str(rate), "--output_csv", os.path.join(out_dir, "serve.csv"),
                "--device", str(dev)]
        args = cli.parse_args(argv)
        calls.clear()
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        rows, metrics = cli.run(args, model, WordTokenizer(), {"dataset": data})
        torch.cuda.synchronize()
        counts = counters()
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        adm = prefills(calls)
        nan_rows = sum(1 for _, ok in adm if not ok)
        lengths = sorted({s_len for s_len, app, _, _ in calls if s_len > 1 and not app})
        assert len(rows) == SERVE_CLI_REQUESTS and len(adm) == SERVE_CLI_REQUESTS, (len(rows), len(adm))
        assert all(ok == (not padded) for padded, ok in adm), adm  # finite exactly when not left-padded
        assert counts == serving_counts(model, calls, SERVE_CLI_REQUESTS, f32=False), counts
        per_request = {k: counts[k] / SERVE_CLI_REQUESTS for k in
                       ("packed_qkv_attention", "packed_qkv_causal_attention", "decode_attention_stacked_bf16")}
        result[f"cli_bf16_{leg}"] = dict(metrics, peak_bytes=torch.cuda.max_memory_allocated(),
                                         launches_per_request=per_request, nan_rows=nan_rows,
                                         padded_admissions=sum(p for p, _ in adm), admission_widths=lengths)
        print(f"[{tag}] serving (b) serve CLI bf16 {leg}: {json.dumps(result[f'cli_bf16_{leg}'])} "
              f"(NaN rows {nan_rows} of {len(adm)}: left-padded bf16 admissions, the reference's behaviour; "
              f"these times are not of real narrations)")
        rate = 0.5 * SERVE_CLI_REQUESTS / metrics["wall_sec"]

    gen_cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, pad_token_id=1, eos_token_id=(NEWLINE,))
    pixel = process_videos(frames, dtype=torch.bfloat16)

    # one decode chunk at the CLI's defaults: the host syncs it makes, and
    # its idle share under the profiler
    from torch.profiler import ProfilerActivity, profile

    eng = ContinuousBatchingEngine(model, gen_cfg, max_slots=SERVE_SLOTS, max_len=2048, chunk_tokens=SERVE_CHUNK,
                                   prefill_bucket=128)
    for req in serving_requests(cfg.num_query_tokens, pixel, (0, 2, 4, 6), SERVE_SEED + 1):
        eng.submit(req)
    eng.step()  # the admissions and the first chunk
    torch.cuda.synchronize()
    assert not eng.idle, "no decode chunk left to count syncs in"
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
    torch.cuda.synchronize()
    assert not eng.idle, "the profiled step has no decode chunk to run"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    result["profiled_chunk"] = {"wall_s": wall, "device_kernel_ms": dev_us / 1e3,
                                "launches": sum(e.count for e in kernels),
                                "idle_share": 1 - dev_us / 1e6 / wall, "host_syncs": len(syncs)}
    print(f"[{tag}] serving (b) one decode chunk (4 slots, 8 tokens, 2,048 slots): {result['profiled_chunk']}; "
          f"syncs {syncs}")
    del eng

    # the bucket-2 leg: four 766-token requests, none left-padded
    requests = serving_requests(cfg.num_query_tokens, pixel, (0,) * SERVE_UNPADDED, SERVE_SEED + 2)
    eng = ContinuousBatchingEngine(model, gen_cfg, max_slots=SERVE_SLOTS, max_len=2048, chunk_tokens=SERVE_CHUNK,
                                   prefill_bucket=2)
    done, counts, secs, _ = serve_leg(tag, "(b) bf16, bucket 2", eng, requests, (0,) * SERVE_UNPADDED, calls, total)
    adm = prefills(calls)
    assert adm == [(False, True)] * SERVE_UNPADDED, adm
    assert counts == serving_counts(model, calls, SERVE_UNPADDED, f32=False), counts
    rows, recs = isolated_rows(model, requests, gen_cfg)
    result["bf16_unpadded_identical_rows"] = compare_rows(tag, "(b) bf16 bucket 2", done, rows, recs, rule="ulp")
    del eng

    handle.remove()
    serving_session(tag, dev, model, frames, result)


def serving_capture(tag: str, dev, model, cfg, pixel, result: dict) -> None:
    """(c) K3 and K4 over a captured speculative engine cache (the fp32
    model of (a), 4 slots x 2,048): a 16-shot request samples alone through
    4 prompt-lookup passes (rejected drafts leave holes), then a chat-sized
    request (one video, 46 tokens) is admitted at W = bucket(index), with a
    dead prefix longer than a split chunk of K3/K4 (683 slots at 4 rows:
    its first chunk holds no live slot); after 3 more passes, every layer
    of the cache through K3 (the fp32 body) and K4 (an fp32 query over
    the cache quantized by quantize_kv) against their twins at F32_TOL (the
    empty rows: the uniform average, in both), and the same cache cast to
    bf16 through K3's one-block body (2e-2) and K4 (K4_TOL), its empty rows
    NaN in both. Every call is then timed, the fp32 ones with the empty rows'
    reads of every V row in their bound. (In bf16 a left-padded
    admission's live slots hold NaN k/v, the reference's behaviour, which
    would leave nothing to compare; fp32 admissions stay finite.)"""
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.serving import ContinuousBatchingEngine, Request

    nh, hd = cfg.text_config.num_attention_heads, cfg.text_config.head_dim
    split = -(-2048 // da.cluster_size(SERVE_SLOTS, nh, 2048))  # the slots of one split chunk at 4 rows
    long_cfg = GenerationConfig(max_new_tokens=SERVE_CAPTURE_NEW, pad_token_id=1, eos_token_id=(), do_sample=True)
    eng = ContinuousBatchingEngine(model, long_cfg, max_slots=SERVE_SLOTS, max_len=2048, chunk_tokens=SERVE_CHUNK,
                                   prefill_bucket=SERVE_BUCKET, speculative="prompt_lookup",
                                   spec_gamma=LOOKUP_GAMMA, spec_match_len=LOOKUP_MATCH,
                                   generator=torch.Generator(device=dev).manual_seed(SERVE_SEED))
    (r0,) = serving_requests(cfg.num_query_tokens, pixel, (0,), SERVE_SEED + 3)
    q = cfg.num_query_tokens
    text = np.random.default_rng(SERVE_SEED + 4).integers(1000, 40000, size=TEXT_TOKENS_PER_SHOT)
    r1 = Request(input_ids=np.concatenate([[2], np.ones(q, np.int64), [NEWLINE], text]), pixel_values=pixel[:1],
                 video_input_mask=np.concatenate([[0], np.ones(q, np.int64), np.zeros(1 + len(text), np.int64)]))
    with torch.inference_mode():
        eng.submit(r0)
        for _ in range(4):  # sampled lookup passes: rejected drafts leave holes
            eng.step()
        eng.submit(r1)  # admitted at W = bucket(index) > 800: its dead prefix
        for _ in range(3):
            eng.step()
    cache = eng._cache
    mask = cache["mask"].clone()
    index = cache["index"]
    live = mask[:, :index].sum(dim=1).tolist()
    starts = [int(row.nonzero()[0]) if row.any() else index for row in mask[:, :index]]
    holes = [int((mask[r, starts[r]:index] == 0).sum()) for r in range(SERVE_SLOTS)]
    print(f"[{tag}] serving (c) captured cache: index={index} live slots a row={live} live starts={starts} "
          f"holes in the live windows={holes} split chunk={split} stats={eng.stats}")
    assert starts[1] > split and holes[0] > 0, (starts, holes, split)
    n_layers, b, s, _, _ = cache["k"].shape
    g = torch.Generator(device=dev).manual_seed(11)
    q32 = torch.randn(b, nh * hd, device=dev, generator=g)
    kw = dict(num_heads=nh, head_dim=hd, scale=hd**-0.5, scale_query=True)
    empty = [r for r in range(b) if live[r] == 0]
    k8, ks = da.quantize_kv(cache["k"])
    v8, vs = da.quantize_kv(cache["v"])
    k8, v8 = k8.view(n_layers, b, s, -1), v8.view(n_layers, b, s, -1)
    errs, calls = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        qd = q32.to(dtype)
        kb, vb = (cache[key].to(dtype).view(n_layers, b, s, -1) for key in ("k", "v"))
        for name, args, extra, tol in (("K3", (kb, vb), {}, F32_TOL if f32 else 2e-2),
                                       ("K4", (k8, v8), dict(k_scale=ks, v_scale=vs), F32_TOL if f32 else K4_TOL)):
            label = f"{name} {'fp32' if f32 else 'bf16'}"
            errs[label] = 0.0
            for layer in range(n_layers):
                out = da.decode_attention_stacked(qd, *args, mask, layer, **kw, **extra)
                ref = da.decode_attention_stacked_reference(qd, *args, mask, layer, **kw, **extra)
                torch.cuda.synchronize()
                if f32:
                    pairs = [(out, ref)]
                else:  # the empty rows are NaN in both
                    assert bool(torch.isnan(out[empty]).all() and torch.isnan(ref[empty]).all()), label
                    keep = [r for r in range(b) if r not in empty]
                    pairs = [(out[keep], ref[keep])]
                for o, r in pairs:
                    errs[label] = max(errs[label], (o.float() - r.float()).abs().max().item())
                    torch.testing.assert_close(o, r, atol=tol, rtol=tol)
            calls[label] = (qd, args, extra)
    print(f"[{tag}] serving (c) K3 and K4 over the captured cache, every layer: max_abs_err={errs}; "
          f"empty rows {empty}: the uniform average (fp32) and NaN (bf16) in kernel and twin alike")
    kept = sum(live)
    rows = []
    for name, row_bytes, label in (("K3 bf16", 2 * hd, "decode_attention_stacked_bf16"),
                                   ("K4 bf16", hd + 2, "decode_attention_stacked_int8"),
                                   ("K3 fp32", 4 * hd, "decode_attention_stacked_f32"),
                                   ("K4 fp32", hd + 2, "decode_attention_stacked_int8_f32")):
        qd, args, extra = calls[name]
        f32 = qd.dtype == torch.float32
        lib = None
        if name.startswith("K3"):  # one SDPA call a layer, as the kernel's step
            masked = torch.finfo(torch.float32).min if f32 else -torch.inf
            fold = torch.where(mask.bool(), 0.0, masked).to(qd.dtype)[:, None, None, :]
            qt = qd.view(b, nh, 1, hd) * hd**-0.5
            kv = [tuple(a[i].view(b, s, nh, hd).transpose(1, 2) for a in args) for i in range(n_layers)]
            lib = (lambda qt=qt, kv=kv, fold=fold: [_sdpa(qt, k, v, attn_mask=fold, scale=1.0) for k, v in kv])
        # the live slots' K and V rows; with an fp32 model an empty row is the
        # uniform average of all S slots' V rows, which it must read
        uniform = len(empty) * s if f32 else 0
        io = 2 * b * nh * hd * qd.element_size() + b * s * 4
        rows.append({
            "name": f"{label} at the serving engine's cache (4, 2,048) with holes", "per_call": n_layers,
            "source": "eilev_tpu_torch/csrc/decode_attention.cu", "replaces": "eilev_tpu/ops/decode_attention.py:117",
            "max_abs_err": errs[name],
            "run": (lambda qd=qd, args=args, extra=extra: [da.decode_attention_stacked(qd, *args, mask, i, **kw, **extra)
                                                           for i in range(n_layers)]),
            "plain": (lambda qd=qd, args=args, extra=extra: [da.decode_attention_stacked_reference(
                qd, *args, mask, i, **kw, **extra) for i in range(n_layers)]),
            "library": lib,
            "bound": bound(4 * nh * hd * kept + 2 * nh * hd * uniform, (2 * kept + uniform) * nh * row_bytes + io,
                           H100_F32_FLOPS if f32 else H100_BF16_FLOPS),
        })
    for r in rows:
        time_row(tag, r)
    result["captured_cache"] = {"index": index, "live_slots": live, "live_starts": starts, "holes": holes,
                                "split_chunk": split, "max_abs_err": errs, "rows": rows}


def serving_admission_k2(tag: str, dev, result: dict) -> None:
    """K2 at an OPT admission's shape: one row of W = 768 slots of 32 x 80,
    left-padded by 2 (P = 766), bf16, against its twin (NaN in the two
    padded query rows of both, the reference's mask), then timed."""
    from eilev_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(12)
    qkv = torch.randn(1, 768, 3 * 2560, device=dev, generator=g).to(torch.bfloat16)
    mask = torch.ones(1, 768, dtype=torch.int32, device=dev)
    mask[:, :2] = 0
    out = fa.packed_qkv_causal_attention(qkv, 32, 80, mask)
    ref = fa.packed_qkv_causal_attention_reference(qkv, 32, 80, mask, 80**-0.5)
    assert bool(torch.isnan(out[:, :2]).all() and torch.isnan(ref[:, :2]).all())
    err = check_close(tag, "serving (c) K2 at the admission shape (1, 768, 32x80), left-padded by 2, real rows",
                      out[:, 2:], ref[:, 2:], 2e-2)
    q, k, v = (qkv[..., i * 2560:(i + 1) * 2560].reshape(1, 768, 32, 80).transpose(1, 2) for i in range(3))
    fold = torch.where(torch.tril(torch.ones(768, 768, dtype=torch.bool, device=dev)) & mask.bool()[:, None, None, :],
                       0.0, -torch.inf).to(torch.bfloat16)
    flops, nbytes = _k5_causal_work([766], 768, 32, 80, 768)
    row = {"name": "packed_qkv_causal_attention at an admission (1, 768, 32x80), left-padded by 2",
           "source": "eilev_tpu_torch/csrc/packed_attention.cu", "replaces": "eilev_tpu/ops/fused_attention.py:187",
           "max_abs_err": err, "per_call": 1,
           "run": (lambda: fa.packed_qkv_causal_attention(qkv, 32, 80, mask)),
           "plain": (lambda: fa.packed_qkv_causal_attention_reference(qkv, 32, 80, mask, 80**-0.5)),
           "library": (lambda: _sdpa(q, k, v, attn_mask=fold)),
           "bound": bound(flops, nbytes)}
    time_row(tag, row)
    result["k2_admission"] = row


def serving_session(tag: str, dev, model, frames, result: dict) -> None:
    """(e) ChatSession on the bf16 model: SESSION_TURNS turns, each adding a
    video and a question to the conversation so far (its replies included);
    each reply against a from-scratch generate on the whole prompt (the
    NEAR_TIE rule), the turn's time beside the from-scratch time."""
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.ops.preprocess import process_videos
    from eilev_tpu_torch.serving import ChatSession, Request

    gen_cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, pad_token_id=1, eos_token_id=(NEWLINE,))
    q = model.config.num_query_tokens
    pixel = process_videos(frames[:SESSION_TURNS], dtype=model.compute_dtype)
    sess = ChatSession(model, gen_cfg)
    rng = np.random.default_rng(21)
    ids, vim = np.asarray([2]), np.asarray([0])
    turns = []
    for turn in range(SESSION_TURNS):
        text = rng.integers(1000, 40000, size=TEXT_TOKENS_PER_SHOT)
        ids = np.concatenate([ids, np.ones(q, np.int64), [NEWLINE], text])
        vim = np.concatenate([vim, np.ones(q, np.int64), np.zeros(1 + TEXT_TOKENS_PER_SHOT, np.int64)])
        videos = pixel[: turn + 1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reply = sess.turn(ids, videos, vim)
        turn_s = time.perf_counter() - t0
        req = Request(input_ids=ids, pixel_values=videos, video_input_mask=vim)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, recs = isolated_rows(model, [req], gen_cfg)
        scratch_s = time.perf_counter() - t0
        full = np.full(MAX_NEW_TOKENS, 1, np.int32)
        full[: len(reply)] = reply
        same = compare_rows(tag, f"(e) session turn {turn}", {0: SimpleNamespace(tokens=full)}, rows, recs,
                            rule="near-tie")
        turns.append({"prompt_tokens": len(ids), "reply_tokens": len(reply), "turn_s": turn_s,
                      "from_scratch_s": scratch_s, "reused": sess.reused_last_turn,
                      "appended": sess.last_turn_appended, "identical": bool(same)})
        ids = np.concatenate([ids, reply.astype(ids.dtype)])
        vim = np.concatenate([vim, np.zeros(len(reply), vim.dtype)])
    print(f"[{tag}] serving (e) ChatSession bf16 turns: {turns}")
    assert [t["reused"] for t in turns] == [False] + [True] * (SESSION_TURNS - 1)
    result["session_bf16"] = turns


def serving_f32_cuts(tag: str, dev, total: dict, result: dict) -> None:
    """(c) the int8 KV cache on (a)'s requests at the 4-layer fp32 cut (K4
    with an fp32 query over the engine's cache), and (e) the session at the
    fp32 2-layer cut: engine rows and replies token-identical to isolated
    generate."""
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops.preprocess import process_videos
    from eilev_tpu_torch.serving import ChatSession, ContinuousBatchingEngine, Request

    gen_cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, pad_token_id=1, eos_token_id=(NEWLINE,))
    base = f32_cut_config()
    cfg = dataclasses.replace(base, text_config=dataclasses.replace(
        base.text_config, num_hidden_layers=4, int8_kv_cache=True))
    model = VideoBlipForConditionalGeneration(cfg, device=dev).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(SERVE_SEED), std=0.02)
    frames = serving_frames(dev)
    pixel = process_videos(frames, dtype=torch.float32)
    requests = serving_requests(cfg.num_query_tokens, pixel, SERVE_EXTRA, SERVE_SEED)
    calls, handle = lm_call_log(model)
    eng = ContinuousBatchingEngine(model, gen_cfg, max_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                                   chunk_tokens=SERVE_CHUNK, prefill_bucket=SERVE_BUCKET)
    done, counts, _, _ = serve_leg(tag, "(c) int8 KV cache, fp32 4-layer cut", eng, requests, SERVE_ARRIVAL, calls,
                                   total)
    assert counts == serving_counts(model, calls, len(requests), f32=True, int8_kv=True), counts
    handle.remove()
    rows, _ = isolated_rows(model, requests, gen_cfg)
    compare_rows(tag, "(c) int8 KV fp32 cut", done, rows)
    result["int8_kv_f32_cut"] = dict(eng.stats)
    del model, eng

    model = VideoBlipForConditionalGeneration(f32_cut_config(), device=dev).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(SERVE_SEED), std=0.02)
    sess = ChatSession(model, gen_cfg)
    q = model.config.num_query_tokens
    rng = np.random.default_rng(22)
    ids, vim = np.asarray([2]), np.asarray([0])
    for turn in range(SESSION_TURNS):
        ids = np.concatenate([ids, np.ones(q, np.int64), [NEWLINE],
                              rng.integers(1000, 40000, size=TEXT_TOKENS_PER_SHOT)])
        vim = np.concatenate([vim, np.ones(q, np.int64), np.zeros(1 + TEXT_TOKENS_PER_SHOT, np.int64)])
        reply = sess.turn(ids, pixel[: turn + 1], vim)
        rows, _ = isolated_rows(model, [Request(input_ids=ids, pixel_values=pixel[: turn + 1],
                                                video_input_mask=vim)], gen_cfg)
        row = rows[0]
        m = int(np.nonzero(row == NEWLINE)[0][0]) + 1 if (row == NEWLINE).any() else len(row)
        assert np.array_equal(reply, row[:m]), (turn, reply, row)
        ids = np.concatenate([ids, reply.astype(ids.dtype)])
        vim = np.concatenate([vim, np.zeros(len(reply), vim.dtype)])
    print(f"[{tag}] serving (e) ChatSession fp32 2-layer cut: {SESSION_TURNS} turns token-identical to "
          f"from-scratch generate")
    del model, sess


class SlotWatch:
    """For the T5 engine: the slot each request took, the slots that ran a
    decode step while never occupied (an empty slot's encoder mask is all
    0, so its cross attention is fully masked: NaN in bf16 on the plain
    path, whose k/v then stay in the slot's self-cache row behind the next
    occupant's mask), and each decoder step's finite flag by slot (an
    lm_head hook)."""

    def __init__(self, model, slots: int):
        self.slots, self.occupied, self.flagged, self.slot_of, self.finite = slots, set(), set(), {}, []
        self.handle = model.language_model.lm_head.register_forward_hook(
            lambda mod, args, out: self.finite.append(torch.isfinite(out).all(dim=(1, 2))))

    def __call__(self, eng) -> None:
        for slot, req in enumerate(eng._active):
            if req is not None:
                self.slot_of.setdefault(req.rid, slot)
                self.occupied.add(slot)
        self.flagged |= set(range(self.slots)) - self.occupied

    def nan_rows(self, done: dict, chunk: int) -> dict:
        """The requests whose logits were not finite at some step of theirs:
        rid -> whether each of those steps emitted token 0 (argmax of NaN)."""
        finite = torch.stack(self.finite).cpu() if self.finite else torch.ones(0, self.slots, dtype=torch.bool)
        out = {}
        for rid, c in done.items():
            ok = finite[c.admitted_at_chunk * chunk: c.finished_at_chunk * chunk, self.slot_of[rid]]
            if not bool(ok.all()):
                n = min(len(ok), len(c.tokens))
                out[rid] = bool((c.tokens[:n][~ok[:n].numpy()] == 0).all())
        return out


def serving_t5(tag: str, dev, total: dict, result: dict) -> None:
    """(d) The eilev-blip2-flan-t5-xl model in bf16 at T5_LAYERS a stack (random
    N(0, 0.02) from T5_SEED): 8 staggered requests (P = 766 + extra) through
    a 4-slot engine with a 64-slot decoder cache, under "auto" and "flash"
    (K5's bias form on the decoder's self and cross steps), rows against
    isolated generate of the prompt and of the same prompt right-padded as
    the engine encodes it, under the same dispatch (NEAR_TIE). Under "auto" in bf16 a request admitted into a slot
    that decoded while empty may decode from NaN (token 0), the reference's
    behaviour: the NaN rows must lie in such slots and be all 0; under
    "flash" (K5 zeroes a fully masked row) and in fp32 none is NaN. K5 at
    the engine's step shapes held to its twin and timed; then the fp32
    2-layer cut under "auto", token-identical to unpadded prompts."""
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops import flash_attention as fl
    from eilev_tpu_torch.ops.preprocess import process_videos
    from eilev_tpu_torch.serving import ContinuousBatchingEngine

    gen_cfg = GenerationConfig(max_new_tokens=MAX_NEW_TOKENS, pad_token_id=0, eos_token_id=(T5_EOS,))
    extras = tuple(range(0, 4 * T5_SERVE_REQUESTS, 4))
    for layers, dtype in ((T5_LAYERS, torch.bfloat16), (F32_LAYERS, torch.float32)):
        bf16 = dtype == torch.bfloat16
        cfg = t5_config(layers)
        model = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=dtype).eval()
        random_init_(model, torch.Generator(device=dev).manual_seed(T5_SEED), std=0.02)
        pixel = process_videos(serving_frames(dev), dtype=dtype)
        requests = serving_requests(cfg.num_query_tokens, pixel, extras, T5_SEED, t5=True)
        for impl in ("auto", "flash") if bf16 else ("auto",):
            label = f"(d) T5 {'bf16' if bf16 else 'fp32'} {layers}-layer cut {impl}"
            with attention_impl(impl):
                eng = ContinuousBatchingEngine(model, gen_cfg, max_slots=SERVE_SLOTS, max_len=T5_SERVE_MAX_LEN,
                                               chunk_tokens=SERVE_CHUNK, prefill_bucket=SERVE_BUCKET,
                                               max_prompt_len=T5_SERVE_PROMPT)
                watch = SlotWatch(model, SERVE_SLOTS)
                done, counts, secs, steps = serve_leg(tag, label, eng, requests, T5_SERVE_ARRIVAL, [], total,
                                                      watch=watch)
                watch.handle.remove()
                n_steps = len(watch.finite)
                nan_rows = watch.nan_rows(done, SERVE_CHUNK)
                flagged_rows = {rid for rid, slot in watch.slot_of.items() if slot in watch.flagged}
                print(f"[{tag}] serving {label}: slots that decoded while empty {sorted(watch.flagged)}; requests "
                      f"admitted into them {sorted(flagged_rows)}; requests with non-finite logits (token 0 at each "
                      f"such step) {nan_rows}")
                # the reference's bf16 behaviour on the plain path: a request in
                # a slot that decoded empty may decode from NaN (then token 0);
                # K5 gives a fully masked row 0, and fp32 the uniform average
                if bf16 and impl == "auto":
                    assert set(nan_rows) <= flagged_rows and all(nan_rows.values()), (nan_rows, flagged_rows)
                else:
                    assert not nan_rows, nan_rows
                finite_rids = set(range(len(requests))) - set(nan_rows)
                rows, recs = isolated_rows(model, requests, gen_cfg, t5=True)
                if bf16:
                    # bf16: the engine encodes each prompt right-padded to its
                    # bucket, which rounds otherwise than the unpadded
                    # prompt's products: held to both isolated runs
                    compare_rows(tag, f"{label}, against unpadded prompts", done, rows, recs, rule="near-tie",
                                 rids=finite_rids)
                    rows, recs = isolated_rows(model, requests, gen_cfg, t5=True, pad_to=SERVE_BUCKET)
            k5 = counts["flash_attention"]
            if impl == "flash":
                q_cfg = cfg.qformer_config
                n_qf = q_cfg.num_hidden_layers + len(range(0, q_cfg.num_hidden_layers, q_cfg.cross_attention_frequency))
                encodes = len(requests) * (n_qf + cfg.text_config.num_layers)
                steps_k5 = 2 * cfg.text_config.num_decoder_layers * n_steps
                assert k5 == encodes + steps_k5, (k5, encodes, steps_k5)
                # bf16: the Q-Former and the encoder on the Hopper body, every
                # decoder step (self and cross) on the decode body
                bodies = (counts["flash_attention_sm90"], counts["flash_attention_decode"])
                assert bodies == (encodes, steps_k5), (bodies, encodes, steps_k5)
            else:
                assert k5 == 0, k5
            same = compare_rows(tag, label, done, rows, recs, rule="near-tie" if bf16 else "identical",
                                rids=finite_rids)
            result[f"t5_{'bf16' if bf16 else 'f32_cut'}_{impl}"] = dict(
                eng.stats, wall_s=secs, decoder_steps=n_steps, k5_launches=k5, identical_rows=same,
                nan_rows=sorted(nan_rows), slots_decoded_empty=sorted(watch.flagged))
        if bf16:
            # K5 at the engine's decoder step: self over (4, 1, 64) with the
            # (32, 1, 64) bias and a per-row mask with dead prefixes, cross
            # over (4, 1, 832) with right-padded rows
            g = torch.Generator(device=dev).manual_seed(16)
            rows_out = []
            for name, l_kv in (("self", T5_SERVE_MAX_LEN), ("cross", T5_SERVE_PROMPT)):
                q = torch.randn(4, 1, 32, 64, device=dev, generator=g).to(dtype)
                k = torch.randn(4, l_kv, 32, 64, device=dev, generator=g).to(dtype)
                v = torch.randn(4, l_kv, 32, 64, device=dev, generator=g).to(dtype)
                mask = torch.ones(4, l_kv, dtype=torch.int32, device=dev)
                bias = None
                if name == "self":
                    for r, start in enumerate((0, 9, 20, 31)):  # dead prefixes of reused slots
                        mask[r, :start] = 0
                    mask[:, 48:] = 0  # slots past the index
                    bias = padded_bias(32, 1, l_kv, dev, g, dtype)
                else:
                    for r, real in enumerate((766, 770, 790, 794)):
                        mask[r, real:] = 0
                kw5 = dict(padding_mask=mask, bias=bias)
                out = k5_counted("decode", lambda: fl.flash_attention(q, k, v, **kw5), f"engine {name}")
                err = check_close(tag, f"serving (d) K5 at the T5 engine's {name} step (4, 1, {l_kv}), bias "
                                       f"{None if bias is None else tuple(bias.shape)} (decode body)",
                                  out, fl.flash_attention_reference(q, k, v, **kw5), 2e-2)
                real = mask.sum(dim=1).tolist()
                nbytes = (2 * 4 + 2 * sum(real)) * 32 * 64 * 2 + 4 * l_kv * 4
                flops = 4 * sum(real) * 32 * 64
                row = _k5_bias_row(f"flash_attention at the T5 engine's {name} step (4, 1, {l_kv})", q, k, v, kw5,
                                   err, bound(flops, nbytes + (32 * l_kv * 2 if bias is not None else 0)))
                row["body"] = "decode"
                if bias is not None:  # the parent's count: the bias as the fp32 its wrapper made
                    row["bound_ms_fp32_bias"] = bound(flops, nbytes + 32 * l_kv * 4)[0]
                rows_out.append(row)
            for r in rows_out:
                time_row(tag, r)
            result["t5_engine_k5"] = rows_out
        del model


def run_serving(tag: str, dev) -> dict:
    """Phase 11: serving. Returns the numbers of the serving JSON line, the
    phase's launches by kernel among them."""
    t_phase = time.perf_counter()
    total: dict = {}
    result: dict = {"card": tag}
    for name, fn in (("(a)", lambda: serving_opt_f32(tag, dev, total, result)),
                     ("(b), (c), (e) bf16", lambda: serving_bf16(tag, dev, total, result)),
                     ("(c) K2", lambda: serving_admission_k2(tag, dev, result)),
                     ("(c), (e) fp32 cuts", lambda: serving_f32_cuts(tag, dev, total, result)),
                     ("(d)", lambda: serving_t5(tag, dev, total, result))):
        t0 = time.perf_counter()
        fn()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] serving {name} took {time.perf_counter() - t0} s")
    result["launches"] = total
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[{tag}] serving phase took {result['seconds']} s")
    return result


# ---------------------------------------------------------------------------
# phase 12: the evaluation encoders and the VideoMAE baseline
# ---------------------------------------------------------------------------

# (a) VideoMAE-base (12 x 768, 12 heads x 64, 16 frames x 224^2, tubelet 2,
# patch 16: 1,568 tokens) at videomae_train's batch, random weights from a
# seed; its training at the CLI's defaults over in-memory clips whose short
# side (240) the augmentation scales to 256-320 before the 224^2 crop
VIDEOMAE_BATCH = 8
VIDEOMAE_LABELS = 87
VIDEOMAE_SEED = 16
VIDEOMAE_TRAIN_STEPS = 3
VIDEOMAE_CLIP = (3, 16, 240, 320)
VIDEOMAE_CLIPS = 16
# (b) the three encoders at their published widths, 64 narration-length
# pairs at the metrics' batch of 32, the first 8 also scored on the CPU
ENCODER_PAIRS = 64
ENCODER_CPU_PAIRS = 8
ENCODER_SEED = 17
ENCODER_TOL = 1e-4


def encoder_configs() -> dict:
    """roberta-large (BERTScore's model), all-mpnet-base-v2 (the STS
    bi-encoder) and cross-encoder/stsb-roberta-large (1 label), as their
    config.json files give them."""
    from eilev_tpu_torch.eval.encoder import EncoderConfig

    roberta_large = dict(model_type="roberta", vocab_size=50265, hidden_size=1024, num_hidden_layers=24,
                         num_attention_heads=16, intermediate_size=4096, max_position_embeddings=514,
                         type_vocab_size=1, layer_norm_eps=1e-5, pad_token_id=1)
    return {
        "roberta-large": EncoderConfig(**roberta_large),
        "all-mpnet-base-v2": EncoderConfig(model_type="mpnet", vocab_size=30527, hidden_size=768,
                                           num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
                                           max_position_embeddings=514, layer_norm_eps=1e-5, pad_token_id=1,
                                           relative_attention_num_buckets=32),
        "stsb-roberta-large": EncoderConfig(**roberta_large, num_labels=1),
    }


class EncoderWordTokenizer:
    """A word-level tokenizer in RoBERTa's (and MPNet's) layout: <s> = 0,
    <pad> = 1, </s> = 2, a pair as <s> a </s></s> b </s>, right padding; each
    word's id a CRC of it inside the vocabulary. No encoder tokenizer is in
    the repository, and the card has no transformers: the metrics need ids
    of the right count and layout, not their text."""

    all_special_ids = [0, 1, 2]
    pad_token_id = 1

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def _ids(self, text: str) -> list:
        import zlib

        return [3 + zlib.crc32(w.encode()) % (self.vocab_size - 3) for w in re.findall(r"\w+|[^\w\s]", text.lower())]

    def __call__(self, texts, text_pair=None, padding=True, truncation=True, max_length=None, return_tensors="np"):
        rows = []
        for i, text in enumerate(texts):
            ids = [0] + self._ids(text) + [2]
            if text_pair is not None:
                ids += [2] + self._ids(text_pair[i]) + [2]
            rows.append(ids[:max_length] if truncation and max_length else ids)
        width = max(len(r) for r in rows)
        input_ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)], mask[i, : len(r)] = r, 1
        return {"input_ids": input_ids, "attention_mask": mask}


def narration_pairs(n: int, seed: int) -> tuple[list, list]:
    """``n`` (prediction, reference) narrations of 6-14 words."""
    rng = np.random.default_rng(seed)
    verbs = ("takes", "cuts", "washes", "opens", "puts", "picks up", "holds", "moves")
    nouns = ("the knife", "an onion", "the pot", "a cup", "the drawer", "a plate", "the tap", "the lid")
    tails = ("", "in the kitchen", "with the left hand", "on the table", "from the shelf", "into the sink")

    def one():
        return f"The camera wearer {rng.choice(verbs)} {rng.choice(nouns)} {rng.choice(tails)}".strip() + "."

    return [one() for _ in range(n)], [one() for _ in range(n)]


def _videomae_k5_row(name: str, q, k, v, err: float, bnd: tuple) -> dict:
    """A kernels-line row of K5 with no mask and no bias, scale D^-0.5 (the
    forms of VideoMAE and the Q-Former), for time_row: K5, its twin, one
    SDPA call."""
    from eilev_tpu_torch.ops import flash_attention as fl

    scale = q.shape[-1] ** -0.5
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return {
        "name": name,
        "source": f"eilev_tpu_torch/csrc/{'attention_f32' if q.dtype == torch.float32 else 'flash_attention'}.cu",
        "replaces": "eilev_tpu/ops/flash_attention.py:157", "max_abs_err": err, "per_call": 1,
        "run": (lambda: fl.flash_attention(q, k, v, scale=scale)),
        "plain": (lambda: fl.flash_attention_reference(q, k, v, scale=scale)),
        "library": (lambda: _sdpa(qt, kt, vt, scale=scale)),
        "bound": bnd,
    }


def check_videomae_k5(tag: str, dev: torch.device) -> list[dict]:
    """Phase 12 (a): K5 at VideoMAE's form, (8, 1,568, 12 x 64), bf16 (the
    Hopper body at head dim 64) and fp32 (attention_f32.cu's body), against
    its twin at 2e-2 and F32_TOL, each call counted once (fp32 in
    launches_f32, bf16 in launches_sm90); timed as in 3 beside one SDPA call
    and its bound: 4 B H S^2 D operations, q, k, v and out once."""
    from eilev_tpu_torch.ops import flash_attention as fl

    g = torch.Generator(device=dev).manual_seed(VIDEOMAE_SEED + 1)
    b, s, nh, hd = VIDEOMAE_BATCH, 1568, 12, 64
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        q, k, v = (torch.randn(b, s, nh, hd, device=dev, generator=g).to(dtype) for _ in range(3))
        out = k5_counted("f32" if f32 else "sm90", lambda: fl.flash_attention(q, k, v, scale=hd**-0.5), "VideoMAE")
        err = check_close(tag, f"K5 VideoMAE form{' fp32' if f32 else ''} ({b}, {s}, {nh}x{hd}), no mask, no bias "
                               f"({'fp32' if f32 else 'Hopper'} body)",
                          out, fl.flash_attention_reference(q, k, v, scale=hd**-0.5), F32_TOL if f32 else 2e-2)
        bnd = bound(4 * b * nh * s * s * hd, 4 * b * s * nh * hd * (4 if f32 else 2),
                    H100_TF32X3_FLOPS if f32 else H100_BF16_FLOPS)
        rows.append(dict(_videomae_k5_row(f"flash_attention{'_f32' if f32 else ''} at VideoMAE", q, k, v, err, bnd),
                         body="fp32" if f32 else "Hopper"))
    for r in rows:
        time_row(tag, r)
    return rows


def run_videomae(tag: str, dev: torch.device, launches: dict) -> dict:
    """Phase 12 (a): VideoMAE-base predicting at batch 8 in fp32 under
    ``auto`` (plain: kv 1,568 < 2,048, no K5) and ``flash`` (the fp32 body, 12
    launches), the same argmax; a bf16 forward under ``flash`` (the bf16
    Hopper body at head dim 64, 12 launches); then cli.baselines.videomae_train.run at
    its defaults (batch 8, fp32, ``auto``) for VIDEOMAE_TRAIN_STEPS steps over
    in-memory clips, s/step, finite losses, peak memory."""
    from eilev_tpu_torch.cli.baselines import videomae_train
    from eilev_tpu_torch.models.videomae import VideoMAEConfig, VideoMAEForVideoClassification
    from eilev_tpu_torch.ops.attention import set_default_attention_impl

    out: dict = {}
    cfg = VideoMAEConfig(num_labels=VIDEOMAE_LABELS)
    model = VideoMAEForVideoClassification(cfg, device=dev).init_weights_(
        torch.Generator().manual_seed(VIDEOMAE_SEED)).requires_grad_(False).eval()
    g = torch.Generator(device=dev).manual_seed(VIDEOMAE_SEED)
    pixel = torch.randn(VIDEOMAE_BATCH, 3, cfg.num_frames, cfg.image_size, cfg.image_size, device=dev, generator=g)
    logits, ms = {}, {}
    for impl, dtype in (("auto", torch.float32), ("flash", torch.float32), ("flash", torch.bfloat16)):
        label = f"{impl} {'fp32' if dtype == torch.float32 else 'bf16'}"
        set_default_attention_impl(impl)
        model.dtype = dtype
        try:
            with torch.no_grad():
                reset_counters()
                logits[label] = model(pixel)["logits"].float()
                torch.cuda.synchronize()
                counts = counters()
                ms[label] = min(median_ms(lambda: model(pixel), reps=5, warmup=1) for _ in range(2))
        finally:
            set_default_attention_impl("auto")
            model.dtype = torch.float32
        fired = {k: n for k, n in counts.items() if n}
        want = {} if impl == "auto" else {"flash_attention": cfg.num_hidden_layers}
        if impl == "flash":  # fp32: the fp32 body; bf16: the Hopper body at head dim 64
            want["flash_attention_f32" if dtype == torch.float32 else "flash_attention_sm90"] = cfg.num_hidden_layers
        print(f"[{tag}] VideoMAE-base predict batch {VIDEOMAE_BATCH}, {label}: ms={ms[label]} launches {fired} "
              f"logits finite={bool(torch.isfinite(logits[label]).all())}")
        assert fired == want, (label, fired, want)
        assert bool(torch.isfinite(logits[label]).all()), label
        if impl == "flash":
            launches[f"flash_attention{'_f32' if dtype == torch.float32 else ''} at VideoMAE"] = fired[
                "flash_attention"]
    delta = (logits["flash fp32"] - logits["auto fp32"]).abs().max().item()
    same = bool(torch.equal(logits["flash fp32"].argmax(-1), logits["auto fp32"].argmax(-1)))
    bf16_same = (logits["flash bf16"].argmax(-1) == logits["auto fp32"].argmax(-1)).float().mean().item()
    bf16_delta = (logits["flash bf16"] - logits["auto fp32"]).abs().max().item()
    print(f"[{tag}] VideoMAE-base fp32 logits, flash vs auto: max_abs_delta={delta} argmax identical={same}; "
          f"bf16 flash vs fp32 auto: max_abs_delta={bf16_delta} same_argmax_share={bf16_same}")
    assert same, "fp32 argmax differs between the flash and auto dispatches"
    out.update(predict_ms=ms, fp32_flash_vs_auto_max_abs=delta, bf16_vs_fp32_max_abs=bf16_delta,
               bf16_same_argmax_share=bf16_same)
    del model, pixel, logits
    gc.collect()
    torch.cuda.empty_cache()

    # videomae_train at its defaults: batch 8, fp32, auto, 16 x 224^2
    rng = np.random.default_rng(VIDEOMAE_SEED)
    verbs, nouns = ("take", "cut", "wash", "open"), ("knife", "onion", "pot", "cup")
    clips = [{"video": rng.integers(0, 256, VIDEOMAE_CLIP, dtype=np.uint8), "frame_path": f"clip{i}|0",
              "structured_verb": verbs[i % 4], "structured_noun": nouns[i // 4 % 4]} for i in range(VIDEOMAE_CLIPS)]
    import tempfile

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        args = videomae_train.parse_args([
            "--verb", "--train_frames_dir", "unused", "--val_frames_dir", "unused", "--output_dir", root,
            "--num_train_steps", str(VIDEOMAE_TRAIN_STEPS), "--eval_steps", "0", "--logging_steps", "1",
            "--device", str(dev)])
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        try:
            result = videomae_train.run(args, {"train": clips, "val": clips[:4]})
        except torch.cuda.OutOfMemoryError:
            print(f"[{tag}] videomae_train at batch {VIDEOMAE_BATCH} does not fit: the plain attention keeps "
                  f"(8, 12, 1568, 1568) fp32 scores and probabilities a layer for the backward")
            raise
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for k, n in counters().items() if n}
        saved = sorted(os.listdir(root))
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] videomae_train (VideoMAE-base, fp32, auto) batch {VIDEOMAE_BATCH}, {VIDEOMAE_TRAIN_STEPS} "
          f"steps: wall_s={wall} s_per_step={result['step_seconds']} losses={result['losses']} "
          f"peak_memory_bytes={peak} launches {counts} wrote {saved}")
    assert len(result["losses"]) == VIDEOMAE_TRAIN_STEPS and np.isfinite(result["losses"]).all()
    assert counts == {} and saved == ["labels.json", "params.pkl"], (counts, saved)
    out.update(train_s_per_step=result["step_seconds"], train_losses=result["losses"], train_peak_bytes=peak)
    del result
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_encoders(tag: str, dev: torch.device) -> dict:
    """Phase 12 (b): roberta-large, all-mpnet-base-v2 and the
    stsb-roberta-large cross-encoder at their published widths, N(0, 0.02)
    weights with unit LayerNorms from a seed, built through
    SentenceEncoder._from_parts with the encoder word tokenizer; the three
    metrics (bert_score_f1's roberta-large layer 17, sts_biencoder_cosine,
    sts_crossencoder) over ENCODER_PAIRS pairs at batch 32, each timed; the
    first ENCODER_CPU_PAIRS pairs scored on the card and by the same port
    code on the CPU, within ENCODER_TOL."""
    from eilev_tpu_torch.eval import metrics
    from eilev_tpu_torch.eval.encoder import CrossEncoderModel, SentenceEncoder, TextEncoder

    preds, refs = narration_pairs(ENCODER_PAIRS, ENCODER_SEED)
    scorers = {"roberta-large": ("bert_score_f1", metrics._bert_score_f1),
               "all-mpnet-base-v2": ("sts_biencoder_cosine", metrics._sts_biencoder_cosine),
               "stsb-roberta-large": ("sts_crossencoder", metrics._sts_crossencoder)}
    out: dict = {}
    for i, (name, cfg) in enumerate(encoder_configs().items()):
        metric, score = scorers[name]
        module = (CrossEncoderModel if cfg.num_labels else TextEncoder)(cfg, device=dev)
        random_init_(module, torch.Generator(device=dev).manual_seed(ENCODER_SEED + i), std=0.02)
        unit_norms_(module)
        state = module.state_dict()
        tok = EncoderWordTokenizer(cfg.vocab_size)
        enc = SentenceEncoder._from_parts(cfg, state, tok, device=dev)
        score(enc, preds[:2], refs[:2])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = score(enc, preds, refs)
        secs = time.perf_counter() - t0
        card = score(enc, preds[:ENCODER_CPU_PAIRS], refs[:ENCODER_CPU_PAIRS])
        cpu_enc = SentenceEncoder._from_parts(cfg, {k: v.cpu() for k, v in state.items()}, tok, device="cpu")
        cpu = score(cpu_enc, preds[:ENCODER_CPU_PAIRS], refs[:ENCODER_CPU_PAIRS])
        # what the means are made of: the cross-encoder's per-pair scores, or
        # the encoder's last hidden states, card against CPU
        if cfg.num_labels:
            pairs = list(zip(preds[:ENCODER_CPU_PAIRS], refs[:ENCODER_CPU_PAIRS]))
            parts = [e.predict_pairs(pairs) for e in (enc, cpu_enc)]
        else:
            parts = [e.hidden_states(preds[:ENCODER_CPU_PAIRS])[0][-1] for e in (enc, cpu_enc)]
        detail = float(np.abs(parts[0] - parts[1]).max())
        params = sum(v.numel() for v in state.values())
        print(f"[{tag}] encoders {name} ({cfg.num_hidden_layers} x {cfg.hidden_size}, {params} params): "
              f"{metric} over {ENCODER_PAIRS} pairs = {value} in {secs * 1e3} ms; first {ENCODER_CPU_PAIRS} pairs "
              f"card {card} vs CPU {cpu}, |delta| = {abs(card - cpu)}; "
              f"{'per-pair scores' if cfg.num_labels else 'last hidden states'} max |delta| = {detail}")
        assert np.isfinite(value) and abs(card - cpu) <= ENCODER_TOL, (name, card, cpu)
        out[metric] = {"value": value, "ms": secs * 1e3, "card_vs_cpu": abs(card - cpu), "parts_card_vs_cpu": detail}
        del module, state, enc, cpu_enc
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_eval_clis(tag: str, model, ckpt: str, size: int, frames: np.ndarray, root: str, dev) -> None:
    """Phase 10 (i), on (c)'s model: cli.get_vision_model_embs.run at batch
    8 over 8 clips (K1 = the ViT's layers, once: one encode of 64 frames,
    nothing else), cli.train_v1.run for 2 steps on the checkpoint loaded as
    the v1 model (bf16 compute, the frozen ViT under no grad: K1 = its
    layers a micro-batch forward), then cli.generation_eval.run and
    cli.verify_quality.run --generated_csv on a CSV written here."""
    from eilev_tpu_torch.cli import generation_eval, get_vision_model_embs, train_v1, verify_quality

    n_vit = model.config.vision_config.num_hidden_layers
    data = [{"video": frames[i], "frame_path": f"clip{i}|0", "narration_text": "#C C takes the knife",
             "video_uid": f"clip{i}", "clip_index": "0"} for i in range(8)]
    prefix = os.path.join(root, "embs")
    args = get_vision_model_embs.parse_args(["--model", ckpt, "--frames_dir", "unused", "--batch_size", "8",
                                             "--num_subsample_frames", str(FRAMES), "--output_prefix", prefix,
                                             "--device", str(dev)])
    reset_counters()
    t0 = time.perf_counter()
    embs = get_vision_model_embs.run(args, model, data)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: n for k, n in counters().items() if n}
    print(f"[{tag}] checkpoints (i) get_vision_model_embs run, bf16 batch 8: wall_s={secs} embs {embs.shape} "
          f"finite={bool(np.isfinite(embs).all())} launches {counts}")
    assert counts == {"packed_qkv_attention": n_vit}, counts
    assert embs.shape == (8, model.config.vision_config.hidden_size) and np.isfinite(embs).all()
    assert np.load(prefix + "_embs.npy").shape == embs.shape

    v1, _ = timed_load(tag, "(i) the v1 model", ckpt, size, dev, version="v1", dtype=torch.bfloat16)
    args = train_v1.parse_args(["--model_name_or_path", ckpt, "--train_frames_dir", "unused",
                                "--val_frames_dir", "unused", "--output_dir", os.path.join(root, "v1"),
                                "--num_subsample_frames", str(FRAMES), "--num_train_steps", "2",
                                "--per_device_train_batch_size", "2", "--gradient_accumulation_steps", "1",
                                "--warmup_steps", "0", "--eval_steps", "2", "--save_steps", "2",
                                "--logging_steps", "1", "--device", str(dev)])
    reset_counters()
    t0 = time.perf_counter()
    trainer = train_v1.run(args, v1, WordTokenizer(), {"train": data, "val": data[:2]})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {k: n for k, n in counters().items() if n}
    print(f"[{tag}] checkpoints (i) train_v1 run, bf16, 2 steps of 2 clips + an eval: wall_s={secs} "
          f"best_eval_loss={trainer.best_eval_loss} launches {counts}")
    assert trainer.state.step == 2 and np.isfinite(trainer.best_eval_loss)
    assert set(counts) == {"packed_qkv_attention"} and counts["packed_qkv_attention"] % n_vit == 0, counts
    del trainer, v1
    gc.collect()
    torch.cuda.empty_cache()

    preds, refs = narration_pairs(8, ENCODER_SEED + 5)
    gen_csv = os.path.join(root, "generated.csv")
    with open(gen_csv, "w", newline="") as f:
        w = csv.DictWriter(f, ["frame_path", "generated", "ground_truth"])
        w.writeheader()
        w.writerows({"frame_path": f"clip{i}|0", "generated": p, "ground_truth": r}
                    for i, (p, r) in enumerate(zip(preds, refs)))
    metrics = generation_eval.run(generation_eval.parse_args(["--input_csv", gen_csv, "--device", str(dev)]))
    code = 0
    try:
        verify_quality.run(verify_quality.parse_args(["--generated_csv", f"16={gen_csv}", "--tolerance", "0.02",
                                                      "--work_dir", root, "--device", str(dev)]))
    except SystemExit as e:
        code = e.code
    print(f"[{tag}] checkpoints (i) generation_eval {metrics}; verify_quality --generated_csv exit code {code} "
          "(random narrations against the published 16-shot table: FAIL expected)")
    assert set(metrics) == {"bleu", "rougeL"} and code == 1


def run_eval_baselines(tag: str, dev: torch.device, launches: dict) -> tuple[list, dict]:
    """Phase 12: (a) K5 at VideoMAE's form, VideoMAE-base predict and
    train; (b) the encoders. Returns the K5 rows and the phase's numbers."""
    t_phase = time.perf_counter()
    result: dict = {"card": tag}
    t0 = time.perf_counter()
    rows = check_videomae_k5(tag, dev)
    result["videomae"] = run_videomae(tag, dev, launches)
    print(f"[{tag}] eval (a) VideoMAE took {time.perf_counter() - t0} s")
    t0 = time.perf_counter()
    result["encoders"] = run_encoders(tag, dev)
    print(f"[{tag}] eval (b) encoders took {time.perf_counter() - t0} s")
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[{tag}] eval and baselines phase took {result['seconds']} s")
    return rows, result


# ---------------------------------------------------------------------------
# phase 13: tensor parallelism on one card
# ---------------------------------------------------------------------------


def _tp_cut(name: str, dev, tp=None):
    """The fp32 cut ``name`` ("opt": the 2.7b widths, "t5": flan-t5-xl's,
    "llama": Llama-2-7b's; F32_LAYERS a stack) with N(0, 0.02) weights from
    its seed: the model itself, or under ``tp`` this rank's local-head model
    holding its shard of those weights (built whole, sharded by
    shard_state_dict, the whole one freed). Returns (model, config)."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.generation.text_lm import _TextOnlyModule
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.parallel.tensor import shard_state_dict

    if name == "llama":
        cfg = configs.VideoBlipConfig(text_config=configs.LlamaConfig(num_hidden_layers=F32_LAYERS))
        cls, layout = _TextOnlyModule, cfg.text_config
    else:
        cfg = f32_cut_config() if name == "opt" else t5_config(F32_LAYERS)
        cls, layout = VideoBlipForConditionalGeneration, cfg
    full = cls(cfg, device=dev, dtype=torch.float32).eval()
    random_init_(full, torch.Generator(device=dev).manual_seed(TP_SEED + ("opt", "t5", "llama").index(name) + 1))
    if tp is None:
        return full, cfg
    local = cls(cfg, device="meta", dtype=torch.float32, tp=tp).eval()
    shards = shard_state_dict(full.state_dict(), layout, tp)
    local.load_state_dict({k: v.clone(memory_format=torch.contiguous_format) for k, v in shards.items()},
                          strict=True, assign=True)
    del full, shards
    return local, cfg


def _tp_class_ids(dev) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(TP_SEED).integers(1000, 40000, size=(TP_CLASSES, TP_CLASS_LEN))).to(dev)


@torch.inference_mode()
def _tp_classify(model, run, dev) -> torch.Tensor:
    """ICL classify of the run's prompt over the TP_CLASSES class continuations."""
    from eilev_tpu_torch.generation.classify import classify
    from eilev_tpu_torch.ops.preprocess import process_videos

    return classify(model, prompt_input_ids=run.ids, prompt_attention_mask=run.mask,
                    pixel_values=process_videos(run.frames, dtype=run.dtype), prompt_video_input_mask=run.vim,
                    class_input_ids=_tp_class_ids(dev))


def _tp_cut_runs(dev, tp=None) -> dict:
    """Phase 13 (b) on one side (the unsharded port, or a rank under ``tp``):
    each fp32 cut's greedy tokens (F32_NEW_TOKENS; LLAMA_NEW for the text LM,
    whose cache of 2,048 slots makes auto take K5) and launches, the OPT
    cut's classify scores, and the LLaMA cut in bf16 too (K5's Hopper body
    at the local 16 x 128), with its prefill's last logits."""
    out = {}
    for name in ("opt", "t5", "llama"):
        model, cfg = _tp_cut(name, dev, tp)
        if name == "llama":
            run = TextRun(model, (LLAMA_PROMPT,), LLAMA_PROMPT, dev, seed=3)  # 2,048 slots: auto takes K5
        else:
            run = (Narration if name == "opt" else T5Narration)(model, cfg, 1, dev, dtype=torch.float32,
                                                              new_tokens=F32_NEW_TOKENS)
        reset_counters()
        tokens = run.generate()
        torch.cuda.synchronize()
        out[name] = {"tokens": tokens.cpu(), "counts": counters()}
        if name == "opt":
            out[name]["classify"] = _tp_classify(model, run, dev).cpu()
        if name == "llama":
            model.to(torch.bfloat16)
            reset_counters()
            tokens, rec = greedy_with_logits(run)
            out["llama_bf16"] = {"tokens": tokens.cpu(), "counts": counters(), "logits": [r.cpu() for r in rec]}
        del model, run
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tp_narration(tag: str, dev, path: str, mesh, forced: dict, after=None) -> dict:
    """Phase 13 (a) on a rank: eilev-blip2-opt-2.7b loaded through
    load_model(mesh=) from the parent's bf16 checkpoint, greedy at batch 1
    (32 new tokens), then with the int8 KV cache: each counted (counters at 0
    just before, read just after), its tokens and every step's last logits,
    peak memory and the host time of the counted request and, in bf16,
    TP_REPS more; then the same request teacher-forced with the unsharded
    run's tokens (``forced``: label -> (tokens, LM forwards)), every step's
    logits and the pass's time; ``after(label, model)`` after each leg
    (phase 15's work on the same model, tps_legs)."""
    from eilev_tpu_torch.models.auto import load_model
    from eilev_tpu_torch.ops.quantization import quantize_model_

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, cfg = load_model(path, dtype=torch.bfloat16, param_dtype=torch.bfloat16, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    out = {"load_s": time.perf_counter() - t0, "params": sum(p.numel() for p in model.parameters()),
           "weights_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    run = Narration(model, cfg, 1, dev)
    for label in ("bf16", "int8_kv"):
        if label == "int8_kv":
            quantize_model_(model, int8_kv=True)
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        t0 = time.perf_counter()
        tokens, rec = greedy_with_logits(run)
        times = [time.perf_counter() - t0]
        counts = counters()
        for _ in range(TP_REPS if label == "bf16" else 0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run.generate()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[label] = {"tokens": tokens.cpu(), "logits": [r.cpu() for r in rec], "counts": counts,
                      "peak_bytes": torch.cuda.max_memory_allocated(), "times_s": times}
        t0 = time.perf_counter()
        out[label]["forced_logits"] = [r.cpu() for r in forced_logits(run, *forced[label])]
        out[label]["forced_s"] = time.perf_counter() - t0
        if mesh.model_rank == 0:
            print(f"[{tag}] tensor parallelism (a) rank 0 {label}: launches {counts} times_s={times} "
                  f"peak_bytes={out[label]['peak_bytes']}")
        if after is not None:
            after(label, model)
    del model, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_rank_main(rank: int, tag: str, port: int, root: str) -> None:
    """One rank of phase 13: a gloo group of TP_RANKS on the one card (CUDA
    tensors), one model axis; (a) and (b) on it, and phase 15's work (its
    (a), (c) and (d) on (a)'s model, then its (b)), saved to
    root/rank{rank}.pt. Any failure raises, which fails the parent's join."""
    import datetime

    import torch.distributed as dist

    from eilev_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=TP_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=TP_DEADLINE_S))
    try:
        mesh = make_mesh(data=1, model=TP_RANKS, device="cuda")
        assert mesh.tp is not None and mesh.device == torch.device("cuda", 0), mesh
        dev, serving = mesh.device, {}
        t0 = time.perf_counter()
        forced = torch.load(os.path.join(root, "forced_tokens.pt"))
        out = {"a": _tp_narration(tag, dev, os.path.join(root, "opt-2.7b"), mesh, forced,
                                  tps_legs(tag, root, dev, serving, mesh))}
        out["a_s"] = time.perf_counter() - t0 - serving["after_bf16_s"] - serving["after_int8_kv_s"]
        t0 = time.perf_counter()
        out["b"] = _tp_cut_runs(dev, mesh.tp)
        out["b_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serving["b"] = tps_cut_runs(dev, mesh.tp)
        serving["b_s"] = time.perf_counter() - t0
        out["serving"] = serving
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tp_kernel_rows(tag: str, dev) -> list[dict]:
    """Phase 13 (c): the kernels at the local-head shapes of TP = 2, each
    against its twin (2e-2 bf16; K4 against dequantize_kv + the twin, 3e-2 at
    4 rows, K4_TIGHT_TOL at 1) and timed as in phase 3 beside SDPA and its
    bound: K1 (136, 257, 8 x 88); K2 (1, 766, 16 x 80), causal; K3 and K4
    over 798 slots (780 filled), 16 x 80, at batch 1 and 4 (K3's split at
    both); K5 (1, 1,984 into 2,048 slots, 16 x 128), causal, on its Hopper
    body."""
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import flash_attention as fl
    from eilev_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(TP_SEED)
    rows = []
    b, s, nh, hd = 136, 257, 8, 88
    qkv1 = torch.randn(b, s, 3 * nh * hd, device=dev, generator=g).to(torch.bfloat16)
    q1, k1, v1 = qkv1.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
    err = check_close(tag, "tp K1 packed_qkv_attention (136,257,8x88)", fa.packed_qkv_attention(qkv1, nh, hd),
                      fa.packed_qkv_attention_reference(qkv1, nh, hd, hd**-0.5), 2e-2)
    rows.append({"name": "packed_qkv_attention at tp 2 (136,257,8x88)",
                 "source": "eilev_tpu_torch/csrc/packed_attention.cu", "replaces": "eilev_tpu/ops/fused_attention.py:81",
                 "max_abs_err": err, "per_call": 1,
                 "run": lambda: fa.packed_qkv_attention(qkv1, nh, hd),
                 "plain": lambda: fa.packed_qkv_attention_reference(qkv1, nh, hd, hd**-0.5),
                 "library": lambda: _sdpa(q1, k1, v1, scale=hd**-0.5),
                 "bound": bound(4 * b * nh * s * s * hd, 4 * b * s * nh * hd * 2)})
    b2, s2, nh2, hd2 = 1, 766, 16, 80
    qkv2 = torch.randn(b2, s2, 3 * nh2 * hd2, device=dev, generator=g).to(torch.bfloat16)
    ones = torch.ones(b2, s2, dtype=torch.int32, device=dev)
    q2, k2, v2 = qkv2.view(b2, s2, 3, nh2, hd2).permute(2, 0, 3, 1, 4)
    err = check_close(tag, "tp K2 packed_qkv_causal_attention (1,766,16x80)",
                      fa.packed_qkv_causal_attention(qkv2, nh2, hd2, ones),
                      fa.packed_qkv_causal_attention_reference(qkv2, nh2, hd2, ones, hd2**-0.5), 2e-2)
    rows.append({"name": "packed_qkv_causal_attention at tp 2 (1,766,16x80)",
                 "source": "eilev_tpu_torch/csrc/packed_attention.cu",
                 "replaces": "eilev_tpu/ops/fused_attention.py:187", "max_abs_err": err, "per_call": 1,
                 "run": lambda: fa.packed_qkv_causal_attention(qkv2, nh2, hd2, ones),
                 "plain": lambda: fa.packed_qkv_causal_attention_reference(qkv2, nh2, hd2, ones, hd2**-0.5),
                 "library": lambda: _sdpa(q2, k2, v2, is_causal=True, scale=hd2**-0.5),
                 "bound": bound(4 * b2 * nh2 * hd2 * s2 * (s2 + 1) // 2, 4 * b2 * s2 * nh2 * hd2 * 2 + b2 * s2 * 4)})
    for shape in TP_DECODE_SHAPES:
        c = _decode_case(dev, g, da, shape)
        n_layers, bd, sd, filled, nhd, hdd = c.dims
        assert da.k3_split(bd, nhd, sd), f"K3 at {shape}: expected the split (2 * {bd} * {nhd} <= 132)"
        print(f"[{tag}] tp K3 bf16 {shape}: k3_split picks the split, a cluster of {da.cluster_size(bd, nhd, sd)}")
        full = torch.ones_like(c.mask)
        errs = [check_close(tag, f"tp K3 decode_attention_stacked bf16 {shape} {name} mask",
                            da.decode_attention_stacked(c.q, c.kb, c.vb, mask, 17, **c.kw),
                            da.decode_attention_stacked_reference(c.q, c.kb, c.vb, mask, 17, **c.kw), 2e-2)
                for name, mask in (("full", full), ("mid-decode", c.mask))]
        ref = da.decode_attention_stacked_reference(
            c.q, da.dequantize_kv(c.k8[17:18].view(1, bd, sd, nhd, hdd), c.ks[17:18]).view(1, bd, sd, nhd * hdd),
            da.dequantize_kv(c.v8[17:18].view(1, bd, sd, nhd, hdd), c.vs[17:18]).view(1, bd, sd, nhd * hdd),
            c.mask, 0, **c.kw)
        err4 = check_close(tag, f"tp K4 decode_attention_stacked int8 {shape} mid-decode mask vs dequantize_kv + twin",
                           da.decode_attention_stacked(c.q, c.k8, c.v8, c.mask, 17, **c.i8), ref,
                           K4_TOL if bd >= 4 else K4_TIGHT_TOL)
        sd_q, sd_mask = c.q.view(bd, nhd, 1, hdd), c.mask.bool()[:, None, None, :]
        rows += [{"name": f"decode_attention_stacked_bf16 at {shape} ({bd},{sd},{nhd}x{hdd})",
                  "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                  "replaces": "eilev_tpu/ops/decode_attention.py:117", "max_abs_err": max(errs),
                  "run": _k3_step(da, c), "plain": _k3_step(da, c, plain=True), "per_call": n_layers,
                  "library": lambda c=c, sd_q=sd_q, sd_mask=sd_mask, hd=hdd: [
                      _sdpa(sd_q, c.k5[i].transpose(1, 2), c.v5[i].transpose(1, 2), attn_mask=sd_mask,
                            scale=hd**-0.5) for i in range(c.dims[0])],
                  "bound": _decode_bound(c, int8=False)},
                 {"name": f"decode_attention_stacked_int8 at {shape} ({bd},{sd},{nhd}x{hdd})",
                  "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                  "replaces": "eilev_tpu/ops/decode_attention.py:75", "max_abs_err": err4,
                  "run": _k4_step(da, c), "plain": _k4_step(da, c, plain=True), "per_call": n_layers,
                  "library": None, "bound": _decode_bound(c, int8=True)}]
    nh5 = 16
    q, k, v, mask = _k5_inputs(dev, g, 1, LLAMA_PROMPT, LLAMA_CACHE, nh5, 128, (LLAMA_PROMPT,), tail_empty=True)
    kw5 = dict(padding_mask=mask, causal=True, scale=128**-0.5)
    before = fl.flash_attention.launches_sm90
    out = fl.flash_attention(q, k, v, **kw5)
    torch.cuda.synchronize()
    assert fl.flash_attention.launches_sm90 == before + 1, "K5 at 16 x 128 did not take its Hopper body"
    err = check_close(tag, "tp K5 flash_attention (1,1984 into 2048,16x128) causal (Hopper body)", out,
                      fl.flash_attention_reference(q, k, v, **kw5), 2e-2)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    rows.append({"name": "flash_attention at tp 2 (1,1984 into 2048,16x128)",
                 "source": "eilev_tpu_torch/csrc/flash_attention.cu", "replaces": "eilev_tpu/ops/flash_attention.py:157",
                 "max_abs_err": err, "per_call": 1,
                 "run": lambda: fl.flash_attention(q, k, v, **kw5),
                 "plain": lambda: fl.flash_attention_reference(q, k, v, **kw5),
                 "library": lambda: _sdpa(qt, kt, vt, is_causal=True, scale=128**-0.5),
                 "bound": bound(*_k5_causal_work((LLAMA_PROMPT,), LLAMA_PROMPT, nh5, 128, LLAMA_CACHE))})
    for r in rows:
        time_row(tag, r)
    return rows


def export_tp_checkpoint(model, cfg, root: str) -> str:
    """``model`` (bf16) as an HF checkpoint with its config.json in
    root/opt-2.7b, which phases 13 and 15 load through load_model(mesh=)."""
    from eilev_tpu_torch.training.checkpoint import export_hf_safetensors

    path = os.path.join(root, "opt-2.7b")
    export_hf_safetensors(model, cfg, path, dtype=torch.bfloat16)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump(hf_config_dict(cfg), fh)
    return path


def run_tensor_parallel(tag: str, dev: torch.device, root: str) -> tuple[list, dict, list, dict]:
    """Phase 13: tensor-parallel inference (parallel/tensor.py) at TP = 2 on
    the one card, TP_RANKS gloo ranks over CUDA tensors beside the unsharded
    port in this process. (a) eilev-blip2-opt-2.7b at full width and depth,
    bf16 N(0, 0.02) weights from TP_SEED exported once in bf16 (into
    ``root``, where phase 15 loads it again) and loaded by
    each rank through load_model(mesh=): greedy at batch 1 and with the int8
    KV cache, against the unsharded model: the prefill's last logits' cosine
    > 0.999, tokens identical or parting at a near-tie, the ranks' tokens
    equal; K1 = 39 (8 x 88), K2 = 32 (16 x 80), K3 (K4) = 32 a one-token
    forward on every rank. (b) The fp32 cuts (TF32 off): the 2.7b widths,
    flan-t5-xl's and Llama-2-7b's (1,984-token prompt: K5), F32_LAYERS a
    stack, greedy tokens identical to the unsharded port's, ICL classify at
    the OPT cut within 1e-4; the LLaMA cut in bf16 too (K5's Hopper body at
    16 x 128). (c) The kernels at the local-head shapes (_tp_kernel_rows),
    with their launches from (a) and (b). Phase 15 runs inside it, on the
    same two sides' models (tps_legs, then tps_check). Returns (rows, the
    phase's JSON, phase 15's rows, phase 15's JSON)."""
    import torch.multiprocessing as mp

    from eilev_tpu_torch import configs
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.ops.quantization import quantize_model_

    t_phase = time.perf_counter()
    result: dict = {}
    cfg = configs.blip2_opt_2_7b()
    model = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=torch.bfloat16).eval()
    random_init_(model, torch.Generator(device=dev).manual_seed(TP_SEED))
    t0 = time.perf_counter()
    export_tp_checkpoint(model, cfg, root)
    result["export_s"] = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    run = Narration(model, cfg, 1, dev)
    ref, serving = {}, {}
    after = tps_legs(tag, root, dev, serving)
    for label in ("bf16", "int8_kv"):
        if label == "int8_kv":
            quantize_model_(model, int8_kv=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tokens, rec = greedy_with_logits(run)
        ref[label] = {"tokens": tokens.cpu(), "logits": [r.cpu() for r in rec],
                      "peak_bytes": torch.cuda.max_memory_allocated(), "s": time.perf_counter() - t0}
        # the teacher-forced pass fed the run's own tokens gives its logits
        # bit for bit: the ranks' forced pass replays this request's inputs
        t0 = time.perf_counter()
        own = forced_logits(run, tokens, len(rec))
        ref[label]["forced_s"] = time.perf_counter() - t0
        assert len(own) == len(rec) and all(torch.equal(a, b) for a, b in zip(own, rec)), \
            f"(a) {label}: the teacher-forced pass does not replay greedy's logits"
        after(label, model)
    del model, run
    gc.collect()
    torch.cuda.empty_cache()
    ref["b"] = _tp_cut_runs(dev)
    t0 = time.perf_counter()
    serving["b"] = tps_cut_runs(dev)
    serving["seconds"] = time.perf_counter() - t0 + serving["after_bf16_s"] + serving["after_int8_kv_s"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.save({label: (ref[label]["tokens"], len(ref[label]["logits"])) for label in ("bf16", "int8_kv")},
               os.path.join(root, "forced_tokens.pt"))
    t0 = time.perf_counter()
    ctx = mp.spawn(tp_rank_main, args=(tag, _free_port(), root), nprocs=TP_RANKS, join=False)
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > TP_DEADLINE_S:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"the tensor-parallel ranks did not finish in {TP_DEADLINE_S} s")
    result["ranks_s"] = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(TP_RANKS)]

    # (a) against the unsharded model; the ranks against each other
    a = result["a"] = {"unsharded_weights_bytes": weights}
    for label in ("bf16", "int8_kv"):
        mine, theirs = ranks[0]["a"][label], ref[label]
        for other in ranks[1:]:
            assert torch.equal(other["a"][label]["tokens"], mine["tokens"]), f"(a) {label}: the ranks' tokens differ"
        cos = torch.nn.functional.cosine_similarity(mine["logits"][0], theirs["logits"][0], dim=-1).min().item()
        share = compare_speculative(tag, f"tensor parallelism (a) {label} TP = 2 vs unsharded", mine["tokens"],
                                     theirs["tokens"], theirs["logits"])
        counts = mine["counts"]
        decode = "decode_attention_stacked_int8" if label == "int8_kv" else "decode_attention_stacked_bf16"
        one_token = len(mine["logits"]) - 1
        want = {"packed_qkv_attention": 39, "packed_qkv_causal_attention": 32, decode: 32 * one_token}
        assert {k: counts[k] for k in want} == want, (label, counts, want)
        assert all(v == 0 for k, v in counts.items() if k not in want), (label, counts)
        steps = step_agreement(mine["forced_logits"][1:], theirs["logits"][1:])
        for other in ranks[1:]:
            assert all(torch.equal(x, y) for x, y in zip(other["a"][label]["forced_logits"], mine["forced_logits"])), \
                f"(a) {label}: the ranks' teacher-forced logits differ"
        times = sorted(mine["times_s"][1:])
        a[label] = {"prefill_logits_min_cosine": cos, "decode_steps_teacher_forced": steps,
                    "forced_s_per_rank": [r["a"][label]["forced_s"] for r in ranks],
                    "unsharded_forced_s": theirs["forced_s"], "identical_rows_share": share,
                    "tokens": mine["tokens"][0].tolist(), "launches": {k: counts[k] for k in want},
                    "peak_bytes_per_rank": [r["a"][label]["peak_bytes"] for r in ranks],
                    "unsharded_peak_bytes": theirs["peak_bytes"],
                    "p50_s": statistics.median(times) if times else None, "counted_s": mine["times_s"][0],
                    "unsharded_s": theirs["s"]}
        print(f"[{tag}] tensor parallelism (a) eilev-blip2-opt-2.7b bf16 b1 {label} TP = 2 (two ranks on one card: "
              f"the time is no TP speed): {a[label]}")
        assert cos > 0.999, (label, cos)
        assert steps["min_cosine"] > 0.999, (label, steps)
    a["load_s"] = [r["a"]["load_s"] for r in ranks]
    a["local_weights_bytes"] = [r["a"]["weights_bytes"] for r in ranks]
    a["rank_a_s"] = [r["a_s"] for r in ranks]

    # (b) the fp32 cuts token for token; classify within 1e-4; LLaMA in bf16
    b = result["b"] = {"rank_b_s": [r["b_s"] for r in ranks]}
    for name in ("opt", "t5", "llama"):
        mine, theirs = ranks[0]["b"][name], ref["b"][name]
        for other in ranks[1:]:
            assert torch.equal(other["b"][name]["tokens"], mine["tokens"]), f"(b) {name}: the ranks' tokens differ"
        same = bool(torch.equal(mine["tokens"], theirs["tokens"]))
        b[name] = {"identical": same, "tokens": mine["tokens"][0].tolist(),
                   "launches": {k: v for k, v in mine["counts"].items() if v}}
        print(f"[{tag}] tensor parallelism (b) fp32 {name} cut TP = 2: tokens {mine['tokens'][0].tolist()} vs "
              f"unsharded {theirs['tokens'][0].tolist()}: identical={same}; launches {b[name]['launches']}")
        assert same, f"(b) fp32 {name}: TP = 2 tokens differ from the unsharded port's"
    assert b["opt"]["launches"].get("packed_qkv_causal_attention_f32") == F32_LAYERS, b["opt"]
    assert b["llama"]["launches"].get("flash_attention_f32") == F32_LAYERS, b["llama"]
    err = (ranks[0]["b"]["opt"]["classify"] - ref["b"]["opt"]["classify"]).abs().max().item()
    b["opt_classify_max_abs_err"] = err
    print(f"[{tag}] tensor parallelism (b) fp32 OPT cut ICL classify ({TP_CLASSES} classes) TP = 2 vs unsharded: "
          f"max_abs_err={err}")
    assert err <= 1e-4, err
    mine, theirs = ranks[0]["b"]["llama_bf16"], ref["b"]["llama_bf16"]
    cos = torch.nn.functional.cosine_similarity(mine["logits"][0], theirs["logits"][0], dim=-1).min().item()
    b["llama_bf16"] = {"prefill_logits_min_cosine": cos, "launches": {k: v for k, v in mine["counts"].items() if v},
                       "identical_rows_share": compare_speculative(tag, "tensor parallelism (b) LLaMA cut bf16",
                                                                    mine["tokens"], theirs["tokens"],
                                                                    theirs["logits"])}
    assert cos > 0.999 and b["llama_bf16"]["launches"].get("flash_attention_sm90") == F32_LAYERS, b["llama_bf16"]

    # (c) the kernels at the local-head shapes, with their launches in (a)/(b)
    rows = _tp_kernel_rows(tag, dev)
    a_bf16, a_int8 = ranks[0]["a"]["bf16"]["counts"], ranks[0]["a"]["int8_kv"]["counts"]
    from_runs = [a_bf16["packed_qkv_attention"], a_bf16["packed_qkv_causal_attention"],
                 a_bf16["decode_attention_stacked_bf16"], a_int8["decode_attention_stacked_int8"], 0, 0,
                 ranks[0]["b"]["llama_bf16"]["counts"]["flash_attention"]]
    for r, n in zip(rows, from_runs, strict=True):
        r.update(route="cuda", launches=n)
    serving_rows, serving_result = tps_check(tag, cfg, [r["serving"] for r in ranks], serving)
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[{tag}] tensor parallelism phase (13, with 15) took {result['seconds']} s")
    return rows, result, serving_rows, serving_result


# ---------------------------------------------------------------------------
# phase 14: tensor-parallel training on one card
# ---------------------------------------------------------------------------


def _tpt_optimizer(record: dict = None):
    """Phase 14's optimizer (TPT_OCFG, the clip at the recipe's 1.0); with
    ``record`` the first update's gradients, as the clip gets them (this
    rank's shards under tensor parallelism), are kept there in fp32."""
    from eilev_tpu_torch.training import OptimizerConfig, make_optimizer
    from eilev_tpu_torch.training.train_state import GradientTransformation

    tx = make_optimizer(OptimizerConfig(**TPT_OCFG))
    if record is None:
        return tx

    def update(grads, state, params, g_norm=None):
        if not record:
            record.update({k: g.detach().float().clone() for k, g in grads.items()})
        return tx.update(grads, state, params, g_norm)

    return GradientTransformation(tx.init, update)


def _tpt_model(cfg, dev, dtype, seed: int, tp=None):
    """Phase 14's model of ``cfg`` in ``dtype`` with fp32 trainable masters,
    N(0, 0.02) from ``seed``, its towers frozen: whole, or under ``tp`` this
    rank's local-head model holding its shard (built whole, sharded by
    shard_state_dict, the whole one freed)."""
    from eilev_tpu_torch.models import VideoBlipForConditionalGeneration
    from eilev_tpu_torch.parallel.tensor import shard_state_dict
    from eilev_tpu_torch.training import freeze_towers

    full = VideoBlipForConditionalGeneration(cfg, device=dev, dtype=dtype, trainable_dtype=torch.float32)
    random_init_(full, torch.Generator(device=dev).manual_seed(seed))
    if tp is not None:
        local = VideoBlipForConditionalGeneration(cfg, device="meta", dtype=dtype, trainable_dtype=torch.float32,
                                                  tp=tp)
        shards = shard_state_dict(full.state_dict(), cfg, tp)
        local.load_state_dict({k: v.clone(memory_format=torch.contiguous_format) for k, v in shards.items()},
                              strict=True, assign=True)
        del full, shards
        gc.collect()
        torch.cuda.empty_cache()
        full = local
    freeze_towers(full)
    return full


def _tpt_steps(model, batch: dict, mesh=None, record: dict = None) -> dict:
    """Two steps of make_train_step (dropout on), the first counted (the
    counters at 0 just before, read just after) and the second timed, peak
    memory over both. Returns the numbers and the final state ("state")."""
    from eilev_tpu_torch.training import TrainState, make_train_step, partition_params

    trainable, _ = partition_params(dict(model.named_parameters()))
    state = TrainState.create(trainable, _tpt_optimizer(record))
    step = make_train_step(model, accum_steps=1, dropout=True, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"metrics": [], "weights_bytes": sum(p.numel() * p.element_size() for p in model.parameters())}
    for i in range(2):
        if i == 0:
            reset_counters()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["counted_s" if i == 0 else "step_s"] = time.perf_counter() - t0
        if i == 0:
            out["counts"] = counters()
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["state"] = state
    return out


def _tpt_cuts() -> list:
    """Phase 14 (b)'s fp32 cuts: (name, config, the function that makes its batch)."""
    return [("opt", f32_cut_config(), _train_batch), ("t5", t5_config(F32_LAYERS), _t5_train_batch)]


def tpt_rank_main(rank: int, tag: str, port: int, root: str) -> None:
    """One rank of phase 14: a gloo group of TP_RANKS on the one card (CUDA
    tensors), data 1 x model TP_RANKS; (a) and (b) on it, saved to
    root/rank{rank}.pt (rank 0 also the gathered gradients and leaves), the
    TP checkpoints and exports under root. Any failure raises, which fails
    the parent's join."""
    import datetime

    import torch.distributed as dist

    from eilev_tpu_torch import configs
    from eilev_tpu_torch.parallel import make_mesh
    from eilev_tpu_torch.parallel.tensor import is_model_sharded, unshard_state_dict
    from eilev_tpu_torch.training import save_checkpoint
    from eilev_tpu_torch.training.checkpoint import export_hf_safetensors

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=TP_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=TPT_DEADLINE_S))
    try:
        mesh = make_mesh(data=1, model=TP_RANKS, device="cuda")
        assert mesh.tp is not None and mesh.device == torch.device("cuda", 0), mesh
        dev, tp = mesh.device, mesh.tp
        t0 = time.perf_counter()
        cfg = configs.blip2_opt_2_7b()
        model = _tpt_model(cfg, dev, torch.bfloat16, TPT_SEED, tp)
        grads: dict = {}
        run = _tpt_steps(model, _train_batch(cfg, 1, dev), mesh, record=grads)
        state = run.pop("state")
        full = unshard_state_dict(grads, cfg, tp)  # a collective: both ranks
        run["grads"] = {k: g.cpu() for k, g in full.items()} if rank == 0 else None
        run["replicated"] = {k: p.detach().cpu() for k, p in state.trainable.items()
                             if not is_model_sharded(k, cfg, tp)}
        run["sharded_leaves"] = sum(is_model_sharded(k, cfg, tp) for k in state.trainable)
        out = {"a": run}
        del model, state, grads, full
        gc.collect()
        torch.cuda.empty_cache()
        out["a_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["b"] = {}
        for name, cut, make_batch in _tpt_cuts():
            model = _tpt_model(cut, dev, torch.float32, TPT_SEED + 1, tp)
            run = _tpt_steps(model, make_batch(cut, 1, dev, dtype=torch.float32), mesh)
            state = run.pop("state")
            whole = unshard_state_dict(state.trainable, cut, tp)
            run["trainable"] = {k: p.detach().cpu() for k, p in whole.items()} if rank == 0 else None
            run["checkpoint"] = save_checkpoint(os.path.join(root, f"ckpt_{name}"), state, mesh=mesh, config=cut)
            export = os.path.join(root, f"export_{name}")
            export_hf_safetensors(model, cut, export)  # gathered; rank 0 writes
            if rank == 0:
                with open(os.path.join(export, "config.json"), "w") as fh:
                    json.dump(hf_config_dict(cut), fh)
            out["b"][name] = run
            del model, state, whole
            gc.collect()
            torch.cuda.empty_cache()
        out["b_s"] = time.perf_counter() - t0
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tpt_compare(a: dict, ref: dict) -> dict:
    """Run ``a`` against ``ref`` (metrics and trainable leaves): the largest
    relative error of each step's loss and grad_norm, the largest absolute
    error of any leaf element and its leaf."""
    out = {f"step{s + 1}_{key}_rel_err": abs(a["metrics"][s][key] - ref["metrics"][s][key])
           / abs(ref["metrics"][s][key]) for s in range(2) for key in ("loss", "grad_norm")}
    errs = {k: float((a["trainable"][k].double() - r.double()).abs().max()) for k, r in ref["trainable"].items()}
    out["leaf_max_abs_err"], out["worst_leaf"] = max((e, k) for k, e in errs.items())
    assert a["trainable"].keys() == ref["trainable"].keys()
    return out


def run_tensor_parallel_training(tag: str, dev: torch.device) -> dict:
    """Phase 14: tensor-parallel training at TP = 2 on the one card (see the
    module's docstring). Returns the phase's JSON."""
    import tempfile

    import torch.multiprocessing as mp

    from eilev_tpu_torch import configs
    from eilev_tpu_torch.models.auto import load_model
    from eilev_tpu_torch.training import (OptimizerConfig, TrainState, freeze_towers, make_optimizer,
                                          partition_params, restore_checkpoint)

    t_phase = time.perf_counter()
    result: dict = {"card": tag}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        # the unsharded references first, each freed before the ranks start
        cfg = configs.blip2_opt_2_7b()
        model = _tpt_model(cfg, dev, torch.bfloat16, TPT_SEED)
        grads: dict = {}
        ref_a = _tpt_steps(model, _train_batch(cfg, 1, dev), record=grads)
        del ref_a["state"], model
        ref_a["grads"] = {k: g.cpu() for k, g in grads.items()}
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        ref_b = {}
        for name, cut, make_batch in _tpt_cuts():
            ref_b[name] = {}
            for dtype in (torch.float32, torch.float64):  # the port's own step, and its fp64 yardstick
                model = _tpt_model(cut, dev, torch.float32, TPT_SEED + 1)
                batch = make_batch(cut, 1, dev, dtype=torch.float32)
                if dtype == torch.float32:
                    ref_b[name]["frozen"] = {k: p.detach().cpu() for k, p in model.named_parameters()
                                             if not p.requires_grad}
                    run = _tpt_steps(model, batch)
                else:
                    model.double()  # the dropout masks are drawn in fp32 whatever the dtype: the same ones
                    with plain_kernels():
                        run = _tpt_steps(model, {k: v.double() if v.is_floating_point() else v
                                                 for k, v in batch.items()})
                run["trainable"] = {k: p.detach().cpu() for k, p in run.pop("state").trainable.items()}
                ref_b[name][str(dtype).split(".")[-1]] = run
                del model, batch
                gc.collect()
                torch.cuda.empty_cache()
        result["references_s"] = time.perf_counter() - t_phase

        t0 = time.perf_counter()
        ctx = mp.spawn(tpt_rank_main, args=(tag, _free_port(), root), nprocs=TP_RANKS, join=False)
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > TPT_DEADLINE_S:
                for proc in ctx.processes:
                    proc.kill()
                raise TimeoutError(f"the tensor-parallel training ranks did not finish in {TPT_DEADLINE_S} s")
        result["ranks_s"] = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(TP_RANKS)]

        # (a) the full model in bf16 against the unsharded step
        n_vit = cfg.vision_config.num_hidden_layers
        a = result["a"] = {}
        for step in range(2):
            for key in ("loss", "grad_norm"):
                ours, theirs = ranks[0]["a"]["metrics"][step][key], ref_a["metrics"][step][key]
                rel = abs(ours - theirs) / abs(theirs)
                a[f"step{step + 1}_{key}"] = {"tp": ours, "unsharded": theirs, "rel_err": rel}
                assert np.isfinite(ours) and rel < 2e-2, (step, key, ours, theirs)
        for other in ranks[1:]:
            assert other["a"]["metrics"] == ranks[0]["a"]["metrics"], "the ranks' losses differ"
        got, want = ranks[0]["a"]["grads"], ref_a["grads"]
        assert got.keys() == want.keys()
        a["step1_whole_gradient_cosine"] = _cosine(torch.cat([got[k].flatten() for k in want]),
                                                   torch.cat([g.flatten() for g in want.values()]))
        rep = [r["a"]["replicated"] for r in ranks]
        unequal = [k for k, t in rep[0].items() if not all(torch.equal(t, other[k]) for other in rep[1:])]
        a["replicated_leaves"], a["replicated_bit_identical"] = len(rep[0]), not unequal
        a["sharded_leaves"] = ranks[0]["a"]["sharded_leaves"]
        want_counts = dict.fromkeys(ref_a["counts"], 0)
        want_counts["packed_qkv_attention"] = n_vit  # 39 a micro-batch forward (no grad); K2-K6 never
        for r in ranks:
            assert r["a"]["counts"] == want_counts, (r["a"]["counts"], want_counts)
        assert ref_a["counts"] == want_counts, ref_a["counts"]
        a["k1_launches_per_rank"] = [r["a"]["counts"]["packed_qkv_attention"] for r in ranks]
        a["k1_kernel"] = "packed_qkv_attention at tp 2 (136,257,8x88)"
        a["weights_bytes_per_rank"] = [r["a"]["weights_bytes"] for r in ranks]
        a["peak_bytes_per_rank"] = [r["a"]["peak_bytes"] for r in ranks]
        a["unsharded_weights_bytes"], a["unsharded_peak_bytes"] = ref_a["weights_bytes"], ref_a["peak_bytes"]
        a["step_s_per_rank"] = [r["a"]["step_s"] for r in ranks]
        a["counted_s_per_rank"] = [r["a"]["counted_s"] for r in ranks]
        a["unsharded_step_s"], a["unsharded_counted_s"] = ref_a["step_s"], ref_a["counted_s"]
        print(f"[{tag}] tensor-parallel training (a) eilev-blip2-opt-2.7b bf16 (fp32 Q-Former masters) TP = 2, "
              f"two steps, dropout on, clip on (two gloo ranks on one card: the step time is a one-card gloo "
              f"schedule's, no TP speed): {a} unequal_replicated={unequal[:3]}")
        assert not unequal and a["sharded_leaves"] > 0
        assert all(p < ref_a["peak_bytes"] for p in a["peak_bytes_per_rank"]), a["peak_bytes_per_rank"]

        # (b) the fp32 cuts: every gathered leaf against the fp64 step, the
        # checkpoint and the export
        b = result["b"] = {}
        for name, cut, _ in _tpt_cuts():
            mine, theirs = ranks[0]["b"][name], ref_b[name]
            row = b[name] = {"tp_vs_fp64": _tpt_compare(mine, theirs["float64"]),
                             "unsharded_fp32_vs_fp64": _tpt_compare(theirs["float32"], theirs["float64"]),
                             "tp_vs_unsharded_fp32": _tpt_compare(mine, theirs["float32"])}
            print(f"[{tag}] tensor-parallel training (b) fp32 {name} cut ({F32_LAYERS} layers a stack) TP = 2, two "
                  f"steps, dropout on, against the unsharded port's step in fp64: {row}")
            got = row["tp_vs_fp64"]
            assert all(v < TPT_TOL for k, v in got.items() if k.endswith("rel_err")), (name, got)
            assert got["leaf_max_abs_err"] < TPT_TOL, (name, got)
            row["k1_f32_launches_per_rank"] = [r["b"][name]["counts"]["packed_qkv_attention_f32"] for r in ranks]
            assert row["k1_f32_launches_per_rank"] == [F32_LAYERS] * TP_RANKS, row
            model, _ = load_model(os.path.join(root, f"export_{name}"), dtype=torch.float32, device=dev)
            sd = {k: v.cpu() for k, v in model.state_dict().items()}
            trained, frozen = partition_params(sd)
            row["export_trainable_bit_identical"] = all(torch.equal(v, mine["trainable"][k]) for k, v in trained.items())
            row["export_frozen_as_they_came_in"] = (frozen.keys() == theirs["frozen"].keys() and all(
                torch.equal(v, theirs["frozen"][k]) for k, v in frozen.items()))
            fresh = TrainState.create(freeze_towers(model)[0], make_optimizer(OptimizerConfig(**TPT_OCFG)))
            state = restore_checkpoint(mine["checkpoint"], fresh)
            row["checkpoint_restores_bit_identical"] = state.step == 2 and all(
                torch.equal(p.cpu(), mine["trainable"][k]) for k, p in state.trainable.items())
            row["peak_bytes_per_rank"] = [r["b"][name]["peak_bytes"] for r in ranks]
            row["unsharded_peak_bytes"] = theirs["float32"]["peak_bytes"]
            print(f"[{tag}] tensor-parallel training (b) fp32 {name} cut: K1 fp32 launches a rank "
                  f"{row['k1_f32_launches_per_rank']}, export and checkpoint {row}")
            assert (row["export_trainable_bit_identical"] and row["export_frozen_as_they_came_in"]
                    and row["checkpoint_restores_bit_identical"]), row
            del model, state, fresh, sd
            gc.collect()
            torch.cuda.empty_cache()
    result["rank_a_s"] = [r["a_s"] for r in ranks]
    result["rank_b_s"] = [r["b_s"] for r in ranks]
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[{tag}] tensor-parallel training phase took {result['seconds']} s")
    return result


# ---------------------------------------------------------------------------
# phase 15: tensor-parallel serving on one card
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def engine_log():
    """Every ContinuousBatchingEngine's submitted requests (by rid), its
    completions and the last engine built, while the block runs (cli/serve.py
    builds its engine inside run)."""
    from eilev_tpu_torch.serving import engine as engine_mod

    cls = engine_mod.ContinuousBatchingEngine
    submit, step = cls.submit, cls.step
    log: dict = {"requests": {}, "done": {}, "engine": None}

    def logged_submit(self, request):
        rid = submit(self, request)
        log["requests"][rid], log["engine"] = request, self
        return rid

    def logged_step(self):
        out = step(self)
        log["done"].update((c.rid, c) for c in out)
        return out

    cls.submit, cls.step = logged_submit, logged_step
    try:
        yield log
    finally:
        cls.submit, cls.step = submit, step


@contextlib.contextmanager
def decode_step_log(model, log: dict, max_new: int):
    """The logits each OPT serving row's tokens were chosen from in its decode
    chunks (serving/engine.py's calls of decoding._decode_chunk, wrapped
    here; the engine itself is not changed), by rid and token position:
    position e + j of a row that had emitted e tokens before the chunk is
    chosen from the chunk's input logits (j = 0) or from its j-th one-token
    forward. Kept on the device while the block runs (no added host sync),
    fp32, one (vocab,) row each, then moved to the host. ``log`` is
    engine_log's (its engine the one stepping)."""
    from eilev_tpu_torch.serving import engine as engine_mod

    real = engine_mod._decode_chunk
    rows: dict = {}
    forwards: list = []
    handle = model.language_model.register_forward_hook(
        lambda mod, args, out: forwards.append(out[0][:, -1].float()) if args[0].shape[1] == 1 else None)

    def logged(model_, cache, logits, finished, gen_cfg, noise, chunk):
        eng = log["engine"]
        slots = [(s_, req.rid, len(eng._emitted[s_])) for s_, req in enumerate(eng._active) if req is not None]
        first = logits.float()
        forwards.clear()
        out = real(model_, cache, logits, finished, gen_cfg, noise, chunk)
        for slot, rid, emitted in slots:
            for j in range(chunk):
                if emitted + j < max_new:
                    rows.setdefault(rid, {})[emitted + j] = (first if j == 0 else forwards[j - 1])[slot]
        return out

    engine_mod._decode_chunk = logged
    try:
        yield rows
    finally:
        engine_mod._decode_chunk = real
        handle.remove()
        for rid in rows:
            rows[rid] = {t: x.cpu() for t, x in rows[rid].items()}


@contextlib.contextmanager
def collective_log():
    """Counts of torch.distributed's all_reduce and broadcast_object_list
    calls while the block runs (parallel/tensor.py and cli/serve.py look them
    up on the module at each call)."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "broadcast_object_list": 0}
    saved = {name: getattr(dist, name) for name in counts}

    def counted(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for name in counts:
        setattr(dist, name, counted(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def tps_dataset(n: int, seed: int) -> tuple[list, dict, int]:
    """(a)'s serve datasets: ``n`` datapoints of SHOTS in-context shots shared
    by every request (frame paths shot0..15, one set of videos) and a query
    video of its own (query{d}), each shot narrated in 4 words; the lazy
    frame loader the feature cache reads the misses through (uint8 (3,
    FRAMES, 224, 224) frames by frame path); and the prompt length P that
    cli/serve.py's prompt builder gives every datapoint."""
    from eilev_tpu_torch import configs
    from eilev_tpu_torch.cli.serve import PROMPT
    from eilev_tpu_torch.data.prompts import generate_input_ids_and_labels_from_interleaved
    from eilev_tpu_torch.data.text import clean_narration_text

    rng = np.random.default_rng(seed)
    frames = {}
    verbs, nouns = ("takes", "cuts", "washes", "opens"), ("the knife", "an onion", "the pot", "a cup")

    def item(path):
        frames[path] = rng.integers(0, 256, size=(3, FRAMES, 224, 224), dtype=np.uint8)
        return {"frame_path": path, "video_uid": path, "clip_index": "0",
                "narration_text": f"#C C {verbs[rng.integers(4)]} {nouns[rng.integers(4)]}"}

    shots = [item(f"shot{s}") for s in range(SHOTS)]
    data = [{"items": shots + [item(f"query{d}")]} for d in range(n)]
    tokenizer, q = WordTokenizer(), configs.blip2_opt_2_7b().num_query_tokens
    lengths = {len(generate_input_ids_and_labels_from_interleaved(
        tokenizer, [(PROMPT + " " + clean_narration_text(i["narration_text"]), 1) for i in d["items"][:-1]]
        + [(PROMPT, 1)], None, q, True)["input_ids"]) for d in data}
    assert len(lengths) == 1, lengths
    return data, {"frame_loader": lambda path: frames[path]}, lengths.pop()


def tps_serve_args(p: int, out_csv: str, dev, model_parallel: int):
    """cli/serve.py's arguments of (a): TPS_SLOTS slots, chunk TPS_CHUNK,
    TPS_NEW new tokens, prefill bucket TPS_BUCKET (it divides P, so no bf16
    admission is left-padded) and max_len P + TPS_NEW (an admission behind a
    decoded row compacts first, so every admission starts at slot 0), the
    feature cache, staggered open-loop arrivals."""
    from eilev_tpu_torch.cli import serve as cli

    assert p % TPS_BUCKET == 0, (p, TPS_BUCKET)
    return cli.parse_args([
        "--model", "unused", "--eval_frames_dir", "unused", "--in_context_query_map_file", "unused",
        "--in_context_example_frames_dir", "unused", "--num_eval_datapoints", str(TPS_REQUESTS),
        "--max_new_tokens", str(TPS_NEW), "--max_slots", str(TPS_SLOTS), "--max_len", str(p + TPS_NEW),
        "--chunk_tokens", str(TPS_CHUNK), "--prefill_bucket", str(TPS_BUCKET), "--vision_cache", "64",
        "--arrival_rate", str(TPS_RATE), "--model_parallel", str(model_parallel), "--output_csv", out_csv,
        "--device", str(dev)])


def tps_serve(model, root: str, dev, model_parallel: int) -> dict:
    """(a) on one side: cli/serve.run over (a)'s datasets, counted (counters
    at 0 just before, read just after) and held to serving_counts (K1 for
    each feature-cache encode, K2 for each admission, K3 for each one-token
    forward); the completions, each admission's last logits, the requests
    and the engine's feature cache (dropped before a rank saves), the
    all_reduces a token step
    (between two one-token forwards of a decode chunk: the forward's and
    the next token's embedding), the schedule's broadcasts, the weights and
    peak memory, the time."""
    from eilev_tpu_torch.cli import serve as cli

    data, extra, p = tps_dataset(TPS_REQUESTS, TPS_SEED)
    args = tps_serve_args(p, os.path.join(root, f"serve_mp{model_parallel}.csv"), dev, model_parallel)
    calls, handle = lm_call_log(model)
    encodes: list = []
    marks: list = []
    admitted: list = []  # each admission's last-position logits, in admission (rid) order
    enc = model.vision_model.register_forward_hook(lambda mod, a, out: encodes.append(a[0].shape[0]))
    adm = model.language_model.register_forward_hook(
        lambda mod, a, out: admitted.append(out[0][0, -1].float().cpu()) if a[0].shape[1] > 1 else None)
    with collective_log() as colls:
        pre = model.language_model.register_forward_pre_hook(
            lambda mod, a: marks.append((a[0].shape[1], colls["all_reduce"])))
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with engine_log() as log, decode_step_log(model, log, TPS_NEW) as step_logits:
            rows, metrics = cli.run(args, model, WordTokenizer(), {"dataset": data, **extra})
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        counts = counters()
        pre.remove()
    handle.remove()
    enc.remove()
    adm.remove()
    want = serving_counts(model, calls, len(encodes), f32=False)
    assert counts == want, (counts, want)
    assert all(ok for _, ok in prefills(calls)) and not any(p_ for p_, _ in prefills(calls)), prefills(calls)
    step_colls = sorted({b[1] - a[1] for a, b in zip(marks, marks[1:]) if a[0] == b[0] == 1})
    eng = log["engine"]
    return {"done": {rid: c.tokens for rid, c in log["done"].items()}, "requests": log["requests"],
            "cache": eng.feature_cache, "rows": rows, "metrics": metrics, "admission_logits": admitted,
            "step_logits": step_logits,
            "counts": counts, "encodes": encodes, "admissions": len(prefills(calls)),
            "one_token_forwards": sum(1 for s, _, _, _ in calls if s == 1), "stats": dict(eng.stats),
            "all_reduce": colls["all_reduce"], "broadcasts": colls["broadcast_object_list"],
            "all_reduce_per_token_step": step_colls, "prompt_len": p, "seconds": secs,
            "weights_bytes": sum(t.numel() * t.element_size() for t in [*model.parameters(), *model.buffers()]),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "kv_bytes": sum(v.numel() * v.element_size() for v in eng._cache.values() if torch.is_tensor(v))}


def tps_reference_rows(model, log: dict) -> tuple[list, list]:
    """The unsharded model's isolated generate of each request of (a) (its
    videos' features from the engine's cache, as the engine scattered them)
    and the logits each token was chosen from."""
    from eilev_tpu_torch.generation import GenerationConfig

    gen_cfg = GenerationConfig(max_new_tokens=TPS_NEW, pad_token_id=1).with_eos(
        model.config.text_config.eos_token_id)
    rows, recs = [], []
    for rid in sorted(log["requests"]):
        req = log["requests"][rid]
        feats = log["cache"].features(req.feature_keys)
        r, rec = isolated_rows(model, [req], gen_cfg, video_features=feats)
        rows += r
        recs += rec
    return rows, recs


def tps_capture(model, requests: dict, cache) -> dict:
    """(d)'s captured cache: an engine of TPS_CAPTURE slots on the model
    (bucket TPS_BUCKET, the features from ``cache``) admits (a)'s requests
    at once and decodes one chunk; its shared cache (this rank's 16 heads)
    and mask, and its bytes."""
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.serving import ContinuousBatchingEngine

    slots, max_len = TPS_CAPTURE
    gen_cfg = GenerationConfig(max_new_tokens=TPS_NEW, pad_token_id=1)
    eng = ContinuousBatchingEngine(model, gen_cfg, max_slots=slots, max_len=max_len, chunk_tokens=TPS_CHUNK,
                                   prefill_bucket=TPS_BUCKET, feature_cache=cache)
    for rid in sorted(requests)[:slots]:
        eng.submit(dataclasses.replace(requests[rid]))
    eng.step()
    torch.cuda.synchronize()
    c = eng._cache
    return {"k": c["k"], "v": c["v"], "mask": c["mask"].clone(), "index": c["index"],
            "kv_bytes": sum(v.numel() * v.element_size() for v in c.values() if torch.is_tensor(v))}


def tps_kernel_rows(tag: str, dev, cap: dict) -> list[dict]:
    """(d): the kernels at this slice's shapes against their twins, timed as
    in phase 3 beside SDPA and the bound: K1 at a feature-cache encode of
    TP = 2 (8 videos x 8 frames, 257, 8 x 88); K2 at an admission (1, 768,
    16 x 80) left-padded by 2 (NaN in the two padded query rows of both, the
    reference's mask; the real rows at 2e-2); K3 over the captured engine
    cache (4 x 2,048, 16 x 80, (a)'s requests after one chunk) with a query
    per row, at the middle layer against the twin (2e-2) and timed over the
    32 layers; K4 over the same cache quantized by quantize_kv against
    dequantize_kv + the twin (K4_TOL)."""
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(TPS_SEED)
    rows = []
    b, s, nh, hd = 8 * FRAMES, 257, 8, 88
    qkv1 = torch.randn(b, s, 3 * nh * hd, device=dev, generator=g).to(torch.bfloat16)
    q1, k1, v1 = qkv1.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
    err = check_close(tag, f"tps K1 packed_qkv_attention at a feature-cache encode ({b},257,8x88)",
                      fa.packed_qkv_attention(qkv1, nh, hd), fa.packed_qkv_attention_reference(qkv1, nh, hd, hd**-0.5),
                      2e-2)
    rows.append({"name": f"packed_qkv_attention at a TP = 2 feature-cache encode ({b},257,8x88)",
                 "source": "eilev_tpu_torch/csrc/packed_attention.cu", "replaces": "eilev_tpu/ops/fused_attention.py:81",
                 "max_abs_err": err, "per_call": 1,
                 "run": lambda: fa.packed_qkv_attention(qkv1, nh, hd),
                 "plain": lambda: fa.packed_qkv_attention_reference(qkv1, nh, hd, hd**-0.5),
                 "library": lambda: _sdpa(q1, k1, v1, scale=hd**-0.5),
                 "bound": bound(4 * b * nh * s * s * hd, 4 * b * s * nh * hd * 2)})
    nh2, hd2, w = 16, 80, 768
    qkv = torch.randn(1, w, 3 * nh2 * hd2, device=dev, generator=g).to(torch.bfloat16)
    mask = torch.ones(1, w, dtype=torch.int32, device=dev)
    mask[:, :2] = 0
    out = fa.packed_qkv_causal_attention(qkv, nh2, hd2, mask)
    ref = fa.packed_qkv_causal_attention_reference(qkv, nh2, hd2, mask, hd2**-0.5)
    assert bool(torch.isnan(out[:, :2]).all() and torch.isnan(ref[:, :2]).all())
    err = check_close(tag, "tps K2 at a TP = 2 admission (1, 768, 16x80), left-padded by 2, real rows",
                      out[:, 2:], ref[:, 2:], 2e-2)
    d2 = nh2 * hd2
    q2, k2, v2 = (qkv[..., i * d2:(i + 1) * d2].reshape(1, w, nh2, hd2).transpose(1, 2) for i in range(3))
    fold = torch.where(torch.tril(torch.ones(w, w, dtype=torch.bool, device=dev)) & mask.bool()[:, None, None, :],
                       0.0, -torch.inf).to(torch.bfloat16)
    rows.append({"name": "packed_qkv_causal_attention at a TP = 2 admission (1, 768, 16x80), left-padded by 2",
                 "source": "eilev_tpu_torch/csrc/packed_attention.cu", "replaces": "eilev_tpu/ops/fused_attention.py:187",
                 "max_abs_err": err, "per_call": 1,
                 "run": lambda: fa.packed_qkv_causal_attention(qkv, nh2, hd2, mask),
                 "plain": lambda: fa.packed_qkv_causal_attention_reference(qkv, nh2, hd2, mask, hd2**-0.5),
                 "library": lambda: _sdpa(q2, k2, v2, attn_mask=fold),
                 "bound": bound(*_k5_causal_work([w - 2], w, nh2, hd2, w))})
    k5, v5, cmask = cap["k"], cap["v"], cap["mask"]
    n_layers, bd, sd, nhd, hdd = k5.shape
    filled = int(cmask.sum(dim=1).max())
    flat = lambda x: x.reshape(n_layers, bd, sd, nhd * hdd)  # noqa: E731
    k8, ks = da.quantize_kv(k5)
    v8, vs = da.quantize_kv(v5)
    c = SimpleNamespace(q=torch.randn(bd, nhd * hdd, device=dev, generator=g).to(torch.bfloat16), k5=k5, v5=v5,
                        kb=flat(k5), vb=flat(v5), k8=flat(k8), v8=flat(v8), ks=ks, vs=vs, mask=cmask,
                        kw=dict(num_heads=nhd, head_dim=hdd, scale_query=True),
                        dims=(n_layers, bd, sd, filled, nhd, hdd))
    c.i8 = dict(k_scale=ks, v_scale=vs, **c.kw)
    li = n_layers // 2
    err3 = check_close(tag, f"tps K3 over the captured TP engine cache ({bd},{sd},{nhd}x{hdd}), {filled} filled, "
                       f"layer {li}", da.decode_attention_stacked(c.q, c.kb, c.vb, cmask, li, **c.kw),
                       da.decode_attention_stacked_reference(c.q, c.kb, c.vb, cmask, li, **c.kw), 2e-2)
    ref4 = da.decode_attention_stacked_reference(
        c.q, da.dequantize_kv(c.k8[li:li + 1].view(1, bd, sd, nhd, hdd), ks[li:li + 1]).view(1, bd, sd, nhd * hdd),
        da.dequantize_kv(c.v8[li:li + 1].view(1, bd, sd, nhd, hdd), vs[li:li + 1]).view(1, bd, sd, nhd * hdd),
        cmask, 0, **c.kw)
    err4 = check_close(tag, "tps K4 over the captured TP engine cache quantized, vs dequantize_kv + twin",
                       da.decode_attention_stacked(c.q, c.k8, c.v8, cmask, li, **c.i8), ref4, K4_TOL)
    sd_q, sd_mask = c.q.view(bd, nhd, 1, hdd), cmask.bool()[:, None, None, :]
    rows += [{"name": f"decode_attention_stacked_bf16 over a TP = 2 engine cache ({bd},{sd},{nhd}x{hdd})",
              "source": "eilev_tpu_torch/csrc/decode_attention.cu", "replaces": "eilev_tpu/ops/decode_attention.py:117",
              "max_abs_err": err3, "run": _k3_step(da, c), "plain": _k3_step(da, c, plain=True),
              "per_call": n_layers,
              "library": lambda: [_sdpa(sd_q, k5[i].transpose(1, 2), v5[i].transpose(1, 2), attn_mask=sd_mask,
                                        scale=hdd**-0.5) for i in range(n_layers)],
              "bound": _decode_bound(c, int8=False)},
             {"name": f"decode_attention_stacked_int8 over a TP = 2 engine cache ({bd},{sd},{nhd}x{hdd})",
              "source": "eilev_tpu_torch/csrc/decode_attention.cu", "replaces": "eilev_tpu/ops/decode_attention.py:75",
              "max_abs_err": err4, "run": _k4_step(da, c), "plain": _k4_step(da, c, plain=True),
              "per_call": n_layers, "library": None, "bound": _decode_bound(c, int8=True)}]
    for r in rows:
        time_row(tag, r, reps=TPS_TIMING_REPS)
    return rows


def tps_int8_run(model, dev) -> Narration:
    """(c)'s request: the narration layout cut to its first TPS_INT8_VIDEOS
    videos (an in-context shot and the query, 91 tokens: a W8A8 prefill of
    at least W8A8_PREFILL_MIN_ROWS rows), TPS_NEW new tokens."""
    run = Narration(model, model.config, 1, dev, new_tokens=TPS_NEW)
    keep = 1 + TPS_INT8_VIDEOS * (model.config.num_query_tokens + 1 + TEXT_TOKENS_PER_SHOT)
    run.ids, run.mask, run.vim = run.ids[:, :keep], run.mask[:, :keep], run.vim[:, :keep]
    run.frames, run.n_videos = run.frames[:TPS_INT8_VIDEOS], TPS_INT8_VIDEOS
    return run


def tps_int8(dev, model) -> dict:
    """(c) on one side: ``model`` (bf16 weights over phase 13's int8 KV
    cache, a rank's or unsharded) quantized in place into int8_lm +
    w8a8_prefill + int8_vision + int8_qformer, what load_model does after its
    load (on a rank: the row-parallel layers' scales over the model group),
    then greedy on tps_int8_run's request with its logits, counted; the
    bytes of its weights (the int8 w8, their scales and the float rest)."""
    from eilev_tpu_torch.ops.quantization import quantize_model_

    quantize_model_(model, int8_lm=True, w8a8_prefill=True, int8_vision=True, int8_qformer=True)
    run = tps_int8_run(model, dev)
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, rec = greedy_with_logits(run)
    secs = time.perf_counter() - t0
    return {"tokens": tokens.cpu(), "logits": [r.cpu() for r in rec], "counts": counters(), "seconds": secs,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "weights_bytes": sum(t.numel() * t.element_size() for t in [*model.parameters(), *model.buffers()]),
            "int8_bytes": sum(t.numel() for t in model.buffers() if t.dtype == torch.int8)}


def _tps_drive(eng, requests: list, arrivals) -> dict:
    """Request i submitted before step arrivals[i]; {rid: tokens}."""
    done, pending, steps = {}, list(range(len(requests))), 0
    while pending or not eng.idle:
        for i in [i for i in pending if arrivals[i] <= steps]:
            eng.submit(dataclasses.replace(requests[i]))
            pending.remove(i)
        done.update((c.rid, torch.from_numpy(c.tokens)) for c in eng.step())
        steps += 1
    return done


def tps_cut_runs(dev, tp=None) -> dict:
    """(b) on one side (the unsharded port, or a rank under ``tp``): the
    fp32 cuts of phase 13 (_tp_cut, F32_LAYERS a stack) through the engine
    on three staggered 16-shot requests (P = 766, 769, 772; videos encoded
    once by a feature cache): the OPT cut with prompt lookup, a two-turn
    ChatSession, then greedy over the int8 KV cache; the flan-t5-xl cut
    under "flash" (K5's bias form at its local heads). Each run's tokens
    and launches (counters at 0 just before, read just after)."""
    from eilev_tpu_torch.generation import GenerationConfig
    from eilev_tpu_torch.ops.attention import set_default_attention_impl
    from eilev_tpu_torch.ops.preprocess import process_videos
    from eilev_tpu_torch.ops.quantization import quantize_model_
    from eilev_tpu_torch.serving import ChatSession, ContinuousBatchingEngine, VideoFeatureCache

    out = {}
    gen_cfg = GenerationConfig(max_new_tokens=TPS_NEW, pad_token_id=1, eos_token_id=(NEWLINE,))
    model, cfg = _tp_cut("opt", dev, tp)
    pixel = process_videos(serving_frames(dev), dtype=torch.float32)
    requests = serving_requests(cfg.num_query_tokens, pixel, (0, 3, 6), TPS_SEED, keys=True)
    cache = VideoFeatureCache(model, bucket=SHOTS + 1)
    kw = dict(max_slots=TPS_SLOTS, max_len=SERVE_MAX_LEN, chunk_tokens=TPS_CHUNK, prefill_bucket=SERVE_BUCKET,
              feature_cache=cache)
    for label, spec in (("prompt_lookup", "prompt_lookup"), ("int8_kv", None)):
        if label == "int8_kv":
            quantize_model_(model, int8_kv=True)
        eng = ContinuousBatchingEngine(model, gen_cfg, speculative=spec, spec_gamma=LOOKUP_GAMMA,
                                       spec_match_len=LOOKUP_MATCH, **kw)
        reset_counters()
        done = _tps_drive(eng, requests, (0, 1, 2))
        torch.cuda.synchronize()
        out[label] = {"tokens": done, "counts": counters(), "stats": dict(eng.stats)}
        if label == "prompt_lookup":  # the two-turn session, on the model-dtype cache
            sess, q = ChatSession(model, gen_cfg), cfg.num_query_tokens
            rng = np.random.default_rng(TPS_SEED)
            ids, vim, replies = np.asarray([2]), np.asarray([0]), []
            for turn in range(2):
                ids = np.concatenate([ids, np.ones(q, np.int64), [NEWLINE],
                                      rng.integers(1000, 40000, size=TEXT_TOKENS_PER_SHOT)])
                vim = np.concatenate([vim, np.ones(q, np.int64), np.zeros(1 + TEXT_TOKENS_PER_SHOT, np.int64)])
                replies.append(sess.turn(ids, pixel[: turn + 1], vim))
                ids = np.concatenate([ids, replies[-1].astype(ids.dtype)])
                vim = np.concatenate([vim, np.zeros(len(replies[-1]), vim.dtype)])
            out["session"] = {"tokens": replies, "reused": sess.reused_last_turn}
    del model, cache, eng
    model, cfg = _tp_cut("t5", dev, tp)
    pixel = process_videos(serving_frames(dev, seed=2), dtype=torch.float32)
    requests = serving_requests(cfg.num_query_tokens, pixel, (0, 3, 6), TPS_SEED, t5=True, keys=True)
    t5_cfg = GenerationConfig(max_new_tokens=TPS_NEW, pad_token_id=0, eos_token_id=(T5_EOS,))
    eng = ContinuousBatchingEngine(model, t5_cfg, max_slots=TPS_SLOTS, max_len=T5_SERVE_MAX_LEN,
                                   chunk_tokens=TPS_CHUNK, prefill_bucket=SERVE_BUCKET,
                                   max_prompt_len=T5_SERVE_PROMPT, feature_cache=VideoFeatureCache(model, bucket=SHOTS + 1))
    set_default_attention_impl("flash")
    try:
        reset_counters()
        done = _tps_drive(eng, requests, (0, 1, 2))
        torch.cuda.synchronize()
        out["t5_flash"] = {"tokens": done, "counts": counters(), "stats": dict(eng.stats)}
    finally:
        set_default_attention_impl("auto")
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tps_legs(tag: str, root: str, dev, out: dict, mesh=None):
    """Phase 15's work on one side, as a hook of phase 13's legs (phase 13
    loads the model once a side, on a rank through load_model(mesh=)):
    after its bf16 leg, (a) serve at ``mesh``'s model parallelism (one
    process without one) and, on a rank, (d)'s capture (rank 0 checks and
    times the kernels while rank 1 waits; the unsharded side keeps the
    isolated rows and the bf16 logits of (c)'s request instead); after its
    int8 KV leg, (c) on the same model quantized in place. Fills ``out``."""
    import torch.distributed as dist

    def after(label: str, model) -> None:
        t0 = time.perf_counter()
        if label == "bf16":
            out["a"] = tps_serve(model, root, dev, TP_RANKS if mesh is not None else 1)
            if mesh is None:
                out["isolated"] = tps_reference_rows(model, out["a"])
                out["bf16_logits"] = greedy_with_logits(tps_int8_run(model, dev))[1]
            else:
                cap = tps_capture(model, out["a"]["requests"], out["a"]["cache"])
                out["capture_kv_bytes"] = cap["kv_bytes"]
                if mesh.model_rank == 0:
                    out["d"] = tps_kernel_rows(tag, dev, cap)
                del cap
                torch.cuda.empty_cache()
                dist.barrier()
            del out["a"]["requests"], out["a"]["cache"]
        else:
            out["c"] = tps_int8(dev, model)
        out[f"after_{label}_s"] = time.perf_counter() - t0

    return after


def tps_check(tag: str, cfg, ranks: list, ref: dict) -> tuple[list, dict]:
    """Phase 15: tensor-parallel serving (serving/engine.py, serving/session.py,
    cli/serve.py on a tp model) and the int8 weight modes under it at TP = 2
    on the one card, run inside phase 13 (tps_legs: on its TP_RANKS gloo
    ranks and on its unsharded model of eilev-blip2-opt-2.7b, bf16 N(0, 0.02)
    from TP_SEED, each rank's loaded through load_model(mesh=)); ``ranks``
    and ``ref`` are the two sides' results. (a) cli/serve.run at
    --model_parallel 2 over TPS_REQUESTS 16-shot requests (17 videos x 8
    frames; the 16 in-context videos shared, encoded once by --vision_cache),
    TPS_SLOTS slots, chunk TPS_CHUNK, TPS_NEW new tokens, staggered open-loop
    arrivals, no admission left-padded: the ranks' rows the same, each equal
    to the unsharded engine's or parting at a near-tie (NEAR_TIE of the
    isolated run's logits), each admission's last logits within cosine
    0.999 of the unsharded engine's; weights, peak memory, all_reduces a
    token step and K1/K2/K3 a request a rank. (b) fp32 cuts (tps_cut_runs):
    tokens identical to the unsharded engine's and session's. (c) every int8
    mode (tps_int8: the weight modes on phase 13's int8 KV cache) on the
    full-depth model at a 1-shot request: prefill cosine > INT8_MIN_COSINE
    against the unsharded bf16 model, tokens the unsharded int8 model's or
    parting at a near-tie, the int8 bytes a rank. (d) the kernels at this
    slice's shapes (tps_kernel_rows, rank 0 on its captured engine cache),
    with their launches from (a) and (b). Returns (rows, the phase's JSON)."""
    from eilev_tpu_torch.models import init_cache

    result: dict = {"parent_s": ref["seconds"]}
    ref_a, ref_b, ref_c = ref["a"], ref["b"], ref["c"]
    rows, recs = ref["isolated"]
    bf16_rec = ref["bf16_logits"]
    unsharded_same = compare_rows(tag, "tensor-parallel serving (a) the unsharded engine vs isolated generate",
                                  {rid: SimpleNamespace(tokens=t) for rid, t in ref_a["done"].items()}, rows, recs,
                                  rule="near-tie")

    # (a) the ranks against each other and the unsharded engine
    mine = ranks[0]["a"]
    for other in ranks[1:]:
        assert other["a"]["done"].keys() == mine["done"].keys(), "(a): the ranks completed different requests"
        assert all(np.array_equal(other["a"]["done"][r], t) for r, t in mine["done"].items()), \
            "(a): the ranks' tokens differ"
        assert other["a"]["counts"] == mine["counts"] and other["a"]["stats"] == mine["stats"]
    assert mine["metrics"] is not None and all(r["a"]["metrics"] is None for r in ranks[1:]), "rank 0 reports alone"
    engine_rows = [ref_a["done"][rid] for rid in sorted(ref_a["done"])]
    same = compare_rows(tag, "tensor-parallel serving (a) TP = 2 vs the unsharded engine",
                        {rid: SimpleNamespace(tokens=t) for rid, t in mine["done"].items()}, engine_rows, recs,
                        rule="near-tie")
    if same == len(engine_rows):
        assert mine["rows"] == ref_a["rows"], "(a): the same tokens gave another CSV"
    assert len(mine["admission_logits"]) == len(ref_a["admission_logits"]) == TPS_REQUESTS
    adm_cos = min(torch.nn.functional.cosine_similarity(x, y, dim=0).item()
                  for x, y in zip(mine["admission_logits"], ref_a["admission_logits"]))
    # each row's decode steps (positions 1 on; 0 is the admission's logits)
    # up to and with the first position where its tokens part from the
    # unsharded engine's: both sides chose those tokens after the same ones
    ours_steps, ref_steps, compared = [], [], {}
    for rid, theirs in ref_a["done"].items():
        got = mine["done"][rid]
        apart = np.nonzero(np.asarray(got) != np.asarray(theirs))[0]
        last = int(apart[0]) if len(apart) else len(theirs) - 1
        compared[rid] = last
        for t in range(1, last + 1):
            ours_steps.append(mine["step_logits"][rid][t])
            ref_steps.append(ref_a["step_logits"][rid][t])
    steps = step_agreement(ours_steps, ref_steps)
    steps["through_position_by_request"] = compared
    full_kv = init_cache(cfg.text_config, *TPS_CAPTURE, dtype=torch.bfloat16, device="meta")
    per_request = {k: mine["counts"][k] / TPS_REQUESTS for k in
                   ("packed_qkv_attention", "packed_qkv_causal_attention", "decode_attention_stacked_bf16")}
    a = result["a"] = {
        "prompt_len": mine["prompt_len"], "identical_to_unsharded_engine": same,
        "admission_logits_min_cosine": adm_cos, "decode_steps_vs_unsharded_engine": steps,
        "unsharded_engine_identical_to_isolated": unsharded_same,
        "tokens": {rid: t[:TPS_NEW].tolist() for rid, t in mine["done"].items()},
        "weights_bytes_per_rank": [r["a"]["weights_bytes"] for r in ranks],
        "unsharded_weights_bytes": ref_a["weights_bytes"],
        "peak_bytes_per_rank": [r["a"]["peak_bytes"] for r in ranks], "unsharded_peak_bytes": ref_a["peak_bytes"],
        "engine_kv_bytes_per_rank": [r["a"]["kv_bytes"] for r in ranks], "unsharded_engine_kv_bytes": ref_a["kv_bytes"],
        "captured_kv_bytes_per_rank": [r["capture_kv_bytes"] for r in ranks],
        "unsharded_kv_bytes_at_capture": sum(v.numel() * v.element_size() for v in full_kv.values()
                                             if torch.is_tensor(v)),
        "all_reduce_per_token_step": mine["all_reduce_per_token_step"], "all_reduce": mine["all_reduce"],
        "schedule_broadcasts": mine["broadcasts"], "launches_per_request_per_rank": per_request,
        "encodes": mine["encodes"], "admissions": mine["admissions"], "stats": mine["stats"],
        "metrics_rank0": mine["metrics"], "unsharded_metrics": ref_a["metrics"], "serve_s": mine["seconds"],
        "unsharded_serve_s": ref_a["seconds"]}
    print(f"[{tag}] tensor-parallel serving (a) eilev-blip2-opt-2.7b bf16 through cli/serve.run --model_parallel 2 "
          f"(two ranks on one card over gloo: the times are a schedule's, no TP speed): {json.dumps(a)}")
    assert a["all_reduce_per_token_step"] == [2 * cfg.text_config.num_hidden_layers + 2], a
    assert adm_cos > 0.999, adm_cos
    assert steps["min_cosine"] > 0.999, steps
    assert all(r["a"]["broadcasts"] > 0 for r in ranks) and ref_a["broadcasts"] == 0

    # (b) the fp32 cuts, token for token
    b = result["b"] = {}
    for name in ("prompt_lookup", "int8_kv", "t5_flash"):
        theirs = ref_b[name]
        for r in ranks:
            got = r["b"][name]["tokens"]
            assert got.keys() == theirs["tokens"].keys() and all(torch.equal(got[k], v) for k, v in
                                                                 theirs["tokens"].items()), \
                f"(b) fp32 {name}: TP = 2 tokens differ from the unsharded engine's"
        b[name] = {"identical": True, "launches": {k: v for k, v in ranks[0]["b"][name]["counts"].items() if v},
                   "stats": ranks[0]["b"][name]["stats"]}
    assert b["int8_kv"]["launches"].get("decode_attention_stacked_int8", 0) > 0, b["int8_kv"]
    assert b["t5_flash"]["launches"].get("flash_attention_f32", 0) > 0, b["t5_flash"]
    assert b["prompt_lookup"]["stats"]["spec_passes"] > 0, b["prompt_lookup"]
    for r in ranks:
        got = r["b"]["session"]["tokens"]
        assert len(got) == 2 and all(np.array_equal(x, y) for x, y in zip(got, ref_b["session"]["tokens"])), \
            "(b) fp32 ChatSession: TP = 2 replies differ"
    b["session"] = {"identical": True, "replies": [t.tolist() for t in ref_b["session"]["tokens"]]}
    print(f"[{tag}] tensor-parallel serving (b) fp32 cuts TP = 2: {json.dumps(b)}")

    # (c) the int8 weight modes on the full-depth model
    mine = ranks[0]["c"]
    for other in ranks[1:]:
        assert torch.equal(other["c"]["tokens"], mine["tokens"]), "(c): the ranks' tokens differ"
    cos = torch.nn.functional.cosine_similarity(mine["logits"][0], bf16_rec[0].cpu(), dim=-1).min().item()
    share = compare_speculative(tag, "tensor-parallel serving (c) int8 modes TP = 2 vs unsharded int8",
                                mine["tokens"], ref_c["tokens"], ref_c["logits"])
    n_lm = cfg.text_config.num_hidden_layers
    want = {"packed_qkv_attention": cfg.vision_config.num_hidden_layers, "packed_qkv_causal_attention": n_lm,
            "decode_attention_stacked_int8": n_lm * (len(mine["logits"]) - 1)}  # phase 13's int8 KV cache
    assert {k: mine["counts"][k] for k in want} == want, (mine["counts"], want)
    c = result["c"] = {"prefill_logits_min_cosine_vs_bf16": cos, "identical_rows_share": share,
                       "tokens": mine["tokens"][0].tolist(), "unsharded_tokens": ref_c["tokens"][0].tolist(),
                       "int8_bytes_per_rank": [r["c"]["int8_bytes"] for r in ranks],
                       "unsharded_int8_bytes": ref_c["int8_bytes"],
                       "weights_bytes_per_rank": [r["c"]["weights_bytes"] for r in ranks],
                       "unsharded_weights_bytes": ref_c["weights_bytes"],
                       "peak_bytes_per_rank": [r["c"]["peak_bytes"] for r in ranks],
                       "unsharded_peak_bytes": ref_c["peak_bytes"], "launches": {k: mine["counts"][k] for k in want},
                       "greedy_s": mine["seconds"],
                       "unsharded_greedy_s": ref_c["seconds"]}
    print(f"[{tag}] tensor-parallel serving (c) int8_lm + w8a8_prefill + int8_vision + int8_qformer (+ int8_kv) "
          f"TP = 2: {json.dumps(c)}")
    assert cos > INT8_MIN_COSINE, cos

    # (d) the kernels at this slice's shapes, with their launches from (a) and (b)
    rows_d = ranks[0]["d"]
    from_runs = [ranks[0]["a"]["counts"]["packed_qkv_attention"], ranks[0]["a"]["counts"]["packed_qkv_causal_attention"],
                 ranks[0]["a"]["counts"]["decode_attention_stacked_bf16"],
                 ranks[0]["c"]["counts"]["decode_attention_stacked_int8"]]
    for r, n in zip(rows_d, from_runs, strict=True):
        r.update(route="cuda", launches=n)
    result["rank_s"] = {k: [r[k] for r in ranks] for k in ("after_bf16_s", "after_int8_kv_s", "b_s")}
    result["seconds"] = ref["seconds"] + max(sum(r.values()) for r in
                                             ({k: r[k] for k in result["rank_s"]} for r in ranks))
    print(f"[{tag}] tensor-parallel serving (phase 15, inside phase 13) took {result['seconds']} s: the unsharded "
          f"side {ref['seconds']} s, a rank's {result['rank_s']} s")
    return rows_d, result


# phase 16: the data-preparation and sentence tools and the v1 chat, the
# tools a host without jax runs around the model. (a)'s synthetic Ego4D
# world: one 1080p video at 30 fps, 12 s, whose four narrated actions (one
# rejected) become 8-frame clips resized to 448^2 (twice the model's image
# size); (d) runs the two sentence tools at the Llama-2-7b widths on phase
# 7's module (16 rows, batch 8, 64 new tokens, newline eos; each batch's
# prompts one length, since a left-padded bf16 row is NaN on the plain
# prefill path, the reference's behaviour); (e) the v1 chat, two turns of
# 128 sampled tokens on 10 frames
DT_SIZE = (1920, 1080)
DT_FPS = 30
DT_SECONDS = 12
DT_FRAMES = 8
DT_TARGET = 448
DT_SEED = 60
DT_ACTIONS = (("take", "knife"), ("cut_(slice)", "onion_(bulb)"), ("open", "drawer"), ("wash", "plate"))
DT_REJECTED = 2
SENT_ROWS = 16
SENT_BATCH = 8
SENT_NEW = 64
LLAMA_NEWLINE = 13
CHAT_QUESTIONS = ("What is the camera wearer doing?", "What does the camera wearer do next?")
CHAT_FRAMES = 10
CHAT_NEW = 128


def write_y4m(path: str, w: int, h: int, fps: int, seconds: int, seed: int, distinct: int = 4) -> None:
    """A 4:2:0 y4m video of ``distinct`` seeded random frames, cycled."""
    rng = np.random.default_rng(seed)
    frames = [b"FRAME\n" + b"".join(rng.integers(16, 236, shape, dtype=np.uint8).tobytes()
                                    for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
              for _ in range(distinct)]
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C420jpeg\n".encode())
        for i in range(fps * seconds):
            f.write(frames[i % distinct])


def dt_world(root: str) -> dict:
    """Phase 16's synthetic Ego4D world under ``root``: the video as
    ``videos/<uid>.mp4``, fho_main.json and a split naming the video."""
    videos = os.path.join(root, "videos")
    os.makedirs(videos)
    uid = "dtvideo0"
    t0 = time.perf_counter()
    write_y4m(os.path.join(videos, uid + ".mp4"), *DT_SIZE, DT_FPS, DT_SECONDS, DT_SEED)
    actions = [{"is_rejected": j == DT_REJECTED, "is_valid_action": j != DT_REJECTED,
                "narration_timestamp_sec": 2.0 + 2.5 * j, "narration_text": f"#C C does {verb} {noun} ",
                "structured_verb": verb,
                "frames": [{"frame_type": "pnr_frame",
                            "boxes": [{"object_type": "object_of_change", "structured_noun": noun}]}]}
               for j, (verb, noun) in enumerate(DT_ACTIONS)]
    w = {"root": root, "videos": videos, "uid": uid, "kept": len(DT_ACTIONS) - 1,
         "fho_main": os.path.join(root, "fho_main.json"), "split": os.path.join(root, "split.json"),
         "video_write_s": time.perf_counter() - t0}
    with open(w["fho_main"], "w") as f:
        json.dump({"videos": [{"video_uid": uid, "annotated_intervals": [{"narrated_actions": actions}]}]}, f)
    with open(w["split"], "w") as f:
        json.dump({"split": "all", "videos": {uid: w["kept"]}}, f)
    return w


def synthetic_items(dataset, seed: int) -> list:
    """What ``dataset`` yields, with seeded random clips of the video's size
    (C, DT_FRAMES, H, W) in place of the decoder's."""
    rng = np.random.default_rng(seed)
    return [dict(action, **{k: v for k, v in ann.items() if k != "narrated_actions"}, clip_index=i,
                 video=rng.integers(0, 256, (3, DT_FRAMES, DT_SIZE[1], DT_SIZE[0]), dtype=np.uint8))
            for _, ann in dataset._paths for i, action in enumerate(ann["narrated_actions"])]


def _csv_rows(path: str) -> list:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def dt_extract_ego4d(tag: str, dev, w: dict) -> dict:
    """Phase 16 (a): the Ego4D extractor on the card in png and raw format
    and on the CPU in png; the CSVs equal, the card's frames within one
    uint8 level of the CPU's (raw equal to png), and the stage times."""
    from eilev_tpu_torch.cli.ego4d import extract_frames
    from eilev_tpu_torch.data.frame import load_frame_video
    from eilev_tpu_torch.data.video_datasets import Ego4dFHOMainDataset
    from eilev_tpu_torch.native.decoder import build_error, decoder_available

    available = decoder_available()
    print(f"[{tag}] phase 16 (a) decoder_available()={available}"
          + ("" if available else f"; build error: {build_error()}"))

    def args(out: str, fmt: str, device: str) -> list:
        return ["--fho_main_path", w["fho_main"], "--split_path", w["split"], "--video_dir_path", w["videos"],
                "--frames_dir", os.path.join(w["root"], out), "--num_subsample_frames", str(DT_FRAMES),
                "--target_size", str(DT_TARGET), "--format", fmt, "--device", device]

    dataset = Ego4dFHOMainDataset(w["fho_main"], w["split"], w["videos"], num_frames=DT_FRAMES)
    t0 = time.perf_counter()
    if available:
        route = "the native decoder, main end to end"
        stats = extract_frames.main(args("card_png", "png", str(dev)))
        wall = time.perf_counter() - t0
        items = list(dataset)
    else:
        route = "clips from a seeded generator through extract() (no decoder on this host)"
        items = synthetic_items(dataset, DT_SEED)
        t0 = time.perf_counter()
        stats = extract_frames.extract(items, extract_frames.parse_args(args("card_png", "png", str(dev))), dev)
        wall = time.perf_counter() - t0
    raw = extract_frames.extract(items, extract_frames.parse_args(args("card_raw", "raw", str(dev))), dev)
    cpu = extract_frames.extract(items, extract_frames.parse_args(args("cpu_png", "png", "cpu")),
                                 torch.device("cpu"))
    dirs = {name: os.path.join(w["root"], name) for name in ("card_png", "card_raw", "cpu_png")}
    rows = _csv_rows(os.path.join(dirs["card_png"], "narrated_actions.csv"))
    assert all(_csv_rows(os.path.join(d, "narrated_actions.csv")) == rows for d in dirs.values())
    assert [r["frame_path"] for r in rows] == [f"{w['uid']}|{i}" for i in range(w["kept"])], rows
    kept = [a for j, a in enumerate(DT_ACTIONS) if j != DT_REJECTED]
    assert [(r["structured_verb"], r["structured_noun"]) for r in rows] == kept, rows
    assert all(r["narration_text"] == r["narration_text"].strip() for r in rows)
    differ = total = 0
    for r in rows:
        assert len(os.listdir(os.path.join(dirs["card_png"], r["frame_path"]))) == DT_FRAMES
        assert os.listdir(os.path.join(dirs["card_raw"], r["frame_path"])) == [r["frame_path"] + ".npy"]
        a, b, c = (load_frame_video(pathlib.Path(dirs[name]) / r["frame_path"]).astype(np.int16)
                   for name in ("card_png", "cpu_png", "card_raw"))
        assert a.shape == (3, DT_FRAMES, DT_TARGET, DT_TARGET), a.shape
        assert np.array_equal(a, c), "raw frames differ from png"
        assert int(np.abs(a - b).max()) <= 1, "the card's frames are more than one level off the CPU's"
        differ, total = differ + int((a != b).sum()), total + a.size
    out = {"route": route, "decoder_available": available, "clips": stats["clips"],
           "clips_per_s": stats["clips"] / wall, "wall_s": wall, "decode_s": stats["decode_s"],
           "resize_s": stats["resize_s"], "write_s": stats["write_s"], "raw_resize_s": raw["resize_s"],
           "raw_write_s": raw["write_s"], "cpu_resize_s": cpu["resize_s"],
           "share_of_pixels_one_level_off_cpu": differ / total, "video_write_s": w["video_write_s"]}
    print(f"[{tag}] phase 16 (a) Ego4D extraction via {route}: {stats['clips']} clips of {DT_FRAMES} frames "
          f"{DT_SIZE[0]}x{DT_SIZE[1]} -> {DT_TARGET}^2, png: clips_per_s={out['clips_per_s']} decode_s="
          f"{stats['decode_s']} resize_s={stats['resize_s']} write_s={stats['write_s']}; raw: resize_s="
          f"{raw['resize_s']} write_s={raw['write_s']}; the CPU's resize_s={cpu['resize_s']}; CSVs equal; "
          f"frames within one uint8 level of the CPU run, share of pixels that differ={differ / total}")
    return out


def dt_extract_epic_kitchens(tag: str, dev, w: dict, available: bool) -> dict:
    """Phase 16 (b): the EPIC-KITCHENS extractor on the card over (a)'s video
    symlinked under EK-55's layout, two narrations."""
    from eilev_tpu_torch.cli.epic_kitchens import epic_kitchens_extract_frames as ek
    from eilev_tpu_torch.data.video_datasets import EpicKitchensDataset

    ek55 = os.path.join(w["root"], "ek55")
    os.makedirs(os.path.join(ek55, "videos", "train", "P01"))
    os.symlink(os.path.join(w["videos"], w["uid"] + ".mp4"), os.path.join(ek55, "videos", "train", "P01",
                                                                          "P01_01.MP4"))
    ann = os.path.join(w["root"], "ek_annotation.csv")
    sentences = ["The camera wearer opens the drawer.", "The camera wearer washes the plate."]
    with open(ann, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["video_id", "narration", "full_sent_narration", "verb", "noun", "narration_timestamp",
                         "start_timestamp", "stop_timestamp"])
        writer.writerow(["P01_01", "open drawer", sentences[0], "open", "drawer", "00:00:03.00", "00:00:02.00",
                         "00:00:04.00"])
        writer.writerow(["P01_01", "wash plate", f" {sentences[1]} ", "wash", "plate", "", "00:00:07.00",
                         "00:00:09.00"])
    argv = ["--annotation_path", ann, "--epic_kitchens_55_video_dir_path", ek55,
            "--epic_kitchens_100_video_dir_path", os.path.join(w["root"], "ek100"),
            "--frames_dir", os.path.join(w["root"], "ek_frames"), "--num_subsample_frames", str(DT_FRAMES),
            "--target_size", str(DT_TARGET), "--device", str(dev)]
    t0 = time.perf_counter()
    if available:
        stats = ek.main(argv)
    else:
        items = synthetic_items(EpicKitchensDataset(ann, ek55, os.path.join(w["root"], "ek100"),
                                                    num_frames=DT_FRAMES), DT_SEED + 1)
        stats = ek.extract(items, ek.parse_args(argv), dev, row=ek.epic_kitchens_row)
    wall = time.perf_counter() - t0
    rows = _csv_rows(os.path.join(w["root"], "ek_frames", "narrated_actions.csv"))
    assert [r["narration_text"] for r in rows] == sentences, rows
    assert [(r["frame_path"], r["structured_verb"], r["structured_noun"]) for r in rows] == [
        ("P01_01|0", "open", "drawer"), ("P01_01|1", "wash", "plate")], rows
    assert all(len(os.listdir(os.path.join(w["root"], "ek_frames", r["frame_path"]))) == DT_FRAMES for r in rows)
    print(f"[{tag}] phase 16 (b) EPIC-KITCHENS extraction: {stats['clips']} clips in {wall} s, CSV rows and "
          f"frame files as expected")
    return {"clips": stats["clips"], "wall_s": wall}


def dt_split_and_annotate(tag: str, w: dict) -> dict:
    """Phase 16 (c): the split on (a)'s world, twice (byte-identical files;
    every kept action in a split), and the structured columns backfilled
    into the CSVs of (a)'s card and CPU runs (stripped of them): the two
    outputs byte-identical and equal to (a)'s columns."""
    from eilev_tpu_torch.cli.ego4d import add_structured_verb_noun, split_train_val_test

    t0 = time.perf_counter()
    files = []
    for n in (1, 2):
        out = os.path.join(w["root"], f"splits{n}")
        splits = split_train_val_test.main([w["fho_main"], out, w["videos"]])
        assert sum(sum(v.values()) for v in splits.values()) == w["kept"], splits
        files.append([open(os.path.join(out, f"fho_main_{s}.json"), "rb").read() for s in ("train", "val", "test")])
    assert files[0] == files[1], "the split is not deterministic"
    annotated = []
    for name in ("card_png", "cpu_png"):
        rows = _csv_rows(os.path.join(w["root"], name, "narrated_actions.csv"))
        bare = os.path.join(w["root"], f"bare_{name}.csv")
        with open(bare, "w", newline="") as f:
            writer = csv.DictWriter(f, [k for k in rows[0] if not k.startswith("structured_")])
            writer.writeheader()
            writer.writerows({k: v for k, v in r.items() if not k.startswith("structured_")} for r in rows)
        out = os.path.join(w["root"], f"annotated_{name}.csv")
        add_structured_verb_noun.main([w["fho_main"], bare, out])
        annotated.append(open(out, "rb").read())
        assert _csv_rows(out) == rows, "the backfilled columns differ from the extractor's"
    assert annotated[0] == annotated[1]
    secs = time.perf_counter() - t0
    print(f"[{tag}] phase 16 (c) split (deterministic, {w['kept']} narrated actions) and annotation backfill "
          f"(the card's and the CPU's CSVs give the same bytes) in {secs} s")
    return {"split": json.loads(files[0][0]), "s": secs}


class LlamaWordTokenizer(WordTokenizer):
    """WordTokenizer with LLaMA's special ids (bos 1, eos 2, pad 0, the
    newline 13); every batch it decodes is kept (``decoded``), so a caller of
    ``TextLM.generate`` can read its tokens."""

    bos_token_id = 1
    eos_token_id = LLAMA_EOS
    pad_token_id = 0

    def __init__(self):
        self.vocab = {"\n": LLAMA_NEWLINE}
        self.decoded: list = []

    def batch_decode(self, rows, skip_special_tokens: bool = True) -> list:
        self.decoded.append(torch.as_tensor(np.asarray(rows)))
        return super().batch_decode(rows, skip_special_tokens)


def _sentence_world(root: str) -> dict:
    """The two sentence tools' inputs: SENT_ROWS verb/noun rows (structured
    classes with their parenthesised senses) and SENT_ROWS two-word phrases."""
    verbs = ["take", "cut_(slice)", "open", "wash", "put", "pick", "hold", "move"]
    nouns = ["knife", "onion_(bulb)", "drawer", "plate", "cup", "spoon", "door", "bowl"]
    ann = os.path.join(root, "std_annotation.csv")
    with open(ann, "w", newline="") as f:
        writer = csv.DictWriter(f, ["frame_path", "narration_text", "structured_verb", "structured_noun"])
        writer.writeheader()
        for i in range(SENT_ROWS):
            writer.writerow({"frame_path": f"v|{i}", "narration_text": f"#C C does {i}",
                             "structured_verb": verbs[i % 8], "structured_noun": nouns[(3 * i) % 8]})
    ek = os.path.join(root, "ek_phrases.csv")
    with open(ek, "w", newline="") as f:
        writer = csv.DictWriter(f, ["video_id", "narration"])
        writer.writeheader()
        for i in range(SENT_ROWS):
            writer.writerow({"video_id": f"P01_{i:02d}",
                             "narration": f"{verbs[i % 8].split('_')[0]} {nouns[(5 * i) % 8].split('_')[0]}"})
    return {"std": ann, "ek": ek}


def run_sentence_tools(tag: str, module, lm_calls: list, launches: dict, phase16: dict) -> None:
    """Phase 16 (d), inside phase 7 on its bf16 module (the Llama-2-7b widths,
    LLAMA_LAYERS deep): cli/ego4d/generate_std_sent and
    cli/epic_kitchens/transform_to_full_sent ``run`` over
    ``TextLM._from_parts`` and a word-level tokenizer with LLaMA's ids,
    SENT_ROWS rows in batches of SENT_BATCH, SENT_NEW new tokens, newline
    eos. Counted (K3 = the layers x one-token forwards, nothing else; the
    short prompts take the plain prefill, as in JAX); each row of the first
    batch held to the same prompt run alone: first-step logits within cosine
    0.999, tokens equal or parting at a near-tie (NEAR_TIE)."""
    from eilev_tpu_torch.cli.baselines.full_sent import PROMPT_TEMPLATE as STD_TEMPLATE
    from eilev_tpu_torch.cli.baselines.full_sent import newline_config
    from eilev_tpu_torch.cli.ego4d import generate_std_sent
    from eilev_tpu_torch.cli.epic_kitchens import transform_to_full_sent
    from eilev_tpu_torch.generation.text_lm import TextLM

    n_layers = module.config.text_config.num_hidden_layers
    rec: list = []
    handle = module.language_model.register_forward_hook(lambda mod, args, out: rec.append(out[0][:, -1].float()))
    result = {}
    try:
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
            world = _sentence_world(root)
            tools = {
                "generate_std_sent": (generate_std_sent, [
                    "--annotation", world["std"], "--annotation_with_std_sent", os.path.join(root, "std.csv")],
                    lambda rows: [STD_TEMPLATE % (r["structured_verb"].split("_", 1)[0],
                                                  r["structured_noun"].split("_", 1)[0]) for r in rows]),
                "transform_to_full_sent": (transform_to_full_sent, [
                    "--annotation", world["ek"], "--output", os.path.join(root, "full.csv")],
                    lambda rows: [transform_to_full_sent.PROMPT_TEMPLATE % r["narration"] for r in rows]),
            }
            for name, (cli, argv, prompts_of) in tools.items():
                tok = LlamaWordTokenizer()
                lm = TextLM._from_parts(module, tok)
                args = cli.parse_args(["--model", "-", "--batch_size", str(SENT_BATCH), "--max_new_tokens",
                                       str(SENT_NEW), *argv])
                prompts = prompts_of(_csv_rows(argv[1]))
                lengths = {len(tok(p)["input_ids"]) for p in prompts}
                assert len(lengths) == 1, f"{name}: prompts of lengths {lengths}"
                lm_calls.clear()
                rec.clear()
                reset_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rows = cli.run(args, lm)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = counters()
                one_token = sum(1 for s_len, _ in lm_calls if s_len == 1)
                want = dict.fromkeys(counters(), 0)
                want["decode_attention_stacked_bf16"] = n_layers * one_token
                print(f"[{tag}] phase 16 (d) {name}: {len(rows)} rows in batches of {SENT_BATCH} in {secs} s, "
                      f"launches {counts}, one-token forwards {one_token}, first row {rows[0]}")
                assert counts == want, (counts, want)
                assert one_token >= 1 and all(bool(ok) for _, ok in lm_calls), "no decode step, or non-finite logits"
                assert len(rows) == SENT_ROWS and all(r[("narration_text" if name == "generate_std_sent"
                                                        else "full_sent_narration")].endswith(".") for r in rows)
                batched, first = tok.decoded[0], rec[0]
                cosines, shares = [], []
                for r in range(SENT_BATCH):
                    rec.clear()
                    lm.generate([prompts[r]], newline_config(lm, args.max_new_tokens))
                    cosines.append(torch.nn.functional.cosine_similarity(first[r], rec[0][0], dim=0).item())
                    shares.append(compare_speculative(tag, f"phase 16 (d) {name} row {r} batched against alone",
                                                      batched[r:r + 1], tok.decoded[-1], list(rec)))
                print(f"[{tag}] phase 16 (d) {name}: each batched row's first-step logits against the prompt "
                      f"alone: cosines {cosines}; rows with identical tokens {sum(shares)}/{SENT_BATCH}")
                assert min(cosines) > 0.999, cosines
                prompt_len = lengths.pop()
                launches[f"decode_attention_stacked_bf16 at {name}"] = counts["decode_attention_stacked_bf16"]
                result[name] = {"prompt_tokens": prompt_len, "slots": prompt_len + SENT_NEW, "s": secs,
                                "one_token_forwards": one_token, "min_cosine": min(cosines),
                                "rows_identical_alone": sum(shares)}
    finally:
        handle.remove()
    phase16["sentences"] = result


def run_v1_chat(tag: str, dev, model, launches: dict, phase16: dict) -> None:
    """Phase 16 (e), on phase 4's bf16 model: the v1 chat
    (demo/video_blip_demo.VideoBlipChat) over the same weights as the v1
    class (a meta-device module given phase 4's tensors), the word
    tokenizer, CHAT_FRAMES frames (through set_video where the decoder
    builds, else set_frames). Two turns of sampling (temperature 0.7, top_p
    0.9, CHAT_NEW tokens), each counted (K1 = 39, K2 = 32, K3 = 32 a
    one-token forward) and equal to generate called directly with a
    generator seeded with the dialogue's length; then with top_k 1, each
    turn equal to greedy generate."""
    from eilev_tpu_torch.demo.video_blip_demo import VideoBlipChat, read_video
    from eilev_tpu_torch.generation import GenerationConfig, generate
    from eilev_tpu_torch.models.video_blip_v1 import VideoBlipV1ForConditionalGeneration
    from eilev_tpu_torch.native.decoder import decoder_available

    cfg = model.config
    v1 = VideoBlipV1ForConditionalGeneration(cfg, device="meta", dtype=torch.bfloat16)
    v1.load_state_dict(model.state_dict(), strict=True, assign=True)
    v1.eval()
    calls = lm_forward_log(v1)
    n_vit, n_lm, q = cfg.vision_config.num_hidden_layers, cfg.text_config.num_hidden_layers, cfg.num_query_tokens
    chat = VideoBlipChat(v1, WordTokenizer())
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        if decoder_available():
            path = os.path.join(root, "chat.y4m")
            write_y4m(path, 320, 240, DT_FPS, DT_SECONDS, DT_SEED + 2)
            route = "set_video (the native decoder)"
            chat.set_video(path)
            frames = read_video(path)
        else:
            route = "set_frames (seeded frames; no decoder on this host)"
            frames = np.random.default_rng(DT_SEED + 2).integers(0, 256, (3, CHAT_FRAMES, 240, 320), dtype=np.uint8)
            chat.set_frames(frames)
    assert frames.shape[1] == CHAT_FRAMES and tuple(chat.pixel.shape) == (1, 3, CHAT_FRAMES, 224, 224)
    turns = []
    greedy_chat = VideoBlipChat(v1, chat.tokenizer)
    greedy_chat.set_frames(frames)
    greedy_chat.generation_config = dataclasses.replace(chat.generation_config, top_k=1)
    for question in CHAT_QUESTIONS:
        calls.clear()
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reply = chat.respond(question)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = counters()
        one_token = sum(1 for s_len, _ in calls if s_len == 1)
        want = narration_counts(cfg, "decode_attention_stacked_bf16")
        want["decode_attention_stacked_bf16"] = n_lm * one_token
        assert counts == want, (counts, want)
        assert one_token >= 1 and all(bool(ok) for _, ok in calls), "no decode step, or non-finite logits"
        ids = torch.as_tensor(chat.tokenizer(" ".join(chat.dialogue[:-1]))["input_ids"], device=dev)[None]
        direct = generate(v1, input_ids=ids, pixel_values=chat.pixel, generation_config=chat.generation_config,
                          generator=torch.Generator(device=dev).manual_seed(len(chat.dialogue) - 1))
        same = bool(torch.equal(direct, chat.last_tokens))
        greedy_chat.respond(question)
        g_ids = torch.as_tensor(greedy_chat.tokenizer(" ".join(greedy_chat.dialogue[:-1]))["input_ids"],
                                device=dev)[None]
        rec: list = []
        handle = v1.language_model.register_forward_hook(lambda mod, args, out: rec.append(out[0][:, -1].float()))
        try:
            greedy = generate(v1, input_ids=g_ids, pixel_values=greedy_chat.pixel, generation_config=GenerationConfig(
                max_new_tokens=CHAT_NEW, pad_token_id=chat.tokenizer.pad_token_id))
        finally:
            handle.remove()
        turn = {"prompt_tokens": ids.shape[1], "k2_seq": q + ids.shape[1], "slots": q + ids.shape[1] + CHAT_NEW,
                "one_token_forwards": one_token, "s": secs, "launches": counts, "same_as_generate": same}
        print(f"[{tag}] phase 16 (e) v1 chat turn {len(turns) + 1} via {route}: {secs} s, launches {counts}, "
              f"prompt {ids.shape[1]} tokens (K2 over {turn['k2_seq']}), one-token forwards {one_token}, tokens "
              f"equal to generate with the generator seeded {len(chat.dialogue) - 1}: {same}; reply {reply[:80]!r}")
        assert same, turn
        # top_k 1 keeps every token tied at the top (bf16 logits tie), so a
        # turn may leave greedy's argmax at an exact tie
        turn["top_k_1_same_as_greedy"] = compare_speculative(
            tag, f"phase 16 (e) v1 chat turn {len(turns) + 1} sampled with top_k 1 against greedy generate",
            greedy_chat.last_tokens, greedy, rec)
        turns.append(turn)
    for i, turn in enumerate(turns, 1):
        launches[f"packed_qkv_causal_attention at v1 chat turn {i}"] = turn["launches"]["packed_qkv_causal_attention"]
        launches[f"decode_attention_stacked_bf16 at v1 chat turn {i}"] = \
            turn["launches"]["decode_attention_stacked_bf16"]
    launches["packed_qkv_attention at v1 chat"] = sum(t["launches"]["packed_qkv_attention"] for t in turns)
    phase16["chat"] = {"route": route, "turns": [{k: v for k, v in t.items() if k != "launches"} for t in turns]}
    del v1, chat, greedy_chat
    gc.collect()
    torch.cuda.empty_cache()


def check_data_tools_shapes(tag: str, dev, phase16: dict) -> list:
    """Phase 16 (f): the kernels at the shapes (d) and (e) ran, against
    their twins at 2e-2 and timed beside SDPA with the same mask and their
    bound: K1 at the chat's (CHAT_FRAMES, 257, 16 x 88); K2
    at each chat turn's prefill (1, 32 + prompt, 32 x 80), causal; K3 over
    each chat turn's cache (the 32 layers, 1 row, prompt + 32 + CHAT_NEW
    slots, half the new tokens in, 32 x 80; the split body) and over each
    sentence tool's (LLAMA_LAYERS layers, SENT_BATCH rows, prompt +
    SENT_NEW slots, 32 x 128, score-side scale; one block a (head, row)),
    the latter also with every other row left-padded by 7 slots."""
    from eilev_tpu_torch.ops import decode_attention as da
    from eilev_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device=dev).manual_seed(DT_SEED)
    rows = []
    b, s, nh, hd = CHAT_FRAMES, 257, 16, 88
    qkv = torch.randn(b, s, 3 * nh * hd, device=dev, generator=g).to(torch.bfloat16)
    q, k, v = qkv.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
    err = check_close(tag, f"phase 16 (f) K1 packed_qkv_attention ({b},{s},{nh}x{hd})",
                      fa.packed_qkv_attention(qkv, nh, hd), fa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5),
                      2e-2)
    rows.append({"name": "packed_qkv_attention at v1 chat", "shape": [b, s, nh, hd],
                 "source": "eilev_tpu_torch/csrc/packed_attention.cu",
                 "replaces": "eilev_tpu/ops/fused_attention.py:81",
                 "max_abs_err": err, "per_call": 1,
                 "run": lambda qkv=qkv, nh=nh, hd=hd: fa.packed_qkv_attention(qkv, nh, hd),
                 "plain": lambda qkv=qkv, nh=nh, hd=hd: fa.packed_qkv_attention_reference(qkv, nh, hd, hd**-0.5),
                 "library": lambda q=q, k=k, v=v, hd=hd: _sdpa(q, k, v, scale=hd**-0.5),
                 "bound": bound(4 * b * nh * s * s * hd, 4 * b * s * nh * hd * 2)})
    for i, turn in enumerate(phase16["chat"]["turns"], 1):
        s, nh, hd = turn["k2_seq"], 32, 80
        qkv = torch.randn(1, s, 3 * nh * hd, device=dev, generator=g).to(torch.bfloat16)
        ones = torch.ones(1, s, dtype=torch.int32, device=dev)
        q, k, v = qkv.view(1, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        err = check_close(tag, f"phase 16 (f) K2 packed_qkv_causal_attention (1,{s},{nh}x{hd}) chat turn {i}",
                          fa.packed_qkv_causal_attention(qkv, nh, hd, ones),
                          fa.packed_qkv_causal_attention_reference(qkv, nh, hd, ones, hd**-0.5), 2e-2)
        rows.append({"name": f"packed_qkv_causal_attention at v1 chat turn {i}", "shape": [1, s, nh, hd],
                     "source": "eilev_tpu_torch/csrc/packed_attention.cu",
                     "replaces": "eilev_tpu/ops/fused_attention.py:187", "max_abs_err": err, "per_call": 1,
                     "run": lambda qkv=qkv, ones=ones, nh=nh, hd=hd: fa.packed_qkv_causal_attention(qkv, nh, hd, ones),
                     "plain": lambda qkv=qkv, ones=ones, nh=nh, hd=hd: fa.packed_qkv_causal_attention_reference(
                         qkv, nh, hd, ones, hd**-0.5),
                     "library": lambda q=q, k=k, v=v, hd=hd: _sdpa(q, k, v, is_causal=True, scale=hd**-0.5),
                     "bound": bound(4 * nh * hd * s * (s + 1) // 2, 4 * s * nh * hd * 2 + s * 4)})
    decode = [(f"v1 chat turn {i}", (32, 1, t["slots"], t["slots"] - CHAT_NEW // 2, 32, 80, True), False)
              for i, t in enumerate(phase16["chat"]["turns"], 1)]
    decode += [(name, (LLAMA_LAYERS, SENT_BATCH, t["slots"], t["slots"] - SENT_NEW // 2, 32, 128, False), True)
               for name, t in phase16["sentences"].items()]
    for name, dims, left_pad in decode:
        c = _decode_case(dev, g, da, dims)
        n_layers, b, s, filled, nh, hd = c.dims
        body = (f"the split, a cluster of {da.cluster_size(b, nh, s)}" if da.k3_split(b, nh, s)
                else "one block a (head, row)")
        print(f"[{tag}] phase 16 (f) K3 bf16 at {name}: the body rule k3_split(B={b}, H={nh}, S={s}) picks {body}")
        masks = [("mid-decode", c.mask)]
        if left_pad:
            padded = c.mask.clone()
            padded[::2, :7] = 0
            masks.append(("mid-decode, every other row left-padded by 7", padded))
        errs = [check_close(tag, f"phase 16 (f) K3 decode_attention_stacked bf16 at {name} ({n_layers},{b},{s} "
                                 f"with {filled} filled,{nh}x{hd}) layer {n_layers - 1} {label} mask",
                            da.decode_attention_stacked(c.q, c.kb, c.vb, mask, n_layers - 1, **c.kw),
                            da.decode_attention_stacked_reference(c.q, c.kb, c.vb, mask, n_layers - 1, **c.kw), 2e-2)
                for label, mask in masks]
        sd_q = c.q.view(b, nh, 1, hd)
        sd_mask = c.mask.bool()[:, None, None, :]
        scale = hd**-0.5
        rows.append({"name": f"decode_attention_stacked_bf16 at {name}", "shape": list(dims[:-1]),
                     "source": "eilev_tpu_torch/csrc/decode_attention.cu",
                     "replaces": "eilev_tpu/ops/decode_attention.py:117", "max_abs_err": max(errs),
                     "run": _k3_step(da, c), "plain": _k3_step(da, c, plain=True), "per_call": n_layers,
                     "library": lambda c=c, sd_q=sd_q, sd_mask=sd_mask, scale=scale: [
                         _sdpa(sd_q, c.k5[i].transpose(1, 2), c.v5[i].transpose(1, 2), attn_mask=sd_mask, scale=scale)
                         for i in range(c.dims[0])],
                     "bound": _decode_bound(c, int8=False)})
    for r in rows:
        time_row(tag, r)
    return rows


def run_data_tools(tag: str, dev, phase16: dict) -> tuple[dict, list]:
    """Phase 16 (a)-(c) in a temporary directory inside the repository's
    checkout (deleted after), then (f). Returns the phase's numbers and
    (f)'s rows."""
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as root:
        w = dt_world(root)
        ego4d = dt_extract_ego4d(tag, dev, w)
        t = _phase16_took(tag, "(a)", t)
        phase16["ego4d"] = ego4d
        phase16["epic_kitchens"] = dt_extract_epic_kitchens(tag, dev, w, ego4d["decoder_available"])
        t = _phase16_took(tag, "(b)", t)
        phase16["split_and_annotation"] = dt_split_and_annotate(tag, w)
        t = _phase16_took(tag, "(c)", t)
    rows = check_data_tools_shapes(tag, dev, phase16)
    _phase16_took(tag, "(f)", t)
    return phase16, rows


def _phase16_took(tag: str, part: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[{tag}] phase 16 {part} took {now - t0} s")
    return now


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda", 0)
    # the fp32 bodies are held to fp32 twins: no TF32 in the twins' products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card_tag()
    print(tag)  # nvidia-smi --query-gpu=name,power.limit, as it prints it
    print(f"[{tag}] torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    if argv:
        if len(argv) != 2 or argv[0] != "--kernel-times":
            raise SystemExit("usage: chip_smoke.py [--kernel-times DIR]")
        tree = os.path.abspath(argv[1])
        sys.path.insert(0, tree)  # its eilev_tpu_torch, built into its own build/
        try:
            build_kernels(tag, ("packed_attention", "decode_attention", "flash_attention", "attention_f32",
                                "fused_mlp"))
            kernel_times(tag, dev, tree)
        except Exception:
            traceback.print_exc()
            return 1
        return 0
    t_script = time.perf_counter()

    def took(phase: str, t0: float) -> float:
        now = time.perf_counter()
        print(f"[{tag}] {phase} took {now - t0} s (script at {now - t_script} s)")
        return now

    try:
        # the build runs in the background (nvcc outside the GIL); the decode,
        # flash and fp32 attention libraries are ready well before K1/K2's,
        # so phases 2c-2e, which need only those, run meanwhile (a library's
        # first use waits on its build's lock)
        with ThreadPoolExecutor(max_workers=1) as pool:
            building = pool.submit(build_kernels, tag)
            beam_rows = check_beam_decode(tag, dev)
            mode_rows = check_decoding_mode_shapes(tag, dev)
            t5_rows = check_t5_shapes(tag, dev)
            building.result()
        t = took("build and phases 2c-2e", t_script)
        kernels = check_kernels(tag, dev)
        t = took("kernel checks and timings (phases 2, 2b, 3)", t)
        launches: dict = {}
        model, lm_calls, runs = run_main_path(tag, dev, launches)
        run_k6_on_vit_layers(tag, model, runs[1], launches)
        t = took("main path and K6 on the ViT layers", t)
        t0 = time.perf_counter()
        run_icl(tag, dev, model, runs[4])
        run_icl_evaluator_f32(tag, dev)
        print(f"[{tag}] ICL classify phase took {time.perf_counter() - t0} s")
        t0 = time.perf_counter()
        run_generation(tag, model, lm_calls, runs, launches)
        print(f"[{tag}] generation phase took {time.perf_counter() - t0} s")
        t0 = time.perf_counter()
        run_decoding_modes(tag, model, lm_calls, runs, launches)
        print(f"[{tag}] decoding modes phase took {time.perf_counter() - t0} s")
        phase16: dict = {}
        t0 = time.perf_counter()
        run_v1_chat(tag, dev, model, launches, phase16)
        _phase16_took(tag, "(e)", t0)
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        run_int8_serving(tag, model, lm_calls, runs, launches)
        t = took("int8 serving", t)
        del model, lm_calls, runs  # free the VideoBLIP model before the 13.5 GB LLaMA
        gc.collect()
        torch.cuda.empty_cache()
        run_llama(tag, dev, launches, phase16)
        t = took("LLaMA", t)
        gc.collect()
        torch.cuda.empty_cache()
        run_f32_paths(tag, dev, launches)
        took("fp32 paths", t)
        gc.collect()
        torch.cuda.empty_cache()
        t5 = run_t5(tag, dev, launches)
        # K5's T5 bodies on the kernels line, with their launches in 8b's
        # flash runs: the Hopper body with the bias tiles, the decode body
        kernels = kernels + [r for r in t5_rows if r["name"] in K5_T5_LINE_ROWS]
        gc.collect()
        torch.cuda.empty_cache()
        training, parallel = run_training(tag, dev)
        gc.collect()
        torch.cuda.empty_cache()
        run_checkpoints(tag, dev)
        gc.collect()
        torch.cuda.empty_cache()
        serving = run_serving(tag, dev)
        gc.collect()
        torch.cuda.empty_cache()
        videomae_rows, evaluation = run_eval_baselines(tag, dev, launches)
        kernels = kernels + videomae_rows
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        data_tools, data_rows = run_data_tools(tag, dev, phase16)
        t = took("phase 16 (a)-(c) and (f)", t)
        with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tp_root:
            tp_rows, tensor_parallel, tps_rows, tp_serving = run_tensor_parallel(tag, dev, tp_root)
        gc.collect()
        torch.cuda.empty_cache()
        tp_training = run_tensor_parallel_training(tag, dev)
        took("the whole script", t_script)
    except Exception:
        traceback.print_exc()
        return 1
    line = {"kernels": [
        {"name": k["name"], "route": "cuda", "source": k["source"], "replaces": k["replaces"],
         "launches": launches[k["name"]], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "serving_launches": serving["launches"].get(k["name"], 0),
         **({"composite": k["composite"], "composite_ms": k["composite_ms"]} if "composite_ms" in k else {}),
         **({"body": k["body"]} if "body" in k else {})}
        for k in kernels
    ]}
    assert all(k["launches"] > 0 for k in line["kernels"]), line
    # the beam shapes' rows, with their launches in the beam runs (K4 at 20
    # rows: check only, no phase runs int8 beam-5 at batch 4)
    print(json.dumps({"beam_decode_shapes": [
        dict(r, route="cuda", launches=launches.get(r["name"], 0)) for r in beam_rows]}))
    print(json.dumps({"training": training}))
    # phase 9 (f): pipeline and data-parallel training
    print(json.dumps({"parallel": parallel}))
    # the decoding modes' new shapes, with their launches in the mode runs
    # (K3 over the target's speculative cache: none, its verify pass is
    # plain attention)
    print(json.dumps({"decoding_mode_shapes": [
        dict(r, route="cuda", launches=launches.get(r["name"], 0)) for r in mode_rows]}))
    # K5's T5 forms, with their launches in the T5 phase's flash runs (fp32:
    # the cut's encoder at batch 1; its decoder steps run at other lengths)
    print(json.dumps({"t5_shapes": [
        dict(r, route="cuda", launches=launches.get(r["name"], 0)) for r in t5_rows]}))
    print(json.dumps({"t5": dict(t5, k1_launches=launches["packed_qkv_attention at the T5 path"],
                                 k5_f32_launches=launches["flash_attention_f32 at the T5 path"])}))
    # phase 11: the serving legs' numbers, K2/K3/K4/K5 at the serving shapes
    # (their rows without the timing closures) and the phase's launches
    print(json.dumps({"serving": serving}, default=str))
    # phase 12: VideoMAE and the encoders (K5's VideoMAE rows are on the
    # kernels line, with their launches in the flash predicts)
    print(json.dumps({"eval_baselines": evaluation}, default=str))
    # phase 13: tensor parallelism; the kernels at the local-head shapes with
    # their launches in its runs (K3/K4 at batch 4: check only, the runs are
    # at batch 1)
    print(json.dumps({"tensor_parallel": tensor_parallel, "tensor_parallel_shapes": tp_rows}, default=str))
    # phase 14: tensor-parallel training (K1 at phase 13's local-head row, its
    # launches a rank in the counted step)
    print(json.dumps({"tensor_parallel_training": tp_training}, default=str))
    # phase 15: tensor-parallel serving and the int8 weight modes under it;
    # the kernels at its shapes with their launches a rank in (a) and (b)
    print(json.dumps({"tensor_parallel_serving": tp_serving, "tensor_parallel_serving_shapes": tps_rows},
                     default=str))
    # phase 16: the data tools, the sentence tools and the v1 chat; the
    # kernels at their shapes with their launches in (d) and (e)
    print(json.dumps({"data_tools": data_tools}, default=str))
    print(json.dumps({"data_tools_shapes": [dict(r, route="cuda", launches=launches.get(r["name"], 0))
                                            for r in data_rows]}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
