"""Drive the PyTorch port's serving, training and evaluation paths on one CUDA card and check them.

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --only 3e,3f    # phases 1 and 2, then the kernel phases named
    python3 chip_smoke.py --only 6s       # phases 1 and 2, then streaming ms per hop
    python3 chip_smoke.py --only 11       # phases 1 and 2, then musdb18 serving
    python3 chip_smoke.py --only 3h       # phases 1 and 2, then the cluster routes
    python3 chip_smoke.py --only 3i       # phases 1 and 2, then the wide route (H = 256)
    python3 chip_smoke.py --only 3j,13    # the wide backward, then DPTNet (its training)
    python3 chip_smoke.py --only 3d,3h,12 # the cluster backward, then musdb18 training
    python3 chip_smoke.py --only 12       # phases 1 and 2, then musdb18 training
    python3 chip_smoke.py --only 13       # phases 1 and 2, then DPTNet (13k: its kernels)
    python3 chip_smoke.py --only 14       # LSTM-TasNet, SepFormer and GALRNet, their kernels first
    python3 chip_smoke.py --only 15       # RNN / SRU, FurcaNet, musdb18's waveform models
    python3 chip_smoke.py --only 16       # Wavesplit, DANet, ADANet, deep clustering (16k first)
    python3 chip_smoke.py --only 17       # D3Net, MMDenseNet, MMDenseLSTM, HRNet, CUNet (17k first)
    python3 chip_smoke.py --only 18       # ORPIT Conv-TasNet, the other PITs, oracle masks, library
    python3 chip_smoke.py --only 19       # the hub's reference checkpoints; slice E's other half

Phases (any failure exits non-zero; nothing is caught and passed):
  1. device: require CUDA, print the card's name and power limit, turn TF32 off;
  2. build: compile csrc/mask_decode.cu, csrc/lstm_scan.cu, csrc/lstm_scan_bwd.cu,
     csrc/gru_scan.cu, csrc/gru_scan_bwd.cu and csrc/quantize.cu with nvcc for
     sm_90a, all at once, and require 0 bytes of stack in every kernel;
  3. kernel vs plain: fused_mask_decode against its plain PyTorch version on
     the card, f32 and bf16, at the Conv-TasNet serving shape, the DPRNN-TasNet
     decoder shape (and at a ragged T'), the LSTM-TasNet decoder shape (N=500,
     C·L=40), a streamed Conv-TasNet hop (B=1, T'=50) and others (N=61,
     C·L=80, S = 1 and 3, both "mma" tile counts,
     narrow and ragged N), contiguous and strided. Each case runs on the path
     _plan gives it ("rows", "mma" or "generic"; PATH_LAUNCHES must grow on
     that path) and, where that is "rows" or "mma", on the generic kernel too.
     At the three decoder shapes and the hop one whole wrapper call and the kernel alone
     (a CUDA graph of 10 launches a timing) are timed with CUDA events, the new path and the
     generic kernel in turns (generic, new, new, generic), beside the plain
     version, its bound and, in f32, einsum (the same function);
  3b. lstm_scan_bidir and lstm_scan against their plain versions, f32 and
     bf16, at the intra- and inter-chunk serving shapes (timed), an odd small
     shape, B=37 and T=19 at H=128 (rows past the tile), T=1, H=64, a streamed
     hop's three chunks (timed), and H=256 and 512. Each launch must take the path
     _plan gives: for H a multiple of 16 up to 128 the tensor cores, "mma" in
     bf16 and "tf32x3" (3xTF32, clusters of 2 or 4 blocks) in f32, the FMA kernel
     otherwise. Where a tensor-core kernel runs, it is launched ten more
     times, each output held to the limit, and the FMA kernel is forced too
     and held to the plain version; at the timed shapes it is timed between
     two timings of the tensor-core kernel;
  3c. gru_scan_bidir and gru_scan the same way;
  3d. the training forward (cs written; the tensor-core paths) and the
     backward kernels of lstm_scan_bidir and lstm_scan under autograd against
     the plain forward and lstm_scan_bwd_reference, f32 and bf16, at the recipe
     training shapes (B = 2 x 4 s, timed), an odd shape, T=1, H=256 (B = 64,
     T = 33) and musdb18 training's (B = 16, T = 259, H = 256: the forward and the
     backward on "cluster"). Each backward launch must take the path _plan_bwd
     gives: for H a multiple of 16 up to 128 the split-TF32 tensor cores
     ("tf32x3" in f32, "tf32x2" in bf16; clusters of 2 or 4 blocks), for the
     LSTM at H = 256 and few sequences the cluster backward
     (csrc/recurrence_cluster_bwd.cuh, 8-block clusters), the FMA kernel
     otherwise. Where another kernel than FMA runs, ten more launches are
     checked and the FMA kernel is forced and checked too; at the training
     shapes the whole backward and the kernel alone are timed, FMA and the new
     kernel in turns (FMA, new, new, FMA); at musdb18 training's shape (f32,
     two chains) from CUDA graphs, beside cuDNN's nn.LSTM backward (F = 512);
     fused_mask_decode must refuse CUDA tensors that require grad;
  3e. the backward kernels of gru_scan_bidir and gru_scan under autograd
     against gru_scan_bwd_reference the same way;
  3f. quantize_int8 against its plain version, bit for bit, on every weight
     tensor of paper-config Conv-TasNet that quantize_state_dict quantizes
     (those JAX's quantize_params quantizes) and on a (4096, 4096) tensor
     (timed); stochastic rounding: every value the floor or the ceiling, and
     unbiased over 64 seeds;
  3g. the library calls beside the recurrence kernels (informational):
     cuDNN's nn.LSTM / nn.GRU forward and backward, f32 and bf16, at the
     kernels' timed shapes, input projection included (nn.LSTM at musdb18's
     shapes is timed in 3d and 3h); torch.einsum on bf16 operands at
     fused_mask_decode's timed shapes (a bf16 output); the port never calls them;
  3h. the cluster route of lstm_scan_bidir and lstm_scan (csrc/recurrence_cluster.cuh)
     against the plain versions, f32 and bf16, on every cluster size the card
     holds (8 and 16 blocks at H = 256, 16 above): at UMX's serving shapes (B = 1,
     T = 431; H = 256 on two chains, 512 on one), at musdb18 training's (B = 16,
     T = 259, H = 256, two chains; timed with cs), at B = 3, H = 384 and T = 1;
     hs alone and with cs, each launch repeated and checked; the plan must take
     "cluster" at UMX's shapes. At those shapes it is timed from CUDA graphs,
     the FMA kernel forced in the same run (FMA, cluster, cluster, FMA), beside
     the other cluster size, the serial floor (the kernel with its product
     compiled out), the plain version, cuDNN's nn.LSTM (median of 50) and the
     bound; then against the FMA kernel over B (the crossover the plan encodes).
     The cluster backward (csrc/recurrence_cluster_bwd.cuh) the same way: at
     every case against lstm_scan_bwd_reference, f32 and bf16, on every
     cluster size, each launch repeated and checked, the plan taking it; at
     musdb18 training's shape both cluster sizes and its serial floor timed
     from CUDA graphs; then against the FMA backward over B = 1-512 (H = 256 on
     two chains, 512 on one, T = 259), the crossover CLUSTER_MAX_BATCH_BWD
     encodes. The plan must take "cluster" at UMX's serving shapes (B = 1) and, at
     musdb18 training's, the route WIDE_MIN_BATCH gives B = 16;
  3i. the wide route of lstm_scan_bidir and lstm_scan (csrc/recurrence_wide.cuh, H = 256)
     against the plain versions, f32 (3xTF32) and bf16 (mma.sync): every tile (M, C)
     of each dtype the card holds at B = 37 (rows past B), one and two chains, hs alone
     and with cs, each launch repeated and checked; T = 1 through the public wrappers.
     At musdb18 training's shape (DPTNet's are phase 13k's) it is timed from
     CUDA graphs, the FMA kernel forced in the same run (FMA, wide, wide, FMA), beside
     the cluster route forced, the plain version, cuDNN's nn.LSTM (F = 64)
     and the bound; then against the cluster route over B = 4-512, T = 259 and 639,
     one and two chains, both dtypes (the crossover WIDE_MIN_BATCH encodes);
  3j. the wide route of the LSTM backward (csrc/recurrence_wide_bwd.cuh, H = 256)
     against lstm_scan_bwd_reference, f32 (three TF32 products) and bf16 (two): every
     tile (M, C) of each dtype the card holds at B = 37 (rows past B), one and two chains,
     each launch repeated and checked; T = 1 under autograd through the public wrappers
     (the FMA backward forced and checked beside it). At DPTNet's recipe training shapes
     (1278 x 100 and 200 x 639 on two chains, 200 x 639 on one, f32; 1278 x 100 in bf16)
     the whole backward and the kernel alone timed from CUDA graphs in turns with the FMA
     backward (FMA, wide, wide, FMA), beside the cluster backward forced, every tile the
     card holds, the serial floor (the product compiled out), the plain version, cuDNN's
     nn.LSTM backward (F = 64) and the bounds; then against the cluster backward over
     B = 4-256, T = 259 and 639, one and two chains, both dtypes (the crossover
     WIDE_MIN_BATCH_BWD encodes);
  4. serve: paper-config Conv-TasNet (random weights from seed 0) through
     cli/separate.py on three mixtures in float32 and bfloat16, counting the
     kernel's launches;
  4b. serve: recipe-config DPRNN-TasNet, non-causal and causal (random weights
     from seed 0), the same way; each request must launch the LSTM kernels and
     the decode kernel;
  4c. serve: the same with rnn_type='gru'; each request must launch the GRU
     kernels and the decode kernel, and no LSTM kernel;
  4d. stream: the stream-safe causal DPRNN-TasNet, LSTM and GRU, through
     cli/separate.py --streaming_hop 0.05; each request must launch exactly
     what its separator calls imply, and the f32 streamed output must match
     the offline stream-safe forward on the card;
  4f. stream: causal paper-config Conv-TasNet through cli/separate.py
     --streaming_hop 0.05; each request must launch fused_mask_decode exactly
     once per separator call and nothing else, and the f32 streamed output
     must match the offline causal forward on the card;
  4g. long-form: a 30 s mixture through cli/separate.py --chunk_duration 4
     with paper-config Conv-TasNet; each request must launch fused_mask_decode
     once per chunk, 14 real chunks bucketed to 16, and nothing else;
  4e. quantized weights: paper-config Conv-TasNet's weights quantized to int8
     on the card (one quantize_int8 launch per weight tensor, 99), dequantized,
     loaded and served through cli/separate.py; the SNR against the
     unquantized output is informational;
  5. card vs CPU: the f32 card output against the CPU (plain) output, and the
     bf16 card output against the f32 card output, for every served model,
     streamed ones included;
  6. throughput (informational): B=8 x 4 s bf16 forward (DPRNN-TasNet in f32
     too), and CLI latency, for each offline model; ms per 0.05 s hop, its
     real-time factor and the CLI latency for the streamed ones; long-form wall
     time per audio-second; `python -m dnn_based_source_separation_torch.bench`
     by default and with --streaming_hop 0.05 --causal, its JSON lines printed;
  7. one train step, card vs CPU: recipe-config DPRNN-TasNet (LSTM and GRU,
     non-causal and causal) and paper-config Conv-TasNet, same seed-made
     weights and batch (B = 1 x 0.125 s), f32: the loss and every gradient, none
     all zero on the card, and the kernel launches of the step;
  8. train through cli/train_wsj0mix.py on a synthetic wsj0-style corpus (three
     training and one validation utterance):
     `python -m` for two epochs (its first line must say TF32 is off: utils/device.py),
     then in-process --continue_from, causal,
     --mixed_precision 1, --rnn_type gru (f32, bf16, causal f32 and bf16) and Conv-TasNet
     runs, with the launches of every run checked against its steps and
     validation forwards; one step and one validation forward counted alone;
     a fixed batch must lower its loss over 6 steps; the trained checkpoints
     serve through cli/separate.py;
  9. training throughput (informational): p50 step time and audio-s/s, and a
     torch.profiler split of one DPRNN-TasNet step, LSTM and GRU, then of its
     backward alone: the backward launches by path (each on the tensor cores)
     and the ten longest device ops of the rest of the backward;
  10. evaluate the checkpoints phase 8 trained (Conv-TasNet, LSTM and GRU
     DPRNN-TasNet) through cli/test_wsj0mix.py --device cuda on a synthetic
     test list of uneven lengths, one utterance per call: exact launches per
     utterance, every metric within 0.05 dB of the same CLI with --device cpu,
     and the wall time per utterance split into forward and BSS-Eval;
  11. musdb18 serving: paper-config ParallelOpenUnmix and bridged X-UMX (seed-0
     weights, scrambled BatchNorm statistics and affines) in their
     SpectrogramMaskingWrapper, through cli/test_musdb18.py --device cuda on a
     synthetic musdb-layout corpus of one 20 s stereo track (two 10 s chunks
     each, S = 431 frames): exactly 12 lstm_scan_bidir launches a chunk per
     model, all on the route _plan gives B = 1 at H = 256 ("cluster"), and no other
     kernel; the same CLI
     with --device cpu (both models side by side in threads): the card's stems
     within 1e-3 x max|CPU|, every median SDR / ISR / SIR / SAR within 0.05 dB;
     the Wiener EM alone card vs CPU within 1e-3 relative, with its time and
     peak memory; per-chunk forward, Wiener and iSTFT ms, audio-s/s; causal
     UMX (12 lstm_scan launches, H = 512, all on "cluster") over one
     chunk card vs CPU; the bench's `--model umx` and `--model xumx` lines;
  12. musdb18 training at the recipe widths (the train CLI's defaults: n_fft 4096,
     hop 1024, max_bin 1487, hidden 512, 3 layers, four stems, Adam at 1e-3): one UMX
     and one X-UMX step (dropout 0, B = 1 x 6 s) card vs an f64 CPU step, as phase 7;
     cli/train_musdb18.py --device cuda for each model on a synthetic musdb-layout
     corpus, two epochs of 4 steps at B = 16 x 6 s with dropout 0.4 (the epoch's
     train loss must fall), its last.ckpt served through cli/test_musdb18.py; every
     step exactly 12 lstm_scan_bidir and 12 backwards, every validation and serving
     forward 12 lstm_scan_bidir, each on the route _plan (_plan_bwd) gives its batch
     (B = 16: the backward on "cluster"; B = 1: "cluster"), and nothing else; then the recipe
     step timed (p50 of forward / backward / optimizer by CUDA events, audio-s/s, peak
     allocation) and profiled (device time by kernel, idle share);
  13. DPTNet on wsj0-2mix at the recipe widths (N64 L2 K100, 6 blocks, 4 heads, bottleneck
     64, H = 256, relu masks; seed-0 weights): served through cli/separate.py in f32 and
     bf16, non-causal and causal, on the three mixtures, each request launching exactly its
     LSTM kernels on the routes _plan gives its shapes (B = 1: the intra-chunk biLSTM over S
     chunks and the inter-chunk LSTM over 100 sequences, "cluster" below WIDE_MIN_BATCH,
     else "wide"), 12 lstm_scan_bidir (non-causal) or 6 and 6 lstm_scan (causal), and one
     fused_mask_decode; card vs CPU and bf16 vs f32 as phase 5; the B = 8 x 4 s forward in
     both dtypes (ms, every launch on its route: "wide" at 5112 and 800 sequences), one
     profiled forward split into the recurrence kernels, the attention (CUDA events around
     each MultiheadAttention call) and the rest, with the idle share; one train step (2
     blocks, B = 1 x 0.25 s, causal or not) card vs an f64 CPU step, as phase 7, its
     launches joining the main path's (the causal step trains the one-chain backward);
     cli/train_wsj0mix.py --model dptnet --warmup_steps 20 at B = 2 x 4 s for two epochs
     of 5 steps (every step and validation forward on its routes, the epoch train loss
     falling), its checkpoint served
     and evaluated (cli/test_wsj0mix.py card vs CPU within 0.05 dB), the recipe step's p50
     split and a profile with its idle share; `bench --model dptnet` in bf16 and f32; and
     (13k) every LSTM kernel at DPTNet's shapes against its plain version, timed from CUDA
     graphs beside the FMA kernel where another route runs, cuDNN's nn.LSTM (F = 64) and
     the bound: the forwards at (5112, 100), (800, 639) and causal (800, 639) in both
     dtypes; at recipe training's (1278, 100), (200, 639) and causal (200, 639) with cs, and
     their backwards (on "wide"), in f32;
  14. LSTM-TasNet, SepFormer and GALRNet on wsj0-2mix at the recipe configs (bench.py's
     LSTM_TASNET, SEPFORMER, GALRNET; seed-0 weights, scrambled norm affines): served through
     cli/separate.py in f32 and bf16, non-causal and causal, on the three mixtures, each
     request held launch by launch to its routes (LSTM-TasNet: 4 lstm_scan_bidir or 4
     lstm_scan on "cluster" at H = 500 padded to 512, each counted in PADDED_LAUNCHES, one
     "generic" decode; GALRNet: 6 lstm_scan_bidir on the
     tensor cores, one decode, "mma" in bf16 and "generic" in f32; SepFormer: one decode and
     no recurrence); card vs CPU and bf16 vs f32 as phase 5; causal LSTM-TasNet with the
     trainable encoder streamed through --streaming_hop 0.05 (one "generic" decode a
     separator call), streamed vs offline within 1e-4 x max|offline|, ms a hop; the B = 8 x 4
     s forward of each in both dtypes, every launch on its route, profiled into recurrences,
     attention (CUDA events around each MultiheadAttention call), decode and the rest, with
     the idle share; one train step a model (B = 1 x 1 s, the recipe widths at a small
     depth; LSTM-TasNet causal too) card vs an f64 CPU step, as phase 7;
     cli/train_wsj0mix.py at each recipe's flags, B = 4 x 4 s, two epochs of 5 steps
     (every step and validation forward on its routes, the epoch train loss falling), its
     checkpoint served and evaluated (cli/test_wsj0mix.py card vs CPU within 0.05 dB), the
     recipe step's p50 split with the peak allocation and a profile with its idle share;
     `bench --model lstm-tasnet|sepformer|galrnet` in bf16 and f32; and (14k) the LSTM kernels
     at the new shapes against their plain versions, beside cuDNN's nn.LSTM and the bound:
     LSTM-TasNet's (8, 1599, 500) serving forwards, one chain and two, and (4, 1599, 500)
     training forwards with cs and their backwards, in both dtypes (on "cluster" at the
     padded H = 512, held to the unpadded plain version and to the FMA kernel forced beside
     them, timed whole with the pads and as the kernel alone, the 16-block cluster counts and
     waves printed); GALRNet's
     (632, 100, 128) serving and (316, 100, 128) training forwards and backwards (the tensor
     cores, the FMA kernel forced beside them); fused_mask_decode at the three decoder
     widths (N = 500, C·L = 40; N = 256 and 64, C·L = 16) as one whole call and as the
     kernel alone, beside the generic kernel, the plain version and einsum;
  15. the rest of the wsj0-mix zoo and musdb18's waveform models at their recipe widths
     (seed-0 weights, scrambled norm affines): recipe-config DPRNN-TasNet with rnn_type
     "rnn" and "sru" (plain PyTorch recurrences: only the decode kernel) and FurcaNet
     (egs/wsj0-mix/furcanet/train.sh: six biLSTM layers at H = 128 over every sample, no
     decode) served through cli/separate.py in f32 and bf16, each request held to its
     routes, card vs CPU and bf16 vs f32 as phase 5; stereo Conv-TasNet, MRX and Meta-TasNet
     (egs/musdb18/{conv-tasnet,mrx,meta-tasnet}/train.sh, built by cli/train_musdb18.py)
     and WaveNet, one forward card vs CPU each, held to its routes (MRX: nine lstm_scan_bidir
     on "cluster"; the two TasNets one "generic" decode, C·L = 40 and 20); one train step
     of each CLI model card vs an f64 CPU step, as phase 7 (a small depth, the widths
     kept); cli/train_wsj0mix.py --model furcanet and --rnn_type sru, and
     cli/train_musdb18.py --model conv-tasnet|mrx|meta-tasnet, two epochs each on synthetic
     corpora, every step and validation forward on its routes, the epoch train loss
     falling, the checkpoints served or reopened; the musdb18 recipe step at the recipe
     batch or, where that runs out of device memory, the largest power-of-two batch that
     fits (p50, split, peak, said on its line; the CLI then trains at that batch); the B =
     8 x 4 s forward of the wsj0-mix models in both dtypes (forward_profile) and their
     recipe steps' p50 and peak; and (15k) the LSTM kernels at FurcaNet's (4, 16000) x 2
     training (with cs, and its backward) and (8, 32000) x 2 serving shapes (f32 and bf16)
     at H = 128, every tf32x3 tile the card holds beside the planned one, and at MRX's
     (1, 1724) x 2 serving and (16, 1035) x 2 training shapes at H = 256 (with cs, and its
     backward), each against its plain version at the full length (the serving shape's
     over its first 4000 steps: the same computation), beside the FMA kernel
     forced, cuDNN's nn.LSTM and the bound; fused_mask_decode at stereo Conv-TasNet's and
     Meta-TasNet's decoder widths (B = 1 x 10 s, f32) beside the plain version and einsum.
  16. Wavesplit and the embedding / attractor family at their recipes' widths (seed-0
     weights; egs/wsj0-mix/{wavesplit,danet,adanet,deep-clustering}/train.sh): Wavesplit
     (D 512, 14 speaker layers, 4 x 10 separation layers; no kernel of the port: every count
     0) B = 8 x 4 s forward in f32 and bf16 on the oracle and the KMeans paths (ms, peak, a
     profile of each dtype's oracle forward), bf16 vs f32 (oracle SNR >= 25 dB), card vs
     CPU at B = 1 x 1 s on both paths (the CPU run's initial centroids replayed on the card),
     a train step against an f64 step at a small depth, the recipe step at B = 4 x 4 s or
     the largest power-of-two batch that fits (p50, split, peak, said on its line), and
     cli/train_wsj0mix_wavesplit.py two epochs on wsj0-style IDs (B = 2 x 1 s, the epoch
     train loss falling); DANet, ADANet and deep clustering (H = 300 biLSTMs, 4, 4 and 2
     layers) serving a 4 s utterance through models/wrappers.py:SpectrogramSeparator (STFT,
     KMeans or anchors, iSTFT) in f32 and bf16, DANet and ADANet card vs CPU (the CPU's
     initial centroids replayed on the card) and deep clustering's embeddings card vs CPU,
     each model's train step against an f64 step (B = 2 x 0.8 s) and the recipe's B = 64 x
     0.8 s step (p50, split, peak), cli/train_wsj0mix_spec.py --model danet at its recipe flags
     (rmsprop) two epochs (the loss falling), its checkpoint through cli/test_wsj0mix.py
     --spec_kind danet on the card and the CPU within EVAL_TOL_DB; every LSTM launch on the
     route _plan gives H = 300 (the cluster kernels padded to 384 for requests and small
     batches, the wide kernels at 384 for training's B = 64) and counted padded; and (16k)
     lstm_scan_bidir at H = 300, the training shape (64, 101) x 2 with cs and its backward
     and a 4 s utterance's (1, 501) x 2 in f32 and bf16, each against its plain version at
     the full length and the FMA kernel, the kernel alone and the whole call from CUDA graphs
     in turns with the FMA kernel, beside cuDNN's nn.LSTM and the bound;
  17. musdb18's 2-D dense / U-Net recipes at their recipe widths (the port's
     egs/musdb18/{d3net,mm-densenet,mm-dense-lstm,hrnet,cunet}/train.sh and the repo's
     recipe YAMLs): each model card vs CPU (a one-stem model, 1 s; CUNet keeps its four
     conditions), its base model in bf16 vs f32, one train step against an f64 CPU step
     (B = 1 x 0.25-1 s; f64 BatchNorm statistics; every ReLU of the card's and the CPU's f32
     steps on the f64 step's sign pattern, the card's own ReLU inputs across 0 only within
     their call's rounding), the recipe step at its batch or the largest power-of-two batch that
     fits (split, peak; D3Net's B = 6 does not fit), cli/train_musdb18.py two epochs of
     one step at that batch (the loss falling, the step p50, the peak, the checkpoint
     reopened); D3Net, MMDenseNet and MMDenseLSTM (the ones JAX's test CLI evaluates) served
     and scored through cli/test_musdb18.py on a 1 s synthetic track, card vs CPU (stems
     within 1e-3 x
     max|CPU|, medians within MUSDB_DB_TOL), and their B = 1 x 10 s forward timed and
     profiled (device time by kind, idle share); MMDenseLSTM's 24 recurrences a forward on
     their routes (H = 64 and 16 tensor cores, H = 4 the FMA kernel); and (17k)
     lstm_scan_bidir at H = 64, 16 and 4 at a 10 s chunk's B = 1 sequences in f32 and bf16
     and recipe training's B = 6 with cs and its backward, each against its plain version,
     beside the FMA kernel, cuDNN's nn.LSTM and the bound.
  18. slice G's wsj0-mix half at the recipe's width (egs/wsj0-mix/orpit_conv-tasnet and
     frequency-mask): (18a) a 2+3-speaker corpus (write_quality_corpus at two and three
     sources, merged here); one ORPIT train step of paper-config Conv-TasNet (B = 2 x 0.125
     s, counts [2, 3]) card vs an f64 CPU step, as phase 7, the chosen "one" equal;
     cli/train_wsj0mix.py --criterion orpit --n_sources 3 at B = 4 x 4 s, two epochs, one
     decode a validation batch and none a step, a fixed batch's loss falling over 6 steps
     (their p50) and the peak allocation; (18b) its checkpoint through cli/test_wsj0mix.py
     at the recipe's test.sh flags, card vs CPU within EVAL_TOL_DB, one decode an
     utterance; every decode of 18a-18c held to the plain decode of its inputs; (18c) one
     CLI step each of --pit hungarian, prob and sink (paper width, 3 sources, B = 4 x 0.5 s),
     the step's loss card vs CPU within LOSS_TOL, Hungarian's pattern equal to exhaustive
     PIT's, the host time its solve adds; (18d) cli/test_oracle_masks.py with each mask, the
     mean SI-SDRi card vs CPU within 1e-3 dB, the time an utterance; (18e) Griffin-Lim, fast
     Griffin-Lim, MISI (5 iterations) and NMF (KL, 16 bases, 50 updates) on a 4 s
     spectrogram (n_fft 256, hop 64) and MixIT on B = 8 x 4 s, card vs the CPU's f64 run
     within 1e-3 of its max (or 10x the CPU's f32 error: iterated phase retrieval magnifies
     rounding), each timed; then fused_mask_decode at the ORPIT validation shape (B = 4 x
     4 s) against its plain version, timed. The CPU's halves run in a thread beside the
     card's work.
  19. (19a) reference-format checkpoints (config keys and a state_dict, no model_class) of
     paper-config Conv-TasNet (`<root>/wsj0-mix/sr8000/2speakers/best.pth`) and recipe-config
     DPRNN-TasNet beside it, seed-0 weights, opened on the card through
     hub/pretrained.py:build_from_pretrained (by its layout and by a fetcher) and
     hub/torch_checkpoint.py:build_from_torch_checkpoint: the class JAX's dispatch picks,
     the state bit for bit, a B = 8 x 4 s forward and a 4 s utterance in f32 with every
     fused_mask_decode and lstm_scan_bidir launch on its planned route and held to the plain
     version, the utterance within 1e-3 x max|CPU| of the blob opened on the CPU, the
     forward's ms and peak; a missing file refused; (19b) TDCUNet2d at the CUNet recipe's
     widths (egs/musdb18/cunet/train.sh: B = 4 x 6 s maps, n_fft 1024, hop 768) card vs CPU,
     its forward ms and peak, one f32 train step (B = 1 x 1 s) against an f64 CPU step, the
     recipe step's p50 and peak; DenseNet, TFCLaSAFT, MLPMixer, PoolFormer, ViT,
     MultiDilatedConv2d, the complex layers, the activations and the pools at 64-256
     channels, card vs CPU within 1e-3 x max|CPU|; none of them launches a kernel of the
     port. The CPU's halves run in a thread beside the card's work.

Each serving, quantizing and evaluation path, and the training path of phase
8, runs with every launch count set to 0 just before it and read just after
it. Every recurrence forward and backward of phases 4b-4d, 6 and 7-10 is also
counted by path (the wrappers' PATH_LAUNCHES and BWD_PATH_LAUNCHES): each bf16
request and bf16 train step must launch only the bf16 tensor-core kernels
("mma" forward, "tf32x2" backward), each f32 one only the 3xTF32 kernels
("tf32x3"), and none the FMA kernels (the wsj0 models have H = 128); and
every decode of phases 4-4g, 6, 8 and 10 on its planned fused_mask_decode
path ("mma" in bf16, "generic" for f32 Conv-TasNet, "rows" for f32
DPRNN-TasNet). Phase 11's card runs (UMX at B = 1, H = 256 and 512) must
launch only the cluster kernel, and join the main path's total: musdb18
training's backward (lstm_scan_bidir_bwd at H = 256, phase 12) runs on the
cluster backward. Phase 13's DPTNet runs and phase 14's runs are held launch by
launch to their routes (the wide backward at its training sequences; LSTM-TasNet's
H = 500 on the padded cluster kernels, each launch also in PADDED_LAUNCHES) and then join
the total, which must have launched every path but the FMA ones, and no FMA kernel at
all but phase 17's (MMDenseLSTM's H = 4; each held to its route); phase 16's H = 300
runs the cluster and wide kernels padded to 384.
The last line
is {"ok": true, "device":
{...}}; the line before it lists the kernels with their launch counts,
errors, times, bounds and library times: fused_mask_decode six times
(Conv-TasNet's and DPRNN-TasNet's decoder widths and a streamed Conv-TasNet
hop, f32 and bf16), each on its path with the launches of its width and
dtype (WIDTH_LAUNCHES; the hop rows phase 4f's hops), one whole
wrapper call as `ms` and the kernel alone (from a CUDA graph) as
`kernel_ms`, beside the generic kernel's `generic_ms` and
`generic_kernel_ms` (a "rows" or "mma" row); the recurrence
forwards and backwards twice, f32 (3xTF32) and bf16 (the tensor cores), each
with the FMA kernel's time in the same dtype and run as `fma_ms` (the f32
forwards and every backward also with the FMA kernel's bound as
`fma_bound_ms`; the backwards also with the kernel alone as `kernel_ms`,
`fma_kernel_ms` and `kernel_bound_ms`); and lstm_scan_bidir and lstm_scan once
more at UMX's shapes (B = 1, T = 431; H = 256 and 512), on the cluster kernel,
with phase 11's launches, phase 3h's times, the FMA kernel's (`fma_ms`), the
other cluster size's (`c8_ms` or `c16_ms`) and the serial floor's (`floor_ms`);
lstm_scan_bidir at musdb18 training's shape with cs on its planned route (the cluster
kernel, or the wide one with phase 3i's times), and its backward there on the cluster
backward (the whole backward as `ms`, the kernel alone
as `kernel_ms`, the FMA backward's as `fma_ms` and `fma_kernel_ms`, both cluster
sizes' kernels alone as `c8_ms` and `c16_ms`, the serial floor as `floor_ms`, cuDNN's
backward as `library_ms`), with phase 12's launches; and DPTNet's LSTM forwards and
backwards at each phase-13 shape, on its route ("wide", with its tile as `tile` and the FMA
kernel's time as `fma_ms`; f32 bounded at three TF32 products at the tensor cores' TF32
peak; the backwards whole as `ms` and alone as `kernel_ms`, with phase 3j's cluster
backward forced as `cluster_kernel_ms` and serial floor as `floor_ms`), with phase 13's
launches of that kernel on that route; and phase 14's rows: fused_mask_decode at
LSTM-TasNet's, SepFormer's and GALRNet's decoder widths in both dtypes, and the LSTM
kernels at LSTM-TasNet's (H = 500, padded: the whole call with its pads as `ms`, the
kernel alone as `kernel_ms`, with phase 14's padded launches) and GALRNet's (H = 128)
shapes, with phase 14's launches of that kernel on that route; and phase 16k's rows:
lstm_scan_bidir at H = 300 on its planned route, padded to 384 (the whole call as `ms`,
the kernel alone as `kernel_ms`, the FMA kernel forced as `fma_ms`, cuDNN's nn.LSTM at
F = 129 as `library_ms`), with phase 16's launches of that kernel on that route;
and phase 17k's rows: lstm_scan_bidir at MMDenseLSTM's H = 64, 16
(tf32x3 / mma, the FMA kernel forced beside them) and 4 (the FMA kernel, whole call and
kernel alone), B = 1 serving and B = 6 training with its backward, cuDNN's nn.LSTM at the
layer's input width, with phase 17's launches of that kernel on that route; and phase 18's
row: fused_mask_decode at the ORPIT validation shape (f32, "generic"), with phase 18's
decodes; phase 19's decodes and recurrences join the f32 serving-shape, DPRNN-TasNet
decoder and lstm_scan_bidir tf32x3 rows. The bf16
fused_mask_decode rows'
`library_ms` is torch.einsum on bf16 operands, whose output is bf16 (the kernel's is f32).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from dnn_based_source_separation_torch.algorithm import (
    NMF, fast_griffin_lim, griffin_lim, misi,
)
from dnn_based_source_separation_torch.algorithm.frequency_mask import multichannel_wiener_filter
from dnn_based_source_separation_torch.algorithm.clustering import KMeans
from dnn_based_source_separation_torch.bench import (
    ADANET, DANET, DEEP_CLUSTERING, DPRNN, DPTNET, GALRNET, LSTM_TASNET, MUSDB_SAMPLE_RATE, PAPER,
    PEAK_FLOPS, SEPFORMER, SPEC_STFT, UMX, UMX_STFT, WAVESPLIT,
)
from dnn_based_source_separation_torch import bench as bench_module
from dnn_based_source_separation_torch.bench import main as bench_main
from dnn_based_source_separation_torch.cli import separate as cli
from dnn_based_source_separation_torch.cli import test_musdb18 as musdb_cli
from dnn_based_source_separation_torch.cli import test_oracle_masks as oracle_cli
from dnn_based_source_separation_torch.cli import test_wsj0mix as test_cli
from dnn_based_source_separation_torch.cli import train_musdb18 as musdb_train_cli
from dnn_based_source_separation_torch.cli import train_wsj0mix as train_cli
from dnn_based_source_separation_torch.cli import train_wsj0mix_spec as spec_train_cli
from dnn_based_source_separation_torch.cli import train_wsj0mix_wavesplit as wavesplit_train_cli
from dnn_based_source_separation_torch.criterion import (
    ORPIT, AffinityLoss, HungarianLoss, L2Loss, MixIT, NegSDR, NegSISDR, NegThresholdedSNR,
    PIT1d, PIT2d,
)
from dnn_based_source_separation_torch.data import wsj0mix as wsj0mix_data
from dnn_based_source_separation_torch.data.audio_io import read_wav, write_wav
from dnn_based_source_separation_torch.data.musdb18 import WaveTestDataset as MusdbTestDataset
from dnn_based_source_separation_torch.data.synthetic import (
    _speaker_bank, synth_pseudo_speech, write_musdb_quality_corpus, write_quality_corpus,
)
from dnn_based_source_separation_torch.hub import (
    build_from_pretrained, build_from_torch_checkpoint,
)
from dnn_based_source_separation_torch.models import (
    ADANet, ConvTasNet, CrossNetOpenUnmix, DANet, DeepEmbedding, DenseNet, DPRNNTasNet, DPTNet,
    FurcaNet, GALRNet, LSTMTasNet, ParallelOpenUnmix, SepFormer, SpectrogramMaskingWrapper,
    SpectrogramSeparator, TDCUNet2d, WaveNet, WaveSplit, lasaft, vision,
)
from dnn_based_source_separation_torch.models.base import load_model, save_model
from dnn_based_source_separation_torch.models.longform import chunk_count, separate_longform
from dnn_based_source_separation_torch.models.fold import fold_for_serving
from dnn_based_source_separation_torch.models.streaming import ExactStreamingSeparator
from dnn_based_source_separation_torch.ops import (
    _build, activation, complex_conv, filterbank, multidilated,
)
from dnn_based_source_separation_torch.ops import pool as pool_ops
from dnn_based_source_separation_torch.ops import rnn as rnn_ops
from dnn_based_source_separation_torch.ops import gru_scan as gs
from dnn_based_source_separation_torch.ops import lstm_scan as ls
from dnn_based_source_separation_torch.ops import mask_decode as md
from dnn_based_source_separation_torch.ops import quantize as q8
from dnn_based_source_separation_torch.ops.attention import MultiheadAttention
from dnn_based_source_separation_torch.ops.rnn import LSTM, set_dropout_generator
from dnn_based_source_separation_torch.ops.stft import stft
from dnn_based_source_separation_torch.ops.windows import build_window
from dnn_based_source_separation_torch.train import (
    Evaluater, Trainer, make_optimizer, make_train_step, make_warmup_optimizer,
)
from dnn_based_source_separation_torch.utils.device import TF32_OFF, resolve_device

SAMPLE_RATE = 8000
# PAPER: paper-config Conv-TasNet, N512 L16 S8 B128 H512 Sc128 P3 X8 R3,
# non-causal (entry.py); DPRNN: recipe-config DPRNN-TasNet, `causal` set per
# variant (bench.py).
SERVING_SHAPE = dict(B=8, S=2, T=3999, N=512, CL=16)  # B=8 x 4 s at 8 kHz
DPRNN_DECODE_SHAPE = dict(B=8, S=2, T=31999, N=64, CL=2)  # the same audio, DPRNN-TasNet
# The same audio through LSTM-TasNet's decoder (N=500, L=40, hop 20:
# egs/wsj0-mix/lstm-tasnet/train.sh:19): rows of 1000 bytes in bf16, not
# whole 16-byte vectors.
LSTM_TASNET_DECODE_SHAPE = dict(B=8, S=2, T=1599, N=500, CL=40)
# One streamed 0.05 s hop of causal Conv-TasNet after the first (T' = 49 on the
# first call, 50 after it), the mask the separator's strided view.
HOP_DECODE_SHAPE = dict(B=1, S=2, T=50, N=512, CL=16)
DECODE_SHAPES = {"serving shape": SERVING_SHAPE, "DPRNN-TasNet decoder shape": DPRNN_DECODE_SHAPE,
                 "LSTM-TasNet decoder shape": LSTM_TASNET_DECODE_SHAPE,
                 "streamed hop shape": HOP_DECODE_SHAPE}
# The decoders of phase 14's models at B = 8 x 4 s: LSTM-TasNet's (above), SepFormer's
# (N = 256, L = 16, hop 8) and GALRNet's (N = 64, L = 16, hop 8).
SLICE_D_DECODE_SHAPES = {"lstm_tasnet": LSTM_TASNET_DECODE_SHAPE,
                         "sepformer": dict(B=8, S=2, T=3999, N=256, CL=16),
                         "galrnet": dict(B=8, S=2, T=3999, N=64, CL=16)}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}  # relative to max|plain|
DECODE_REPEATS = 10  # fused_mask_decode launches a timing of the kernel alone
# (name, B, T, H). At B=8 x 4 s the DPRNN-TasNet latent has T' = 31999 frames,
# padded to 32000 = 255 chunks of K = 250 at hop 125.
LSTM_SHAPES = [
    ("intra", 2040, 250, 128),  # B*S sequences of K steps
    ("inter", 2000, 255, 128),  # B*K sequences of S steps
    ("odd", 37, 19, 40),
    ("odd H=128", 37, 19, 128),  # bf16: rows past B in the tensor-core tile
    ("T=1", 3, 1, 128),
    ("H=64", 50, 17, 64),
    ("stream", 3, 250, 128),  # one streamed hop: three chunks of K steps (timed)
    # Wider hidden sizes the wrapper accepts: W_hh rows past the shared-memory
    # stage come from global memory in bf16 too, and fewer groups per block.
    ("H=256", 64, 33, 256),
    ("H=512", 16, 9, 512),
]
# Absolute, and |hs| < 1. f32: the kernel and the plain version sum the
# recurrent product in another order. bf16: both round h to bf16 each step,
# and a rounding that lands the other way feeds every later step.
LSTM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
REPEATS = 5  # further launches of each tensor-core recurrence kernel, each checked
SNR_LIMIT_DB = 25.0
STREAMING_HOP = 0.05  # seconds: 400 samples at 8 kHz
STREAM_TOL = 1e-4  # streamed vs offline f32, relative to max|offline|
CHUNK_DURATION = 4.0  # seconds: long-form chunks of 32000 samples at a hop of 16000
LONGFORM_SECONDS = 30.0  # 14 real chunks, bucketed to 16

# The least time for a kernel's work is the larger of its operations over
# the peak for their type (bench.PEAK_FLOPS: one H100 SXM at its full 700 W)
# and its bytes (each input read once, each output written once) over the
# memory rate.
HBM_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, peak) -> dict:
    """`peak` keys PEAK_FLOPS: a dtype, or "tf32"."""
    return bound_of_ops({peak: flops}, nbytes)


def bound_of_ops(ops: dict, nbytes: float) -> dict:
    """The least time of work that runs ops[peak] operations at each PEAK_FLOPS rate, one
    after the other, and moves `nbytes`."""
    ops_s = sum(flops / PEAK_FLOPS[peak] for peak, flops in ops.items())
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's heading line also gets the seconds since the start."""
    if msg.startswith("=="):
        msg += f" [{time.perf_counter() - START:.1f} s]"
    print(msg, flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


GRAPH_BUDGET_MS = 100.0  # a timing's runs: fewer (not under 3 or 5) where one run is long
LATENCY_RUNS = 2  # CLI requests timed a model (phase 6)
STREAM_TIMED_HOPS = 40  # hops timed a streamed model and dtype (phase 6): the first 2 s
BENCH_LINE_ITERS = 5  # timed forwards of the in-process bench lines of phases 13 and 14


@contextlib.contextmanager
def bench_iters(iters):
    """The bench module timing `iters` forwards (its ITERS) inside the block: the
    informational per-model bench lines; phase 6 runs the module as a user does."""
    saved, bench_module.ITERS = bench_module.ITERS, iters
    try:
        yield
    finally:
        bench_module.ITERS = saved


def budget_ms(fn, iters: int = 20, least: int = 3, warmup: int = 1) -> float:
    """median_ms of fn with as many runs as GRAPH_BUDGET_MS holds, from `least` to `iters`,
    after `warmup` runs (the last of them timed to count the runs)."""
    for _ in range(max(0, warmup - 1)):
        fn()
    first = median_ms(fn, warmup=0, iters=1)
    return median_ms(fn, warmup=0,
                     iters=max(least, min(iters, int(GRAPH_BUDGET_MS / max(first, 1e-3)))))


def timed_once(fn):
    """(fn(), its ms on the card between CUDA events): one run, for a plain version whose
    result is the reference and whose time is the kernel line's plain_ms."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(launch, repeats: int, iters: int = 20) -> float:
    """ms of one launch() on the card alone: `repeats` launches captured in one CUDA
    graph, its replay timed by median_ms (of `iters`, or of as many as GRAPH_BUDGET_MS
    holds, at least 5), over `repeats`."""
    launch()  # the first call of a path sets its kernel's attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeats):
            launch()
    return budget_ms(graph.replay, iters=iters, least=5) / repeats


def kernel_inputs(B, S, T, N, CL, dtype, strided, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((B, T, N), dtype=np.float32))
    mask = torch.from_numpy(rng.uniform(0, 1, (B, T, S, N)).astype(np.float32))
    kernel = torch.from_numpy((0.1 * rng.standard_normal((N, CL))).astype(np.float32))
    w, mask, kernel = (t.to("cuda", dtype) for t in (w, mask, kernel))
    # The separator hands the decoder a (B, S, T', N) view of a (B, T', S, N)
    # tensor; the strided case feeds the kernel exactly that.
    mask = mask.transpose(1, 2) if strided else mask.transpose(1, 2).contiguous()
    return w, mask, kernel


def mask_decode_bound(B, S, T, N, CL, dtype) -> dict:
    """The least time of fused_mask_decode's work: w, mask and K read once in
    their dtype, the f32 output written once; (w * mask) @ K per frame."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (B * T * N * (1 + S) + N * CL) + 4.0 * B * S * T * CL
    return bound(B * S * T * N * (2.0 * CL + 1), nbytes, dtype)


def mask_decode_library(w, mask, kernel):
    """One PyTorch call for the same function: in f32 it is fused_mask_decode."""
    return torch.einsum("btn,bstn,nc->bstc", w, mask, kernel)


def on_path(paths, name, call, want):
    """Run one call; it must have launched `name` once, on path `want`. `paths`: the
    wrapper's launch counts of `name` by path."""
    before = dict(paths)
    out = call()
    torch.cuda.synchronize()
    grew = {p: n - before[p] for p, n in paths.items()}
    check(grew == {p: int(p == want) for p in grew}, f"{name} took {grew}, expected {want}")
    return out


def phase_kernel():
    """fused_mask_decode against its plain version on the path `_plan` gives each case,
    and on the generic kernel too where that is "rows" or "mma"; timed at the decoder
    shapes of Conv-TasNet, DPRNN-TasNet and LSTM-TasNet (the new path and the generic
    kernel in turns: generic, new, new, generic), with its bound and einsum's time (f32,
    where einsum computes the same function)."""
    log("== phase 3: fused_mask_decode vs plain on the card")
    cases = [
        (dict(SERVING_SHAPE), True),
        (dict(HOP_DECODE_SHAPE), True),
        (dict(B=1, S=2, T=37, N=512, CL=16), False),
        (dict(B=2, S=2, T=1001, N=512, CL=32), True),
        (dict(B=1, S=2, T=129, N=512, CL=64), False),
        (dict(DPRNN_DECODE_SHAPE), True),
        # Frames past the last whole work item of "rows" (8 frames) and of
        # "mma" (8 frames); an odd S and S = 1 (the last pair's second source
        # masked); narrow N and both n8-tile counts of "mma"; N past the last
        # whole 32-wide chunk and C·L past the last n8 tile; widths "rows" does
        # not take in f32.
        (dict(B=3, S=2, T=4001, N=64, CL=2), True),
        (dict(B=2, S=3, T=77, N=64, CL=2), True),
        (dict(B=2, S=1, T=77, N=64, CL=2), False),
        (dict(B=2, S=3, T=77, N=512, CL=16), True),
        (dict(B=2, S=2, T=99, N=16, CL=4), False),
        (dict(B=2, S=2, T=99, N=32, CL=1), True),
        (dict(B=2, S=2, T=99, N=128, CL=16), True),
        (dict(B=2, S=2, T=99, N=256, CL=8), False),
        (dict(B=2, S=2, T=77, N=200, CL=12), False),
        # Widths past the 16-byte vectors and past 64 columns of K.
        (dict(LSTM_TASNET_DECODE_SHAPE), True),
        (dict(LSTM_TASNET_DECODE_SHAPE), False),
        (dict(B=2, S=2, T=333, N=61, CL=2), True),
        (dict(B=2, S=2, T=333, N=61, CL=2), False),
        (dict(B=2, S=2, T=257, N=512, CL=80), True),
        (dict(B=2, S=2, T=257, N=512, CL=80), False),
    ]
    result = {}
    for shape, strided in cases:
        for dtype in (torch.float32, torch.bfloat16):
            which = next((k for k, v in DECODE_SHAPES.items() if v == shape), None)
            timing = decode_case(shape, strided, dtype, which if strided else None)
            if timing is not None:
                result[(which, dtype)] = timing
    return result


def decode_case(shape, strided, dtype, which=None):
    """fused_mask_decode at one shape in `dtype` against its plain version, on the path
    `_plan` gives it and, where that is "rows" or "mma", on the generic kernel too. With
    `which` (a label), timed: one whole call and the kernel alone, the new path and the
    generic kernel in turns (generic, new, new, generic), with its bound, the plain
    version's time and einsum's (f32) -> a timing dict (else None)."""
    w, mask, kernel = kernel_inputs(**shape, dtype=dtype, strided=strided, seed=shape["T"])
    path = md.launch_plan(w, mask, kernel)
    ref = md.fused_mask_decode_reference(w, mask, kernel)
    scale = float(ref.abs().max())
    calls = {p: (lambda p=p: md.fused_mask_decode(w, mask, kernel, path=p))
             for p in dict.fromkeys((path, "generic"))}
    errs = {}
    for p, call in calls.items():
        got = on_path(md.PATH_LAUNCHES, "fused_mask_decode", call, p)
        check(got.shape == ref.shape and got.dtype == torch.float32, (got.shape, got.dtype))
        errs[p] = float((got - ref).abs().max())
        ok = errs[p] <= TOL[dtype] * scale
        log(f"  {shape} strided={strided} {str(dtype)[6:]} {p}: max|kernel-plain| = "
            f"{errs[p]:.3e} (limit {TOL[dtype]:g} x max|plain| {scale:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"fused_mask_decode ({p}) disagrees with plain: "
                                 f"{errs[p]} > {TOL[dtype]} x {scale}")
    if which is None:
        return None
    # `ms` is one whole wrapper call, as the decoder makes it (planning,
    # allocation and the ctypes call included); `kernel_ms` is the kernel
    # alone, from a CUDA graph of DECODE_REPEATS launches, so that the
    # host's time a launch (which the hop shape's kernel is shorter than)
    # stays out of it.
    alone = {p: md._staged(w, mask, kernel, p)[0] for p in calls}

    def call_ms(p):
        return median_ms(calls[p])

    def kernel_ms(p):
        return graph_ms(alone[p], DECODE_REPEATS)

    timing = dict(path=path, max_abs_err=errs[path], library_ms=None)
    if path != "generic":
        for key, time_of in (("ms", call_ms), ("kernel_ms", kernel_ms)):
            first = time_of("generic")
            new = [time_of(path), time_of(path)]
            again = time_of("generic")
            timing.update({key: sum(new) / 2, f"generic_{key}": (first + again) / 2})
            timing[f"{key}_turns"] = (first, *new, again)
        timing["generic_max_abs_err"] = errs["generic"]
        times = "; ".join(
            f"{what} {path} {t[1]:.4f} / {t[2]:.4f} ms between generic {t[0]:.4f} / "
            f"{t[3]:.4f} ms" for what, t in (("one call", timing.pop("ms_turns")),
                                            ("kernel alone",
                                             timing.pop("kernel_ms_turns"))))
    else:
        timing.update(ms=call_ms(path), kernel_ms=kernel_ms(path))
        times = (f"generic: one call {timing['ms']:.4f} ms, kernel alone "
                 f"{timing['kernel_ms']:.4f} ms")
    timing["plain_ms"] = median_ms(lambda: md.fused_mask_decode_reference(w, mask,
                                                                          kernel))
    timing.update(mask_decode_bound(**shape, dtype=dtype))
    if dtype == torch.float32:
        lib = mask_decode_library(w, mask, kernel)
        check(float((lib - ref).abs().max()) <= TOL[dtype] * scale,
              "einsum is not the same function")
    # In bf16 einsum on the bf16 operands (its output bf16, the kernel's f32).
    timing["library_ms"] = median_ms(lambda: mask_decode_library(w, mask, kernel))
    library = f"einsum{'' if dtype == torch.float32 else ' (bf16 out)'} " \
              f"{timing['library_ms']:.4f} ms, "
    log(f"  {which} {str(dtype)[6:]}: {times}, plain {timing['plain_ms']:.4f} ms, "
        f"{library}bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}) "
        f"(medians of 20, CUDA events)")
    for p, launch in alone.items():  # after a few hundred launches into one output
        err = float((launch() - ref).abs().max())
        check(err <= TOL[dtype] * scale, f"fused_mask_decode ({p}) disagrees with "
                                         f"plain after the timed launches: {err}")
    return timing


def lstm_inputs(B, T, H, dtype, seed):
    """Two chains' gates ~ N(0, 0.25) and recurrent weights ~ U(+-1/sqrt(H)), made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xw = [0.5 * torch.randn(B, T, 4 * H, device="cuda", generator=gen) for _ in range(2)]
    w = [(2 * torch.rand(H, 4 * H, device="cuda", generator=gen) - 1) * H ** -0.5
         for _ in range(2)]
    return [t.to(dtype) for t in (*xw, *w)]


def gru_inputs(B, T, H, dtype, seed):
    """Two chains' input projections ~ N(0, 0.25), recurrent weights ~ U(+-1/sqrt(H)) and
    b_hh ~ N(0, 0.01), made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xw = [0.5 * torch.randn(B, T, 3 * H, device="cuda", generator=gen) for _ in range(2)]
    w = [(2 * torch.rand(H, 3 * H, device="cuda", generator=gen) - 1) * H ** -0.5
         for _ in range(2)]
    b = [0.1 * torch.randn(3 * H, device="cuda", generator=gen) for _ in range(2)]
    return [t.to(dtype) for t in (*xw, *w, *b)]


def forward_path(module, kname, call, want):
    """Run one forward call; it must have launched `kname` once, on path `want`."""
    return on_path(module.PATH_LAUNCHES[kname], kname, call, want)


def plan(module, B, n_chains, H, dtype, path=None):
    """module._plan as the wrapper calls it on this card, over its routes -> (path, tile)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = wide = None
    if ls._needs_clusters(H, dtype, path, routes=module.ROUTES):
        clusters = (ls._forward_clusters if module is ls else gs._tf32_clusters)(
            ls.cluster_width(H), "cuda")
    if ls._needs_wide(H, dtype, path, module.ROUTES):
        wide = ls._wide_counts(ls.cluster_width(H), dtype, "cuda")
    return module._plan(B, n_chains, H, dtype, sms, path, clusters, module.ROUTES, wide)


def phase_scan(title, module, make_inputs, runs):
    """Recurrence kernels against their plain versions at LSTM_SHAPES, f32 and bf16.

    runs(*inputs) -> {kernel name: (kernel call, plain call, FMA-forced call)}, each
    call returning a tuple of hs. Every launch must take the path `_plan` gives its
    dtype and shape; where that is a tensor-core path ("mma" in bf16, "tf32x3" in
    f32), the FMA kernel is forced and held to the plain version too. At the intra
    and inter serving shapes and the streamed hop the kernel is timed: the
    tensor-core kernel, the FMA kernel and the tensor-core kernel again, in turn.
    """
    log(title)
    result = {}
    H = DPRNN["sep_hidden_channels"]
    log(f"  clusters of the 3xTF32 kernel the card holds at once, by blocks a cluster "
        f"(H={H}): {module._tf32_clusters(H, 'cuda')}")
    for name, B, T, H in LSTM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs = make_inputs(B, T, H, dtype, seed=B + T + H)
            for kname, (kernel, plain, fma) in runs(*inputs).items():
                n_chains = 2 if kname.endswith("bidir") else 1
                path, tile = plan(module, B, n_chains, H, dtype)
                calls = {path: kernel}
                if path != "fma":
                    calls["fma"] = fma
                ref = plain()
                errs = {}
                for p, call in calls.items():
                    got = forward_path(module, kname, call, p)
                    for a, b in zip(got, ref):
                        check(a.shape == b.shape == (B, T, H) and a.dtype == b.dtype == dtype,
                              (kname, a.shape, a.dtype))
                    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
                    errs[p] = err
                    ok = err <= LSTM_TOL[dtype]
                    _, p_tile = plan(module, B, n_chains, H, dtype, p)
                    p_tile = (f"M={p_tile[0]}, C={p_tile[1]}" if isinstance(p_tile, tuple)
                              else f"{'R' if p == 'fma' else 'M'}={p_tile}")
                    log(f"  {kname} {name} (B={B}, T={T}, H={H}) {str(dtype)[6:]} {p} "
                        f"({p_tile}): max|kernel-plain| = "
                        f"{err:.3e} (limit {LSTM_TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"{kname} ({p}) disagrees with plain at {name}: "
                                             f"{err}")
                if path != "fma":  # a race shows only in some launches: repeat, check each
                    worst = max(max(float((a.float() - b.float()).abs().max())
                                    for a, b in zip(kernel(), ref)) for _ in range(REPEATS))
                    log(f"    {REPEATS} more {path} launches: worst max|kernel-plain| = "
                        f"{worst:.3e}")
                    check(worst <= LSTM_TOL[dtype], f"{kname} ({path}) disagreed with plain "
                                                    f"in a repeated launch at {name}: {worst}")
                if name in ("intra", "inter", "stream"):
                    timing = dict(max_abs_err=errs[path])
                    if path != "fma":
                        first = median_ms(kernel, warmup=2, iters=10)
                        timing["fma_ms"] = median_ms(fma, warmup=2, iters=10)
                        again = median_ms(kernel, warmup=2, iters=10)
                        timing.update(ms=(first + again) / 2, fma_max_abs_err=errs["fma"])
                        times = (f"{path} {first:.4f} / {again:.4f} ms around FMA "
                                 f"{timing['fma_ms']:.4f} ms")
                    else:
                        timing["ms"] = median_ms(kernel, warmup=2, iters=10)
                        times = f"kernel {timing['ms']:.4f} ms"
                    timing["plain_ms"] = median_ms(plain, warmup=1, iters=3)
                    log(f"    {times}, plain {timing['plain_ms']:.4f} ms (medians of 10 and 3, "
                        f"CUDA events)")
                    result[(kname, name, dtype)] = timing
    return result


def phase_lstm():
    return phase_scan(
        "== phase 3b: lstm_scan_bidir and lstm_scan vs plain on the card", ls, lstm_inputs,
        lambda xw_f, xw_b, w_f, w_b: {
            "lstm_scan_bidir": (
                lambda: ls.lstm_scan_bidir(xw_f, xw_b, w_f, w_b),
                lambda: ls.lstm_scan_bidir_reference(xw_f, xw_b, w_f, w_b),
                lambda: tuple(ls._forward_cuda([(xw_f, w_f), (xw_b, w_b)], False, "fma")[0])),
            "lstm_scan": (lambda: (ls.lstm_scan(xw_f, w_f),),
                          lambda: (ls.lstm_scan_reference(xw_f, w_f),),
                          lambda: tuple(ls._forward_cuda([(xw_f, w_f)], False, "fma")[0])),
        })


def phase_gru():
    return phase_scan(
        "== phase 3c: gru_scan_bidir and gru_scan vs plain on the card", gs, gru_inputs,
        lambda xw_f, xw_b, w_f, w_b, b_f, b_b: {
            "gru_scan_bidir": (
                lambda: gs.gru_scan_bidir(xw_f, xw_b, w_f, w_b, b_f, b_b),
                lambda: gs.gru_scan_bidir_reference(xw_f, xw_b, w_f, w_b, b_f, b_b),
                lambda: tuple(gs._forward_cuda([(xw_f, w_f, b_f), (xw_b, w_b, b_b)], "fma"))),
            "gru_scan": (lambda: (gs.gru_scan(xw_f, w_f, b_f),),
                         lambda: (gs.gru_scan_reference(xw_f, w_f, b_f),),
                         lambda: tuple(gs._forward_cuda([(xw_f, w_f, b_f)], "fma"))),
        })


# Backward kernels at the recipe-config training shapes, B = 2 x 4 s: the
# latent has T' = 31999 frames, padded to 32000 = 255 chunks of K = 250.
BWD_SHAPES = [
    ("intra", 510, 250, 128),  # B*S sequences of K steps
    ("inter", 500, 255, 128),  # B*K sequences of S steps
    ("odd", 37, 19, 40),
    ("T=1", 3, 1, 128),
    ("H=256", 64, 33, 256),
    # musdb18 training of UMX / X-UMX: B = 16 x 6 s, 259 frames, H = 512 // 2 a direction;
    # the LSTM backward's route there and at "H=256" is "cluster" (the tensor cores stop
    # at H = 128), the GRU's "fma".
    ("umx-train", 16, 259, 256),
]
UMX_TRAIN_SHAPE = (16, 259, 256)  # B, T, H of BWD_SHAPES' "umx-train"
BWD_TOL = 1e-4  # f32, relative to max|plain|: the recurrent sums run in another order


def bwd_limit(dtype, scale):
    """f32: BWD_TOL x max|plain|; bf16: 2 bf16 ulps of max|plain| (both round the same f32
    derivatives, which differ only in the order of the recurrent sums)."""
    if dtype == torch.float32:
        return BWD_TOL * scale
    return 2.0 * 2.0 ** (np.floor(np.log2(scale)) - 7) if scale > 0 else 0.0


def plan_bwd(module, B, n_chains, H, dtype, path=None):
    """module._plan_bwd as the wrapper calls it on this card, over its routes -> (path, tile)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clusters = wide = None
    if ls._needs_clusters(H, dtype, path, True, module.ROUTES):
        clusters = (module._tf32_bwd_clusters(H, "cuda") if H <= ls.MMA_MAX_HIDDEN
                    else ls._cluster_bwd_counts(ls.cluster_width(H), "cuda"))
    if ls._needs_wide(H, dtype, path, module.ROUTES, backward=True):
        wide = ls._wide_counts(ls.cluster_width(H), dtype, "cuda", backward=True)
    return module._plan_bwd(B, n_chains, H, dtype, sms, path, clusters, module.ROUTES, wide)


def tile_label(tile) -> str:
    """A plan's tile for the log: R of the FMA kernels, (M, C) of the tensor-core
    backward, (1, C) of the cluster one."""
    if not isinstance(tile, tuple):
        return f"R={tile}"
    return f"C={tile[1]}" if tile[0] == 1 else f"M={tile[0]}, C={tile[1]}"


def backward_path(module, kname, call, want):
    """Run one backward call; it must have launched `kname` once, on path `want`."""
    return on_path(module.BWD_PATH_LAUNCHES[kname], kname, call, want)


def grad_errors(kname, got, ref, dtype):
    """[(max|kernel - plain|, limit)] of each gradient."""
    errs = []
    for a, b in zip(got, ref):
        check(a.shape == b.shape and a.dtype == b.dtype == dtype, (kname, a.shape, a.dtype))
        errs.append((float((a.float() - b.float()).abs().max()),
                     bwd_limit(dtype, float(b.float().abs().max()))))
    return errs


def check_backward(module, kname, label, grads_of, plain_chains, ref, plain, timed,
                   features=UMX["hidden_channels"]):
    """One backward under autograd (`grads_of()`, its gradients in `ref`'s order) on the
    path _plan_bwd gives it, against the plain version's `ref`. Where another kernel than
    FMA runs, REPEATS more launches are checked and the FMA kernel is forced and checked
    too. If `timed` (a shape where another kernel than FMA runs), the whole backward (gate
    recompute, kernel, parameter gradients) and the kernel alone are timed, the FMA kernel
    and the planned one in turns (FMA, new, new, FMA; the cluster and wide backwards from
    CUDA graphs, by graph_bwd_turns, with cuDNN's backward at input width `features`, none
    if None), and `plain` (its ms, or a call timed once) -> a timing dict. A padded route
    (H = 500 on the cluster backward at 512) is counted in PADDED_LAUNCHES and held to the
    FMA kernel's gradients too, at the same limits."""
    xw, w_hh = plain_chains[0][:2]
    B, T, _ = xw.shape
    H, dtype = w_hh.shape[0], xw.dtype
    path, tile = plan_bwd(module, B, len(plain_chains), H, dtype)
    padded = module is ls and ls.launch_width(H, path) != H

    def flat(outs):
        return [d for chain in outs for d in chain]

    calls = {path: grads_of}
    if path != "fma":
        calls["fma"] = lambda: flat(module._backward_cuda(plain_chains, "fma"))
    errs, got = {}, {}
    for p, call in calls.items():
        before = ls.PADDED_LAUNCHES[kname] if module is ls else 0
        got[p] = backward_path(module, kname, call, p)
        if module is ls:
            check(ls.PADDED_LAUNCHES[kname] - before == (padded and p == path),
                  f"{kname} ({p}) at {label}: padded launches off")
        e = grad_errors(kname, got[p], ref, dtype)
        p_tile = tile_label(plan_bwd(module, B, len(plain_chains), H, dtype, p)[1])
        ok = all(x <= lim for x, lim in e)
        log(f"  {kname} {label} {p} ({p_tile}): max|kernel-plain| / limit of each gradient: "
            + ", ".join(f"{x:.3e} / {lim:.3e}" for x, lim in e) + (" ok" if ok else " FAIL"))
        if not ok:
            raise AssertionError(f"{kname} ({p}) disagrees with plain at {label}")
        errs[p] = max(x for x, _ in e)
    if padded:
        e = grad_errors(kname, got[path], got["fma"], dtype)
        log(f"    padded {path} vs the FMA backward: max|diff| / limit of each gradient: "
            + ", ".join(f"{x:.3e} / {lim:.3e}" for x, lim in e))
        check(all(x <= lim for x, lim in e), f"{kname} padded {path} disagrees with FMA")
    if path != "fma":  # a race shows only in some launches: repeat, check each
        worst = 0.0
        for _ in range(REPEATS):
            e = grad_errors(kname, flat(module._backward_cuda(plain_chains)), ref, dtype)
            check(all(x <= lim for x, lim in e),
                  f"{kname} ({path}) disagreed with plain in a repeated launch at {label}: {e}")
            worst = max(worst, max(x / lim if lim else 0.0 for x, lim in e))
        log(f"    {REPEATS} more {path} launches: worst max|kernel-plain| {worst:.3f} of its limit")
    if not timed:
        return None
    if path in ("cluster", "wide"):
        timing = graph_bwd_turns(plain_chains, path, tile, plain, features)
        timing.update(max_abs_err=errs[path], fma_max_abs_err=errs["fma"])
        return timing
    # The staged arrays stay alive with each launch call.
    paths = (path, "fma")
    calls = {"whole": {p: (lambda p=p: module._backward_cuda(plain_chains, p)) for p in paths},
             "alone": {p: module._staged_backward(plain_chains, p)[1] for p in paths}}
    ms = {}
    for what, by_path in calls.items():
        label_of = "whole backward" if what == "whole" else "kernel alone"
        fma_1, new_1, new_2, fma_2 = (budget_ms(by_path[p], iters=10, warmup=2)
                                      for p in ("fma", path, path, "fma"))
        ms[what] = ((new_1 + new_2) / 2, (fma_1 + fma_2) / 2)
        log(f"    {label_of}: {path} {new_1:.4f} / {new_2:.4f} ms between FMA {fma_1:.4f} / "
            f"{fma_2:.4f} ms")
    plain_ms = plain_time(plain)
    log(f"    plain {plain_ms:.4f} ms (medians of up to 10, one plain run, CUDA events)")
    return dict(max_abs_err=errs[path], ms=ms["whole"][0], kernel_ms=ms["alone"][0],
                plain_ms=plain_ms, fma_max_abs_err=errs["fma"], fma_ms=ms["whole"][1],
                fma_kernel_ms=ms["alone"][1])


def library_lstm_bwd_ms(B, T, H, chains, dtype, features=UMX["hidden_channels"]):
    """cuDNN's nn.LSTM backward at the kernel's shape (torch.autograd.grad of its output
    for the input and the parameters), input projection from `features` (UMX's 512 by
    default) included (informational; the port never calls it)."""
    lstm = torch.nn.LSTM(features, H, batch_first=True,
                         bidirectional=chains == 2, device="cuda", dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(B + T)
    x = torch.randn(B, T, features, device="cuda", generator=gen).to(dtype)
    x.requires_grad_()
    y = lstm(x)[0]
    g = torch.randn(y.shape, device="cuda", generator=gen).to(dtype)
    inputs = [x, *lstm.parameters()]
    return budget_ms(lambda: torch.autograd.grad(y, inputs, g, retain_graph=True), iters=10,
                     warmup=2)


def plain_time(plain) -> float:
    """A plain version's ms: given, or one run of the call between CUDA events."""
    return plain if isinstance(plain, float) else timed_once(plain)[1]


def graph_bwd_turns(chains, path, tile, plain, features=UMX["hidden_channels"]):
    """The cluster or wide backward on its planned tile timed from CUDA graphs in turns with
    the FMA backward forced in the same run (FMA, new, new, FMA), the whole backward (the
    gate recompute, the kernel, d_W_hh) and the kernel alone; beside the plain version (its
    ms, or a call timed once) and cuDNN's backward (input width `features`: UMX's 512 by
    default; None: not timed here) -> a timing dict."""
    xw, w_hh = chains[0][:2]
    B, T, _ = xw.shape
    H = w_hh.shape[0]
    calls = {"whole": {p: (lambda p=p: ls._backward_cuda(chains, p)) for p in ("fma", path)},
             "alone": {p: ls._staged_backward(chains, p)[1] for p in ("fma", path)}}
    repeats = {"fma": 1, path: CLUSTER_REPEATS if path == "cluster" else 1}
    ms = {}
    for what, by_path in calls.items():
        fma_1, new_1, new_2, fma_2 = (graph_ms(by_path[p], repeats[p])
                                      for p in ("fma", path, path, "fma"))
        ms[what] = ((new_1 + new_2) / 2, (fma_1 + fma_2) / 2)
        log(f"    {'whole backward' if what == 'whole' else 'kernel alone'}: {path} "
            f"({tile_label(tile)}) {new_1:.4f} / {new_2:.4f} ms between FMA {fma_1:.4f} / "
            f"{fma_2:.4f} ms (CUDA graphs)")
    plain_ms = plain_time(plain)
    library_ms = (None if features is None else
                  library_lstm_bwd_ms(B, T, H, len(chains), xw.dtype, features))
    log(f"    plain {plain_ms:.4f} ms (one run)" + ("" if library_ms is None else
        f"; cuDNN nn.LSTM backward {library_ms:.4f} ms (F={features}, median of up to 10)"))
    timing = dict(ms=ms["whole"][0], kernel_ms=ms["alone"][0], fma_ms=ms["whole"][1],
                  fma_kernel_ms=ms["alone"][1], plain_ms=plain_ms, library_ms=library_ms)
    if path == "cluster":
        timing["cluster"] = tile[1]
    else:
        timing["tile"] = list(tile)
    return timing


def phase_lstm_bwd():
    """The training forward (with cs) and the backward kernels against the plain versions."""
    log("== phase 3d: lstm_scan_bidir and lstm_scan backward vs plain on the card")
    H = DPRNN["sep_hidden_channels"]
    log(f"  clusters of the tensor-core backward the card holds at once, by blocks a cluster "
        f"(H={H}): {ls._tf32_bwd_clusters(H, 'cuda')}")
    H = UMX_TRAIN_SHAPE[2]
    log(f"  clusters of the cluster backward the card holds at once, by blocks a cluster "
        f"(H={H}): {ls._cluster_bwd_counts(H, 'cuda')}")
    result = {}
    for name, B, T, H in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xw_f, xw_b, w_f, w_b = lstm_inputs(B, T, H, dtype, seed=B + T + H + 1)
            gen = torch.Generator(device="cuda").manual_seed(B + T)
            g_f, g_b = (torch.randn(B, T, H, device="cuda", generator=gen).to(dtype)
                        for _ in range(2))
            path, _ = plan(ls, B, 2, H, dtype)
            (hs_f, hs_b), (cs_f, cs_b) = forward_path(
                ls, "lstm_scan_bidir",
                lambda: ls._forward_cuda([(xw_f, w_f), (xw_b, w_b)], True), path)
            cs_err, cs_scale = 0.0, 1.0
            for xw, w, hs, cs in ((xw_f, w_f, hs_f, cs_f), (xw_b, w_b, hs_b, cs_b)):
                hs_ref, cs_ref = ls.lstm_forward_reference(xw, w)
                cs_scale = max(cs_scale, float(cs_ref.float().abs().max()))
                cs_err = max(cs_err, float((cs.float() - cs_ref.float()).abs().max()),
                             float((hs.float() - hs_ref.float()).abs().max()))
            cs_ok = cs_err <= LSTM_TOL[dtype] * cs_scale
            log(f"  forward with cs {name} (B={B}, T={T}, H={H}) {str(dtype)[6:]} {path}: "
                f"max|kernel-plain| of hs, cs = {cs_err:.3e} (limit {LSTM_TOL[dtype]:g} x "
                f"{cs_scale:.3f}) {'ok' if cs_ok else 'FAIL'}")
            if not cs_ok:
                raise AssertionError(f"forward cs disagrees with plain at {name}: {cs_err}")
            for kname, chains, grads in (
                    ("lstm_scan_bidir_bwd", [(xw_f, w_f, hs_f, cs_f), (xw_b, w_b, hs_b, cs_b)],
                     (g_f, g_b)),
                    ("lstm_scan_bwd", [(xw_f, w_f, hs_f, cs_f)], (g_f,))):
                leaves = [t.clone().requires_grad_() for c in chains for t in c[:2]]
                fn = ls.lstm_scan_bidir if len(chains) == 2 else ls.lstm_scan

                def grads_of(fn=fn, leaves=leaves, grads=grads):
                    outs = fn(*leaves[0::2], *leaves[1::2])
                    return torch.autograd.grad(outs if len(grads) == 2 else (outs,), leaves,
                                               grads)

                plain_chains = [(*c, g) for c, g in zip(chains, grads)]
                ref = [d for c in plain_chains for d in ls.lstm_scan_bwd_reference(*c)]
                timing = check_backward(
                    ls, kname, f"{name} (B={B}, T={T}, H={H}) {str(dtype)[6:]}", grads_of,
                    plain_chains, ref,
                    lambda: [ls.lstm_scan_bwd_reference(*c) for c in plain_chains],
                    timed=name in ("intra", "inter") or (
                        name == "umx-train" and kname == "lstm_scan_bidir_bwd"
                        and dtype == torch.float32))
                if timing is not None:
                    result[(kname, name, dtype)] = timing
    # fused_mask_decode has no backward (as in JAX): it refuses autograd on the
    # card rather than drop it.
    try:
        md.fused_mask_decode(*kernel_inputs(1, 2, 37, 512, 16, torch.float32, True, 0)[:2],
                             torch.zeros(512, 16, device="cuda", requires_grad=True))
    except NotImplementedError as err:
        log(f"  fused_mask_decode under autograd on CUDA raises: {str(err)[:80]}...")
    else:
        raise AssertionError("fused_mask_decode returned a result under autograd on CUDA")
    return result


def phase_gru_bwd():
    """The backward kernels of the GRU recurrences against gru_scan_bwd_reference."""
    log("== phase 3e: gru_scan_bidir and gru_scan backward vs plain on the card")
    H = DPRNN["sep_hidden_channels"]
    log(f"  clusters of the tensor-core backward the card holds at once, by blocks a cluster "
        f"(H={H}): {gs._tf32_bwd_clusters(H, 'cuda')}")
    result = {}
    for name, B, T, H in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            xw_f, xw_b, w_f, w_b, b_f, b_b = gru_inputs(B, T, H, dtype, seed=B + T + H + 2)
            gen = torch.Generator(device="cuda").manual_seed(B + T + 1)
            g_f, g_b = (torch.randn(B, T, H, device="cuda", generator=gen).to(dtype)
                        for _ in range(2))
            hs_f, hs_b = gs._forward_cuda([(xw_f, w_f, b_f), (xw_b, w_b, b_b)])
            for kname, chains, hs, grads in (
                    ("gru_scan_bidir_bwd", [(xw_f, w_f, b_f), (xw_b, w_b, b_b)], (hs_f, hs_b),
                     (g_f, g_b)),
                    ("gru_scan_bwd", [(xw_f, w_f, b_f)], (hs_f,), (g_f,))):
                leaves = [t.clone().requires_grad_() for c in chains for t in c]

                def grads_of(leaves=leaves, grads=grads):
                    if len(grads) == 2:
                        outs = gs.gru_scan_bidir(*leaves[0::3], *leaves[1::3], *leaves[2::3])
                    else:
                        outs = (gs.gru_scan(*leaves),)
                    return torch.autograd.grad(outs, leaves, grads)

                plain_chains = [(*c, h, g) for c, h, g in zip(chains, hs, grads)]
                ref = [d for c in plain_chains for d in gs.gru_scan_bwd_reference(*c)]
                timing = check_backward(
                    gs, kname, f"{name} (B={B}, T={T}, H={H}) {str(dtype)[6:]}", grads_of,
                    plain_chains, ref,
                    lambda: [gs.gru_scan_bwd_reference(*c) for c in plain_chains],
                    timed=name in ("intra", "inter"))
                if timing is not None:
                    result[(kname, name, dtype)] = timing
    return result


QUANT_BIG = (4096, 4096)
STOCH_SHAPE, STOCH_SEEDS = (1024, 1024), 64
# Stochastic rounding over 64 seeds: the mean of q - x / scale over every draw
# is 0 within 1e-3 (16 standard deviations of a mean of 67M draws, each
# within +-1), and each value's mean over the seeds within 0.45 of x / scale
# (7.2 standard deviations of a mean of 64 draws, over 1M values).
STOCH_MEAN_TOL, STOCH_VALUE_TOL = 1e-3, 0.45


def phase_quantize():
    """quantize_int8 against its plain version, bit for bit, and stochastic rounding."""
    log("== phase 3f: quantize_int8 vs plain on the card")
    model = ConvTasNet(**PAPER, generator=torch.Generator().manual_seed(0), device="cuda")
    tensors = [t.reshape(t.shape[0], -1).contiguous() for t in model.state_dict().values()
               if q8.quantizable(t)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    big = torch.randn(*QUANT_BIG, device="cuda", generator=gen)
    err = 0.0
    for x in tensors + [big]:
        values, scale = q8.quantize_int8(x)
        ref_values, ref_scale = q8.quantize_int8_reference(x)
        torch.cuda.synchronize()
        check(values.dtype == torch.int8 and values.shape == x.shape and scale.shape == (1, 1),
              (values.dtype, values.shape, scale.shape))
        err = max(err, float((values.int() - ref_values.int()).abs().max()),
                  float((scale - ref_scale).abs().max()))
        if not (torch.equal(values, ref_values) and torch.equal(scale, ref_scale)):
            raise AssertionError(f"quantize_int8 differs from plain at {tuple(x.shape)}")
    log(f"  {len(tensors)} weight tensors of paper-config Conv-TasNet and one "
        f"{QUANT_BIG}: int8 values and scales equal to the plain version bit for bit")
    ms = median_ms(lambda: q8.quantize_int8(big), warmup=3, iters=20)
    plain_ms = median_ms(lambda: q8.quantize_int8_reference(big), warmup=3, iters=20)
    log(f"  {QUANT_BIG}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 20, CUDA "
        f"events)")

    x = torch.randn(*STOCH_SHAPE, device="cuda", generator=gen)
    _, scale = q8.quantize_int8(x)
    s = x / scale
    low, high = torch.floor(s), torch.ceil(s)
    total = torch.zeros_like(s, dtype=torch.float64)
    previous = None
    for seed in range(STOCH_SEEDS):
        values, st_scale = q8.quantize_int8(x, seed=seed, stochastic=True)
        q = values.float()
        check(torch.equal(st_scale, scale), "the stochastic scale differs")
        check(bool(((q == low) | (q == high)).all()), f"seed {seed}: a value is neither the "
                                                      "floor nor the ceiling")
        check(previous is None or not torch.equal(values, previous), "two seeds drew alike")
        previous = values
        total += (q - s).double()
    mean_all = float(total.mean()) / STOCH_SEEDS
    worst = float((total / STOCH_SEEDS).abs().max())
    log(f"  stochastic, {STOCH_SHAPE} over {STOCH_SEEDS} seeds: every value the floor or the "
        f"ceiling; mean(q - x/scale) {mean_all:.2e} (limit {STOCH_MEAN_TOL:g}), worst value's "
        f"mean {worst:.3f} (limit {STOCH_VALUE_TOL:g})")
    check(abs(mean_all) <= STOCH_MEAN_TOL and worst <= STOCH_VALUE_TOL,
          "stochastic rounding is biased")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


# The recurrence kernels' timed shapes, (rows, B, T, chains, phase): serving
# (3b, 3c) and training (3d, 3e). DPRNN-TasNet's RNNs take N = 64 features.
LIBRARY_SHAPES = {
    "scan_bidir": (2040, 250, 2), "scan": (2000, 255, 1),
    "scan_bidir_bwd": (510, 250, 2), "scan_bwd": (500, 255, 1),
}
RNN_FEATURES = DPRNN["sep_bottleneck_channels"]


def phase_library():
    """cuDNN's nn.LSTM / nn.GRU at the recurrence kernels' timed shapes (informational):
    the forward and the backward, in f32 and bf16 (nn.LSTM at musdb18's shapes: phases 3d
    and 3h); and torch.einsum on bf16 operands at fused_mask_decode's timed shapes (its
    output is bf16, the kernel's f32).

    One PyTorch call each: the module's forward, or torch.autograd.grad of
    its output for the backward rows. Both also do the input projection
    (x @ W_ih and its gradients), which the port's kernels take as given.
    """
    log("== phase 3g: library calls beside the recurrence kernels (cuDNN, informational)")
    result = {}
    H = DPRNN["sep_hidden_channels"]
    rows = [(row, shape, torch.float32) for row, shape in LIBRARY_SHAPES.items()]
    rows += [(row, shape, torch.bfloat16) for row, shape in LIBRARY_SHAPES.items()]
    F = RNN_FEATURES
    for rnn, cls in (("lstm", torch.nn.LSTM), ("gru", torch.nn.GRU)):
        for row, (B, T, chains), dtype in rows:
            module = cls(F, H, batch_first=True, bidirectional=chains == 2,
                         device="cuda", dtype=dtype)
            gen = torch.Generator(device="cuda").manual_seed(B + T)
            x = torch.randn(B, T, F, device="cuda", generator=gen).to(dtype)
            if row.endswith("bwd"):
                x.requires_grad_()
                y = module(x)[0]
                g = torch.randn(y.shape, device="cuda", generator=gen)
                inputs = [x, *module.parameters()]
                ms = median_ms(lambda: torch.autograd.grad(y, inputs, g, retain_graph=True),
                               warmup=2, iters=10)
            else:
                with torch.no_grad():
                    ms = median_ms(lambda: module(x), warmup=2, iters=10)
            result[f"{rnn}_{row}" + ("_bf16" if dtype == torch.bfloat16 else "")] = ms
            log(f"  {cls.__name__} {'backward' if row.endswith('bwd') else 'forward'} "
                f"{str(dtype)[6:]} (B={B}, T={T}, F={F}, H={H}, {chains} chain(s)): "
                f"{ms:.4f} ms (median of 10, CUDA events)")
    for which, shape in DECODE_SHAPES.items():
        w, mask, kernel = kernel_inputs(**shape, dtype=torch.bfloat16, strided=True, seed=0)
        ref = md.fused_mask_decode_reference(w, mask, kernel)
        err = float((mask_decode_library(w, mask, kernel).float() - ref).abs().max())
        ms = median_ms(lambda: mask_decode_library(w, mask, kernel))
        result[f"einsum_bf16/{which}"] = ms
        log(f"  torch.einsum on bf16 operands at fused_mask_decode's {which} {shape}: "
            f"{ms:.4f} ms (median of 20, CUDA events); bf16 output, max|einsum - plain f32| "
            f"{err:.3e} of max|plain| {float(ref.abs().max()):.3e}")
    return result


# Phase 3h: the cluster route of the LSTM forwards (csrc/recurrence_cluster.cuh) at
# musdb18 serving's shapes (UMX_SCAN_SHAPES: a 10 s chunk at B = 1) and around them,
# (label, B, T, H, chains): three clusters a chain (B = 3), one row block of W_hh in
# shared memory (H = 384; H = 512 has two), H = 300 zero-padded to 384 (DANet's, ADANet's
# and deep clustering's width), one step.
CLUSTER_CASES = [
    ("UMX", 1, 431, 256, 2),
    ("causal UMX", 1, 431, 512, 1),
    ("B=3", 3, 57, 256, 2),
    ("B=3", 3, 57, 512, 1),
    ("H=384", 1, 57, 384, 1),
    ("H=300", 3, 57, 300, 2),
    ("T=1", 1, 1, 256, 2),
    ("UMX train", *UMX_TRAIN_SHAPE[:2], UMX_TRAIN_SHAPE[2], 2),  # musdb18 training, with cs
]
# The cases timed, and whether with cs (the training forward).
TIMED_CLUSTER_CASES = {"UMX": False, "causal UMX": False, "UMX train": True}
CROSSOVER_BATCHES = (1, 16, 128, 256, 512)  # cluster against FMA, f32
LIBRARY_ITERS = 50  # cuDNN's time at B = 1 spread 1.7x between calls on an H100 (PERF.md)
CLUSTER_REPEATS = 5  # launches in a timed CUDA graph


def lstm_chains(B, T, H, chains, dtype, seed):
    """One or two (xw, w_hh) chains of lstm_inputs."""
    xw_f, xw_b, w_f, w_b = lstm_inputs(B, T, H, dtype, seed)
    return [(xw_f, w_f), (xw_b, w_b)][:chains]


def forward_error(inputs, hs, cs, dtype):
    """max|kernel - plain| of hs (and of cs, each over max(1, max|plain cs|)) -> (error,
    its limit)."""
    return forward_error_of([ls.lstm_forward_reference(xw, w) for xw, w in inputs], hs, cs,
                            dtype)


def forward_error_of(refs, hs, cs, dtype):
    """forward_error against the plain versions' (hs, cs) of each chain, `refs`."""
    err, scale = 0.0, 1.0
    for (hs_ref, cs_ref), h, c in zip(refs, hs, cs or [None] * len(hs)):
        err = max(err, float((h.float() - hs_ref.float()).abs().max()))
        if c is not None:
            scale = max(scale, float(cs_ref.float().abs().max()))
            err = max(err, float((c.float() - cs_ref.float()).abs().max()))
    return err, LSTM_TOL[dtype] * scale


def library_lstm_ms(B, T, H, chains, dtype, features=UMX["hidden_channels"],
                    iters=LIBRARY_ITERS):
    """cuDNN's nn.LSTM at the kernel's shape, input projection from `features` (UMX's 512
    by default) included (informational; the port never calls it)."""
    lstm = torch.nn.LSTM(features, H, batch_first=True,
                         bidirectional=chains == 2, device="cuda", dtype=dtype)
    x = torch.randn(B, T, features, device="cuda").to(dtype)
    with torch.no_grad():
        return budget_ms(lambda: lstm(x), iters=iters, warmup=1)


def phase_cluster(card=None):
    """The cluster route against the plain version at CLUSTER_CASES, f32 and bf16, on
    every cluster size the card holds that H admits, hs alone and with cs (the training
    forward), each launch checked REPEATS more times; the plan's route through the
    public wrappers. At UMX's two shapes it is timed from CUDA graphs in turns with the
    FMA kernel forced in the same run (FMA, cluster, cluster, FMA), beside the other
    cluster size, the serial floor (the product compiled out), the plain version,
    cuDNN's nn.LSTM and the bound; then the crossover over B against the FMA kernel."""
    log("== phase 3h: the cluster route of lstm_scan_bidir and lstm_scan vs plain on the card")
    card = card or card_line()
    for H in sorted({ls.cluster_width(case[3]) for case in CLUSTER_CASES}):
        log(f"  clusters of the cluster kernel the card holds at once, by blocks a cluster "
            f"(H={H}): {ls._cluster_counts(H, 'cuda')}")
    result = {}
    for label, B, T, H, chains in CLUSTER_CASES:
        name = "lstm_scan_bidir" if chains == 2 else "lstm_scan"
        width = ls.cluster_width(H)  # a padded case's kernel width
        counts = ls._cluster_counts(width, "cuda")
        for dtype in (torch.float32, torch.bfloat16):
            inputs = lstm_chains(B, T, H, chains, dtype, seed=B + T + H)
            refs = [ls.lstm_forward_reference(xw, w) for xw, w in inputs]  # every check's
            path, tile = plan(ls, B, chains, H, dtype)
            what = f"{name} {label} (B={B}, T={T}, H={H}) {str(dtype)[6:]}"
            if label in TIMED_CLUSTER_CASES:  # the plan's rule: "wide" from WIDE_MIN_BATCH up
                want = ("wide" if H == ls.WIDE_HIDDEN and
                        B >= ls.WIDE_MIN_BATCH[H][(dtype, chains)] else "cluster")
                check(path == want, f"{what} planned {path}, expected {want}")
            if path == "cluster":  # through the public wrapper, as the models call it
                call = ((lambda: ls.lstm_scan_bidir(inputs[0][0], inputs[1][0], inputs[0][1],
                                                    inputs[1][1])) if chains == 2 else
                        (lambda: (ls.lstm_scan(*inputs[0]),)))
                got = forward_path(ls, name, call, "cluster")
                err, limit = forward_error_of(refs, got, None, dtype)
                check(err <= limit, f"{what} through the wrapper: {err} > {limit}")
            sizes = [c for c in ls._cluster_sizes(width, dtype) if counts.get(c, 0) >= 1]
            check(sizes, f"the card holds no cluster the kernel takes at H={width}: {counts}")
            errs = {}
            for c in sizes:
                for with_cs in (False, True):
                    hs, cs, launch = ls._staged_forward(inputs, with_cs, "cluster", c)
                    on_path(ls.PATH_LAUNCHES[name], name, launch, "cluster")
                    err, limit = forward_error_of(refs, hs, cs if with_cs else None, dtype)
                    worst = err
                    for _ in range(REPEATS):  # a race shows only in some launches
                        launch()
                        worst = max(worst, forward_error_of(refs, hs, cs if with_cs else None,
                                                            dtype)[0])
                    errs[(c, with_cs)] = err
                    ok = worst <= limit
                    log(f"  {what} cluster (C={c}{', plan' if tile == (1, c) else ''}"
                        f"{', with cs' if with_cs else ''}): max|kernel-plain| = {err:.3e}, "
                        f"worst of {1 + REPEATS} launches {worst:.3e} (limit {limit:.3g}) "
                        f"{'ok' if ok else 'FAIL'}")
                    check(ok, f"{what} on {c}-block clusters disagrees with plain: {worst}")
            if label not in TIMED_CLUSTER_CASES or (label == "UMX train" and
                                                    dtype != torch.float32):
                continue
            # The cluster route's own tile, forced where the plan takes "wide".
            C, with_cs = plan(ls, B, chains, H, dtype, "cluster")[1][1], TIMED_CLUSTER_CASES[label]
            fma_hs, fma_cs, fma = ls._staged_forward(inputs, with_cs, "fma")
            on_path(ls.PATH_LAUNCHES[name], name, fma, "fma")
            fma_err, _ = forward_error_of(refs, fma_hs, fma_cs if with_cs else None, dtype)
            _, _, kernel = ls._staged_forward(inputs, with_cs, "cluster", C)
            _, floor = ls._staged_cluster_floor(inputs, C)
            turns = (graph_ms(fma, 1), graph_ms(kernel, CLUSTER_REPEATS),
                     graph_ms(kernel, CLUSTER_REPEATS), graph_ms(fma, 1))
            timing = dict(cluster=C, max_abs_err=errs[(C, with_cs)], fma_max_abs_err=fma_err,
                          ms=(turns[1] + turns[2]) / 2, fma_ms=(turns[0] + turns[3]) / 2,
                          floor_ms=graph_ms(floor, CLUSTER_REPEATS))
            for c in sizes:
                if c != C:
                    timing[f"c{c}_ms"] = graph_ms(
                        ls._staged_forward(inputs, with_cs, "cluster", c)[2], CLUSTER_REPEATS)
            plain = ls.lstm_forward_reference if with_cs else ls.lstm_scan_reference
            timing["plain_ms"] = median_ms(lambda: [plain(xw, w) for xw, w in inputs],
                                           warmup=1, iters=3)
            timing["library_ms"] = library_lstm_ms(B, T, H, chains, dtype)
            timing.update(recurrence_bound(B, T, H, 4, chains, cell_state=with_cs, dtype=dtype))
            others = "".join(f", C={k[1:-3]} {v:.4f} ms" for k, v in timing.items()
                             if k.startswith("c") and k.endswith("_ms"))
            log(f"    cluster (C={C}{', with cs' if with_cs else ''}) {turns[1]:.4f} / "
                f"{turns[2]:.4f} ms between FMA "
                f"{turns[0]:.4f} / {turns[3]:.4f} ms{others}; serial floor "
                f"{timing['floor_ms']:.4f} ms ({timing['floor_ms'] / T * 1e3:.3f} us a step "
                f"against {timing['ms'] / T * 1e3:.3f}); plain {timing['plain_ms']:.4f} ms; "
                f"cuDNN nn.LSTM {timing['library_ms']:.4f} ms (F={UMX['hidden_channels']}, median "
                f"of {LIBRARY_ITERS}); bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}) "
                f"(kernels from CUDA graphs, CUDA events) [{card}]")
            result[(name, dtype, label)] = timing
    log(f"  crossover over B, f32, T=431 (kernels from CUDA graphs, medians of 5) [{card}]:")
    crossover = []
    for name, (_, T, H, chains) in UMX_SCAN_SHAPES.items():
        for B in CROSSOVER_BATCHES:
            inputs = lstm_chains(B, T, H, chains, torch.float32, seed=B + T + H)
            natural = plan(ls, B, chains, H, torch.float32)
            cl_hs, _, cl = ls._staged_forward(inputs, False, "cluster")
            forced = plan(ls, B, chains, H, torch.float32, "cluster")[1]
            _, _, fma = ls._staged_forward(inputs, False, "fma")
            row = dict(name=name, B=B, H=H, plan=natural, cluster=forced[1],
                       cluster_ms=graph_ms(cl, 2, iters=5), fma_ms=graph_ms(fma, 1, iters=5))
            err, limit = forward_error(inputs, cl_hs, None, torch.float32)
            check(err <= limit, f"{name} cluster at B={B} disagrees with plain: {err}")
            crossover.append(row)
            log(f"    {name} H={H} B={B}: cluster (C={forced[1]}) {row['cluster_ms']:.4f} ms, "
                f"FMA {row['fma_ms']:.4f} ms; the plan takes {natural}")
    result["crossover"] = crossover
    result.update(phase_cluster_bwd(card))
    return result


# The cluster backward's crossover over B against the FMA backward (the kernels alone,
# f32): musdb18 training's T at H = 256 on two chains and H = 512 on one.
CLUSTER_BWD_CROSSOVER = {"lstm_scan_bidir_bwd": (259, 256, 2), "lstm_scan_bwd": (259, 512, 1)}
CLUSTER_BWD_BATCHES = (1, 64, 256, 512)


def bwd_chains(B, T, H, chains, dtype, seed):
    """One or two (xw, w_hh, hs, cs, g_hs) chains: lstm_inputs' gates and weights, and hs,
    cs and a cotangent drawn on the card (the backward's function takes any hs and cs)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for xw, w in lstm_chains(B, T, H, chains, dtype, seed):
        hs, cs, g = (torch.randn(B, T, H, device="cuda", generator=gen) for _ in range(3))
        out.append((xw, w, torch.tanh(hs).to(dtype), cs.to(dtype), g.to(dtype)))
    return out


def staged_bwd_errors(name, staged, chains, refs, dtype):
    """[(max|kernel - plain|, limit)] of d_xw and d_W_hh of each chain of a staged backward
    launch (a padded one's sliced back to the chain's H), against lstm_scan_bwd_reference's
    `refs`."""
    got = [t for (h_prev, *_, das, d_xw), (_, w_hh, *_) in zip(staged, chains)
           for t in (ls.unpad_gates(d_xw, w_hh.shape[0]),
                     ls.unpad_weight_grad(ls._weight_grad(h_prev, das, w_hh.dtype),
                                          w_hh.shape[0]))]
    return grad_errors(name, got, [t for ref in refs for t in ref], dtype)


def phase_cluster_bwd(card):
    """The cluster backward against lstm_scan_bwd_reference at CLUSTER_CASES, f32 and bf16,
    on every cluster size the card holds that H admits, each launch checked REPEATS more
    times; the plan must take it at every case. At musdb18 training's shape both
    cluster sizes and the serial floor (the product compiled out) timed from CUDA graphs
    (phase 3d times the planned size beside the FMA backward and cuDNN); then the
    crossover over B against the FMA backward, which sets CLUSTER_MAX_BATCH_BWD."""
    log("  the cluster backward (csrc/recurrence_cluster_bwd.cuh) vs lstm_scan_bwd_reference:")
    for H in sorted({ls.cluster_width(case[3]) for case in CLUSTER_CASES}):
        log(f"  clusters of the cluster backward the card holds at once, by blocks a cluster "
            f"(H={H}): {ls._cluster_bwd_counts(H, 'cuda')}")
    result = {}
    for label, B, T, H, chains in CLUSTER_CASES:
        name = "lstm_scan_bidir_bwd" if chains == 2 else "lstm_scan_bwd"
        width = ls.cluster_width(H)  # a padded case's kernel width
        counts = ls._cluster_bwd_counts(width, "cuda")
        for dtype in (torch.float32, torch.bfloat16):
            inputs = bwd_chains(B, T, H, chains, dtype, seed=B + T + H + 3)
            refs = [ls.lstm_scan_bwd_reference(*c) for c in inputs]
            path, tile = plan_bwd(ls, B, chains, H, dtype)
            what = f"{name} {label} (B={B}, T={T}, H={H}) {str(dtype)[6:]}"
            check(path == "cluster", f"{what} planned {path}, expected cluster")
            sizes = [c for c in ls._cluster_sizes(width, dtype, True) if counts.get(c, 0) >= 1]
            check(sizes, f"the card holds no cluster the backward takes at H={width}: {counts}")
            for c in sizes:
                staged, launch = ls._staged_backward(inputs, "cluster", c)
                on_path(ls.BWD_PATH_LAUNCHES[name], name, launch, "cluster")
                errs = staged_bwd_errors(name, staged, inputs, refs, dtype)
                worst = max(x / lim if lim else 0.0 for x, lim in errs)
                for _ in range(REPEATS):  # a race shows only in some launches
                    launch()
                    worst = max(worst, max(x / lim if lim else 0.0 for x, lim in
                                           staged_bwd_errors(name, staged, inputs, refs, dtype)))
                log(f"  {what} cluster (C={c}{', plan' if tile == (1, c) else ''}): "
                    f"max|kernel-plain| / limit of d_xw, d_W_hh: "
                    + ", ".join(f"{x:.3e} / {lim:.3e}" for x, lim in errs)
                    + f"; worst of {1 + REPEATS} launches {worst:.3f} of its limit "
                    + ("ok" if worst <= 1 else "FAIL"))
                check(worst <= 1, f"{what} on {c}-block clusters disagrees with plain: {worst}")
            if label != "UMX train" or dtype != torch.float32:
                continue
            timing = {f"c{c}_ms": graph_ms(ls._staged_backward(inputs, "cluster", c)[1],
                                           CLUSTER_REPEATS) for c in sizes}
            timing["floor_ms"] = graph_ms(ls._staged_bwd_floor(inputs, "cluster", tile)[1],
                                          CLUSTER_REPEATS)
            log(f"    kernel alone: " + ", ".join(f"C={k[1:-3]} {v:.4f} ms" for k, v in
                                                 timing.items() if k != "floor_ms")
                + f"; serial floor (C={tile[1]}) {timing['floor_ms']:.4f} ms "
                f"({timing['floor_ms'] / T * 1e3:.3f} us a step against "
                f"{timing[f'c{tile[1]}_ms'] / T * 1e3:.3f}) (CUDA graphs) [{card}]")
            result[("bwd", name, label)] = timing
    log(f"  the cluster backward's crossover over B, f32, the kernels alone (CUDA graphs, "
        f"medians of 5) [{card}]:")
    crossover = []
    for name, (T, H, chains) in CLUSTER_BWD_CROSSOVER.items():
        for B in CLUSTER_BWD_BATCHES:
            inputs = bwd_chains(B, T, H, chains, torch.float32, seed=B + T + H)
            natural = plan_bwd(ls, B, chains, H, torch.float32)
            forced = plan_bwd(ls, B, chains, H, torch.float32, "cluster")[1]
            staged, cl = ls._staged_backward(inputs, "cluster")
            fma = ls._staged_backward(inputs, "fma")[1]
            row = dict(name=name, B=B, H=H, plan=natural, cluster=forced[1],
                       cluster_ms=graph_ms(cl, 2, iters=5), fma_ms=graph_ms(fma, 1, iters=5))
            errs = staged_bwd_errors(name, staged, inputs,
                                     [ls.lstm_scan_bwd_reference(*c) for c in inputs],
                                     torch.float32)
            check(all(x <= lim for x, lim in errs),
                  f"{name} cluster backward at B={B} disagrees with plain: {errs}")
            crossover.append(row)
            log(f"    {name} H={H} B={B}: cluster (C={forced[1]}) {row['cluster_ms']:.4f} ms, "
                f"FMA {row['fma_ms']:.4f} ms; the plan takes {natural}")
    result["bwd_crossover"] = crossover
    return result


# Phase 3i: the wide route of the LSTM forwards (csrc/recurrence_wide.cuh) at H = 256, and
# at 384 on H = 300 zero-padded (WIDE_PADDED). Every tile (M, C) of each dtype at B = 37 (no
# multiple of any M: rows past B in the last tile), one and two chains, hs alone and with
# cs; a T = 1 case on the plan's tile (at H = 256 through the wrappers).
# Timed: musdb18 training's shape, (label, (B, T, chains), with cs), where the
# plan weighs the wide route against the cluster route (phase 13k times DPTNet's shapes);
# then the crossover over B against the cluster route that WIDE_MIN_BATCH encodes.
WIDE_CHECK = (37, 57)
WIDE_T1 = (20, 1)
WIDE_PADDED = 300  # DANet's, ADANet's and deep clustering's H, at 384
WIDE_TIMED = [("UMX train", (UMX_TRAIN_SHAPE[0], UMX_TRAIN_SHAPE[1], 2), True)]
WIDE_CROSSOVER_BATCHES = (4, 16, 64, 200, 512)
WIDE_CROSSOVER_STEPS = (259, 639)


def wide_checked(what, launch, hs, cs, refs, dtype, repeats):
    """Launch a wide kernel 1 + `repeats` times, each output held to the plain version's
    `refs` -> max|kernel - plain| of the first launch."""
    launch()
    err, limit = forward_error_of(refs, hs, cs, dtype)
    worst = err
    for _ in range(repeats):  # a race shows only in some launches
        launch()
        worst = max(worst, forward_error_of(refs, hs, cs, dtype)[0])
    log(f"  {what}: max|kernel-plain| = {err:.3e}, worst of {1 + repeats} launches "
        f"{worst:.3e} (limit {limit:.3g}) {'ok' if worst <= limit else 'FAIL'}")
    check(worst <= limit, f"{what} disagrees with plain: {worst} > {limit}")
    return err


def phase_wide(card=None):
    """The wide route against the plain version: every tile each dtype admits and the
    card holds, one and two chains, hs alone and with cs, on the path (counted), every
    launch repeated and checked; T = 1 through the public wrapper where the plan takes
    it. At WIDE_TIMED's shapes the path's kernel alone from CUDA graphs in turns with the
    FMA kernel forced (FMA, wide, wide, FMA), beside the cluster route forced, the plain version, cuDNN's nn.LSTM (F = 64,
    DPTNet's input width) and the bound; then the crossover over B against the cluster
    route. -> {(name, dtype, label): timing, "crossover": rows}."""
    log("== phase 3i: the wide route of lstm_scan_bidir and lstm_scan vs plain on the card")
    card = card or card_line()
    result = {}
    for H, dtype in [(H, d) for H in (ls.WIDE_HIDDEN, WIDE_PADDED)
                     for d in (torch.float32, torch.bfloat16)]:
        width = ls.cluster_width(H)
        counts = ls._wide_counts(width, dtype, "cuda")
        log(f"  clusters of the wide kernel the card holds at once, H={width}, "
            f"{str(dtype)[6:]}, by tile (M, C): {counts}")
        tiles = [t for t in ls._wide_tiles(width, dtype) if counts[t] >= 1]
        check(tiles, f"the card holds no cluster of the wide kernel in {dtype}: {counts}")
        for chains in (1, 2):
            name = "lstm_scan_bidir" if chains == 2 else "lstm_scan"
            B, T = WIDE_CHECK
            inputs = lstm_chains(B, T, H, chains, dtype, seed=B + T + chains)
            refs = [ls.lstm_forward_reference(xw, w) for xw, w in inputs]
            for tile in tiles:
                for with_cs in (False, True):
                    what = (f"{name} (B={B}, T={T}, H={H}) {str(dtype)[6:]} wide (M={tile[0]}, "
                            f"C={tile[1]}{', with cs' if with_cs else ''}"
                            f"{f', padded to {width}' if width != H else ''})")
                    hs, cs, launch = ls._staged_forward(inputs, with_cs, "wide", tile=tile)
                    on_path(ls.PATH_LAUNCHES[name], name, launch, "wide")
                    wide_checked(what, launch, hs, cs if with_cs else None, refs, dtype,
                                 REPEATS)
            B, T = WIDE_T1
            if width != H:  # one step on every tile; the plan's routes at H = 300: phase 16
                inputs = lstm_chains(B, T, H, chains, dtype, seed=B + T + chains)
                refs = [ls.lstm_forward_reference(xw, w) for xw, w in inputs]
                for tile in tiles:
                    hs, cs, launch = ls._staged_forward(inputs, True, "wide", tile=tile)
                    wide_checked(f"{name} (B={B}, T={T}, H={H}) {str(dtype)[6:]} wide "
                                 f"({tile_label(tile)}, with cs, padded to {width})", launch, hs,
                                 cs, refs, dtype, 0)
                continue
            inputs = lstm_chains(B, T, H, chains, dtype, seed=B + T + chains)
            path, tile = plan(ls, B, chains, H, dtype)
            want = "wide" if B >= ls.WIDE_MIN_BATCH[width][(dtype, chains)] else "cluster"
            check(path == want, f"{name} at B={B} planned {path}, expected {want}")
            call = ((lambda: ls.lstm_scan_bidir(inputs[0][0], inputs[1][0], inputs[0][1],
                                                inputs[1][1])) if chains == 2 else
                    (lambda: (ls.lstm_scan(*inputs[0]),)))
            got = forward_path(ls, name, call, path)
            err, limit = forward_error(inputs, got, None, dtype)
            log(f"  {name} (B={B}, T={T}) {str(dtype)[6:]} through the wrapper on {path} "
                f"({tile_label(tile)}): max|kernel-plain| = {err:.3e} (limit {limit:.3g})")
            check(err <= limit, f"{name} T=1 disagrees with plain: {err} > {limit}")
    for label, (B, T, chains), with_cs in WIDE_TIMED:
        name = "lstm_scan_bidir" if chains == 2 else "lstm_scan"
        for dtype in (torch.float32,) if with_cs else (torch.float32, torch.bfloat16):
            result[(name, dtype, label)] = wide_timing(label, name, B, T, chains, dtype, with_cs,
                                                       card)
    result["crossover"] = wide_crossover(card)
    return result


def wide_timing(label, name, B, T, chains, dtype, with_cs, card):
    """One WIDE_TIMED case: the wide kernel on its forced plan tile checked once, then
    timed alone from CUDA graphs -> timing."""
    H = ls.WIDE_HIDDEN
    inputs = lstm_chains(B, T, H, chains, dtype, seed=B + T)
    tile = plan(ls, B, chains, H, dtype, "wide")[1]
    what = f"{name} {label} (B={B}, T={T}, H={H}) {str(dtype)[6:]}"
    hs, cs, wide = ls._staged_forward(inputs, with_cs, "wide", tile=tile)
    on_path(ls.PATH_LAUNCHES[name], name, wide, "wide")
    err, limit = forward_error(inputs, hs, cs if with_cs else None, dtype)
    log(f"  {what} wide ({tile_label(tile)}{', with cs' if with_cs else ''}): "
        f"max|kernel-plain| {err:.3e} (limit {limit:.3g})")
    check(err <= limit, f"{what} disagrees with plain: {err} > {limit}")
    fma = ls._staged_forward(inputs, with_cs, "fma")[2]
    turns = (graph_ms(fma, 1), graph_ms(wide, 1), graph_ms(wide, 1), graph_ms(fma, 1))
    timing = dict(path="wide", tile=list(tile), max_abs_err=err, ms=(turns[1] + turns[2]) / 2,
                  fma_ms=(turns[0] + turns[3]) / 2)
    cluster_tile = plan(ls, B, chains, H, dtype, "cluster")[1]
    timing["cluster_ms"] = graph_ms(ls._staged_forward(inputs, with_cs, "cluster")[2],
                                    CLUSTER_REPEATS if B * chains <= 64 else 1)
    plain = ls.lstm_forward_reference if with_cs else ls.lstm_scan_reference
    timing["plain_ms"] = median_ms(lambda: [plain(xw, w) for xw, w in inputs], warmup=0,
                                   iters=1)
    timing["library_ms"] = library_lstm_ms(B, T, H, chains, dtype, features=DPT_E, iters=10)
    timing.update(recurrence_bound(B, T, H, 4, chains, cell_state=with_cs, dtype=dtype,
                                   tf32=3 if dtype == torch.float32 else 0))
    log(f"    wide {turns[1]:.4f} / {turns[2]:.4f} ms between FMA {turns[0]:.4f} / "
        f"{turns[3]:.4f} ms; cluster ({tile_label(cluster_tile)}) "
        f"{timing['cluster_ms']:.4f} ms; plain {timing['plain_ms']:.4f} ms; cuDNN nn.LSTM "
        f"{timing['library_ms']:.4f} ms (F={DPT_E}, median of 10); bound "
        f"{timing['bound_ms']:.4f} ms ({timing['bound_by']}) ({timing['ms'] / T * 1e3:.3f} us "
        f"a step; kernels from CUDA graphs, CUDA events) [{card}]")
    return timing


def wide_crossover(card):
    """The wide route (its forced plan tile) against the cluster route (its forced plan
    cluster size) over WIDE_CROSSOVER_BATCHES, T in WIDE_CROSSOVER_STEPS, one and two chains,
    both dtypes, the kernels alone from CUDA graphs, each wide output held to the plain
    version -> rows; the least B from which wide wins at every larger B of the sweep, per
    (dtype, chains), is what WIDE_MIN_BATCH encodes."""
    log(f"  the wide route against the cluster route over B (kernels from CUDA graphs, "
        f"medians of 5) [{card}]:")
    H = ls.WIDE_HIDDEN
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for chains in (1, 2):
            name = "lstm_scan_bidir" if chains == 2 else "lstm_scan"
            wins = {}
            for T in WIDE_CROSSOVER_STEPS:
                for B in WIDE_CROSSOVER_BATCHES:
                    inputs = lstm_chains(B, T, H, chains, dtype, seed=B + T + H)
                    natural = plan(ls, B, chains, H, dtype)[0]
                    tile = plan(ls, B, chains, H, dtype, "wide")[1]
                    cluster = plan(ls, B, chains, H, dtype, "cluster")[1]
                    hs, _, wide = ls._staged_forward(inputs, False, "wide", tile=tile)
                    cl = ls._staged_forward(inputs, False, "cluster")[2]
                    row = dict(name=name, dtype=str(dtype)[6:], B=B, T=T, plan=natural,
                               tile=list(tile), cluster=cluster[1],
                               wide_ms=graph_ms(wide, 1, iters=5),
                               cluster_ms=graph_ms(cl, 2, iters=5))
                    err, limit = forward_error(inputs, hs, None, dtype)
                    check(err <= limit, f"{name} wide at B={B}, T={T} disagrees with plain: {err}")
                    rows.append(row)
                    wins[(T, B)] = row["wide_ms"] < row["cluster_ms"]
                    log(f"    {name} {str(dtype)[6:]} T={T} B={B}: wide ({tile_label(tile)}) "
                        f"{row['wide_ms']:.4f} ms, cluster (C={cluster[1]}) "
                        f"{row['cluster_ms']:.4f} ms; the plan takes {natural}")
            least = min((B for B in WIDE_CROSSOVER_BATCHES
                         if all(wins[(T, b)] for T in WIDE_CROSSOVER_STEPS
                                for b in WIDE_CROSSOVER_BATCHES if b >= B)), default=None)
            log(f"    {name} {str(dtype)[6:]}: wide wins from B = {least} of the sweep on; "
                f"WIDE_MIN_BATCH = {ls.WIDE_MIN_BATCH[H][(dtype, chains)]}")
    return rows


# Phase 3j: the wide route of the LSTM backward (csrc/recurrence_wide_bwd.cuh) at H = 256, and
# at 384 on H = 300 zero-padded. Every tile (M, C) of each dtype at B = 37 (rows past B in
# the last tile), one and two chains; T = 1 under autograd through the public wrappers (at
# H = 300 on every tile, staged). Timed: DPTNet's recipe training
# shapes (B = 2 x 4 s) in f32 and the intra-chunk one in bf16, (label, (B, T, chains),
# dtype); then the crossover over B against the cluster backward that WIDE_MIN_BATCH_BWD
# encodes.
WIDE_BWD_CHECK = (37, 57)
WIDE_BWD_T1 = (80, 1)
WIDE_BWD_TIMED = [
    ("DPTNet train intra", (1278, 100, 2), torch.float32),
    ("DPTNet train inter", (200, 639, 2), torch.float32),
    ("DPTNet train causal inter", (200, 639, 1), torch.float32),
    ("DPTNet train intra", (1278, 100, 2), torch.bfloat16),
]
WIDE_BWD_CROSSOVER_BATCHES = (4, 16, 32, 64, 256)
WIDE_BWD_CROSSOVER_STEPS = (259, 639)


def phase_wide_bwd(card=None):
    """The wide backward against lstm_scan_bwd_reference: every tile each dtype admits and
    the card holds, one and two chains, on the path (counted), every launch repeated and
    checked; T = 1 under autograd through the public wrappers (check_backward). At
    WIDE_BWD_TIMED's shapes its plan tile timed whole and alone from CUDA graphs in turns
    with the FMA backward (FMA, wide, wide, FMA), beside the cluster backward forced, every
    tile, the serial floor (the product compiled out), the plain version, cuDNN's nn.LSTM
    backward (F = 64, DPTNet's input width) and the bounds; then the crossover over B against the
    cluster backward. -> {(name, dtype, label): timing, "crossover": rows}."""
    log("== phase 3j: the wide route of lstm_scan_bidir_bwd and lstm_scan_bwd vs plain on the "
        "card")
    card = card or card_line()
    result = {}
    for H, dtype in [(H, d) for H in (ls.WIDE_HIDDEN, WIDE_PADDED)
                     for d in (torch.float32, torch.bfloat16)]:
        width = ls.cluster_width(H)
        counts = ls._wide_counts(width, dtype, "cuda", backward=True)
        log(f"  clusters of the wide backward the card holds at once, H={width}, "
            f"{str(dtype)[6:]}, by tile (M, C): {counts}")
        tiles = [t for t in ls._wide_tiles(width, dtype, True) if counts[t] >= 1]
        check(tiles, f"the card holds no cluster of the wide backward in {dtype}: {counts}")
        for chains in (1, 2):
            name = "lstm_scan_bidir_bwd" if chains == 2 else "lstm_scan_bwd"
            for B, T in ((WIDE_BWD_CHECK,) if width == H else (WIDE_BWD_CHECK, WIDE_T1)):
                inputs = bwd_chains(B, T, H, chains, dtype, seed=B + T + chains)
                refs = [ls.lstm_scan_bwd_reference(*c) for c in inputs]
                for tile in tiles:
                    what = (f"{name} (B={B}, T={T}, H={H}) {str(dtype)[6:]} wide "
                            f"({tile_label(tile)}{f', padded to {width}' if width != H else ''})")
                    staged, launch = ls._staged_backward(inputs, "wide", tile=tile)
                    on_path(ls.BWD_PATH_LAUNCHES[name], name, launch, "wide")
                    errs = staged_bwd_errors(name, staged, inputs, refs, dtype)
                    worst = max(x / lim if lim else 0.0 for x, lim in errs)
                    for _ in range(REPEATS):  # a race shows only in some launches
                        launch()
                        worst = max(worst, max(
                            x / lim if lim else 0.0
                            for x, lim in staged_bwd_errors(name, staged, inputs, refs, dtype)))
                    log(f"  {what}: max|kernel-plain| / limit of d_xw, d_W_hh: "
                        + ", ".join(f"{x:.3e} / {lim:.3e}" for x, lim in errs)
                        + f"; worst of {1 + REPEATS} launches {worst:.3f} of its limit "
                        + ("ok" if worst <= 1 else "FAIL"))
                    check(worst <= 1, f"{what} disagrees with plain: {worst}")
            if width != H:  # the plan's routes at H = 300: phase 16
                continue
            B, T = WIDE_BWD_T1
            path = plan_bwd(ls, B, chains, H, dtype)[0]
            check(path == "wide", f"{name} at B={B} planned {path}, expected wide")
            inputs = lstm_chains(B, T, H, chains, dtype, seed=B + T + chains)
            hs, cs = ls._forward_cuda(inputs, with_cs=True)
            autograd_backward(f"(B={B}, T={T}, H={H}) {str(dtype)[6:]} through the wrapper",
                              inputs, hs, cs, timed=False)
    for label, (B, T, chains), dtype in WIDE_BWD_TIMED:
        name = "lstm_scan_bidir_bwd" if chains == 2 else "lstm_scan_bwd"
        result[(name, dtype, label)] = wide_bwd_timing(label, name, B, T, chains, dtype, card)
    result["crossover"] = wide_bwd_crossover(card)
    return result


def wide_bwd_timing(label, name, B, T, chains, dtype, card):
    """One WIDE_BWD_TIMED case: the wide backward on its plan tile checked once, then timed
    (graph_bwd_turns) beside the cluster backward forced, the serial floor and every tile
    the card holds, alone -> timing."""
    H = ls.WIDE_HIDDEN
    inputs = bwd_chains(B, T, H, chains, dtype, seed=B + T)
    path, tile = plan_bwd(ls, B, chains, H, dtype)
    what = f"{name} {label} (B={B}, T={T}, H={H}) {str(dtype)[6:]}"
    check(path == "wide", f"{what} planned {path}, expected wide")
    refs = [ls.lstm_scan_bwd_reference(*c) for c in inputs]
    staged, launch = ls._staged_backward(inputs)
    on_path(ls.BWD_PATH_LAUNCHES[name], name, launch, "wide")
    errs = staged_bwd_errors(name, staged, inputs, refs, dtype)
    log(f"  {what} wide ({tile_label(tile)}): max|kernel-plain| / limit of d_xw, d_W_hh: "
        + ", ".join(f"{x:.3e} / {lim:.3e}" for x, lim in errs))
    check(all(x <= lim for x, lim in errs), f"{what} disagrees with plain: {errs}")
    del staged, launch
    timing = graph_bwd_turns(inputs, "wide", tile,
                             lambda: [ls.lstm_scan_bwd_reference(*c) for c in inputs],
                             features=DPT_E)
    timing["max_abs_err"] = max(x for x, _ in errs)
    cluster = plan_bwd(ls, B, chains, H, dtype, "cluster")[1][1]
    timing["cluster_kernel_ms"] = graph_ms(ls._staged_backward(inputs, "cluster")[1],
                                           CLUSTER_REPEATS if B * chains <= 64 else 1)
    timing["floor_ms"] = graph_ms(ls._staged_bwd_floor(inputs, "wide", tile)[1], 1)
    counts = ls._wide_counts(H, dtype, "cuda", backward=True)
    timing["tiles_ms"] = {f"{m}x{c}": graph_ms(ls._staged_backward(inputs, "wide",
                                                                   tile=(m, c))[1], 1)
                          for m, c in ls._wide_tiles(H, dtype, True) if counts[(m, c)] >= 1}
    log("    every tile alone: " + ", ".join(f"(M, C) = ({k.replace('x', ', ')}) {v:.4f} ms"
                                             for k, v in timing["tiles_ms"].items()))
    products = 3 if dtype == torch.float32 else 2
    timing["kernel_bound_ms"] = backward_kernel_bound(B, T, H, 4, chains, dtype,
                                                      products)["bound_ms"]
    timing.update(recurrence_bound(B, T, H, 4, chains, backward=True, cell_state=True,
                                   dtype=dtype, tf32=products))
    log(f"    cluster backward (C={cluster}) alone {timing['cluster_kernel_ms']:.4f} ms; serial "
        f"floor {timing['floor_ms']:.4f} ms ({timing['floor_ms'] / T * 1e3:.3f} us a step "
        f"against {timing['kernel_ms'] / T * 1e3:.3f}); bound {timing['bound_ms']:.4f} ms "
        f"whole ({timing['bound_by']}), {timing['kernel_bound_ms']:.4f} ms the kernel "
        f"(CUDA graphs, CUDA events) [{card}]")
    return timing


def wide_bwd_crossover(card):
    """The wide backward (its forced plan tile) against the cluster backward (its forced
    plan cluster size) over WIDE_BWD_CROSSOVER_BATCHES, T in WIDE_BWD_CROSSOVER_STEPS, one
    and two chains, both dtypes, the kernels alone from CUDA graphs, each pair's das held to
    each other (both kernels are held to the plain version above) -> rows; the least B from
    which wide wins at every larger B of the sweep, per (dtype, chains), is what
    WIDE_MIN_BATCH_BWD encodes."""
    log(f"  the wide backward against the cluster backward over B (kernels from CUDA graphs, "
        f"medians of 5) [{card}]:")
    H = ls.WIDE_HIDDEN
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for chains in (1, 2):
            name = "lstm_scan_bidir_bwd" if chains == 2 else "lstm_scan_bwd"
            wins = {}
            for T in WIDE_BWD_CROSSOVER_STEPS:
                for B in WIDE_BWD_CROSSOVER_BATCHES:
                    inputs = bwd_chains(B, T, H, chains, dtype, seed=B + T + H)
                    natural = plan_bwd(ls, B, chains, H, dtype)[0]
                    tile = plan_bwd(ls, B, chains, H, dtype, "wide")[1]
                    cluster = plan_bwd(ls, B, chains, H, dtype, "cluster")[1]
                    staged, wide = ls._staged_backward(inputs, "wide", tile=tile)
                    cstaged, cl = ls._staged_backward(inputs, "cluster")
                    row = dict(name=name, dtype=str(dtype)[6:], B=B, T=T, plan=natural,
                               tile=list(tile), cluster=cluster[1],
                               wide_ms=graph_ms(wide, 1, iters=5),
                               cluster_ms=graph_ms(cl, 2, iters=5))
                    for a, b in zip(staged, cstaged):
                        err = float((a[5] - b[5]).abs().max())
                        limit = BWD_TOL * float(b[5].abs().max())
                        check(err <= limit, f"{name} {dtype} at B={B}, T={T}: the wide and "
                                            f"cluster backwards' das differ by {err} > {limit}")
                    rows.append(row)
                    wins[(T, B)] = row["wide_ms"] < row["cluster_ms"]
                    log(f"    {name} {str(dtype)[6:]} T={T} B={B}: wide ({tile_label(tile)}) "
                        f"{row['wide_ms']:.4f} ms, cluster (C={cluster[1]}) "
                        f"{row['cluster_ms']:.4f} ms; the plan takes {natural}")
                    del inputs, staged, cstaged, wide, cl
            least = min((B for B in WIDE_BWD_CROSSOVER_BATCHES
                         if all(wins[(T, b)] for T in WIDE_BWD_CROSSOVER_STEPS
                                for b in WIDE_BWD_CROSSOVER_BATCHES if b >= B)), default=None)
            log(f"    {name} {str(dtype)[6:]}: wide wins from B = {least} of the sweep on; "
                f"WIDE_MIN_BATCH_BWD = {ls.WIDE_MIN_BATCH_BWD[H][(dtype, chains)]}")
    return rows


def counts() -> dict:
    return {"fused_mask_decode": md.LAUNCHES, **ls.LAUNCHES, **gs.LAUNCHES, **q8.LAUNCHES}


# The served decodes, (path, dtype, N, C·L) as md.WIDTH_LAUNCHES counts them:
# Conv-TasNet's decoder (f32 generic, bf16 mma) and DPRNN-TasNet's (f32 rows,
# bf16 mma); phase 14's: LSTM-TasNet's (generic in both dtypes), SepFormer's and
# GALRNet's (f32 generic, bf16 mma); phase 15's: stereo Conv-TasNet's and Meta-TasNet's
# (f32 generic).
SERVED_DECODES = (("generic", "float32", 512, 16), ("mma", "bfloat16", 512, 16),
                  ("rows", "float32", 64, 2), ("mma", "bfloat16", 64, 2),
                  ("generic", "float32", 500, 40), ("generic", "bfloat16", 500, 40),
                  ("generic", "float32", 256, 16), ("mma", "bfloat16", 256, 16),
                  ("generic", "float32", 64, 16), ("mma", "bfloat16", 64, 16),
                  ("generic", "float32", 256, 40), ("generic", "float32", 440, 20))


def width_key(path, dtype, N, CL) -> str:
    return f"fused_mask_decode/{path}/{dtype}/N={N}/CL={CL}"


# The recurrence forwards, each counted by path too ("name/mma", "name/tf32x3", "name/fma"),
# and their backwards ("name/tf32x2", "name/tf32x3", "name/fma").
FORWARDS = ("lstm_scan", "lstm_scan_bidir", "gru_scan", "gru_scan_bidir")
BACKWARDS = tuple(f"{name}_bwd" for name in FORWARDS)
# The tensor-core path of each: (bf16, f32).
TENSOR_CORE_PATHS = {**{name: ("mma", "tf32x3") for name in FORWARDS},
                     **{name: ("tf32x2", "tf32x3") for name in BACKWARDS}}


def path_counts() -> dict:
    """The recurrences' launches by path ("name/path"), the LSTM's padded launches
    ("name/padded", a part of its "name/cluster") and the decodes' by path and width."""
    return {**{f"{name}/{path}": n for module in (ls, gs)
               for table in (module.PATH_LAUNCHES, module.BWD_PATH_LAUNCHES)
               for name, paths in table.items() for path, n in paths.items()},
            **{f"{name}/padded": n for name, n in ls.PADDED_LAUNCHES.items()},
            **{f"fused_mask_decode/{path}": n for path, n in md.PATH_LAUNCHES.items()},
            **{width_key(*width): md.WIDTH_LAUNCHES[width] for width in SERVED_DECODES}}


def all_counts() -> dict:
    """Every kernel's launches and the recurrence forwards' launches by path."""
    return {**counts(), **path_counts()}


def reset_counts() -> None:
    md.LAUNCHES = 0
    for path in md.PATH_LAUNCHES:
        md.PATH_LAUNCHES[path] = 0
    md.WIDTH_LAUNCHES.clear()
    for table in (ls.LAUNCHES, gs.LAUNCHES, q8.LAUNCHES, ls.PADDED_LAUNCHES):
        for name in table:
            table[name] = 0
    for module in (ls, gs):
        for table in (module.PATH_LAUNCHES, module.BWD_PATH_LAUNCHES):
            for paths in table.values():
                for path in paths:
                    paths[path] = 0


def grown(before: dict) -> dict:
    """all_counts() since `before`."""
    return {k: v - before[k] for k, v in all_counts().items()}


def kernels_of(launches: dict) -> dict:
    """The per-kernel counts of an all_counts() dict."""
    return {k: launches[k] for k in counts()}


def decode_path(tag: str, dtype) -> str:
    """The fused_mask_decode path of a served model's decode (ops/mask_decode.py:_plan):
    every bf16 decode on the tensor cores; in f32, Conv-TasNet's N=512, C·L=16 on the
    generic kernel and DPRNN-TasNet's N=64, C·L=2 on "rows"."""
    if dtype in ("bfloat16", torch.bfloat16):
        return "mma"
    return "generic" if "conv" in tag else "rows"


def check_paths(grew: dict, bf16: dict, what: str, decode: str | None = None) -> None:
    """A run's recurrence forwards and backwards by path: bf16[name] launches of each on
    its bf16 tensor-core path ("mma" forward, "tf32x2" backward), the rest of grew[name]
    (its f32 ones) on the 3xTF32 kernels ("tf32x3"), and none on the FMA kernels: every
    served and trained model has H = 128. With `decode`, every fused_mask_decode launch
    of the run on that path."""
    if decode is not None:
        n = grew["fused_mask_decode"]
        got = {p: grew[f"fused_mask_decode/{p}"] for p in md.PATH_LAUNCHES}
        check(got == {p: n * (p == decode) for p in got},
              f"{what}: fused_mask_decode launched {got} by path, expected {n} on {decode}")
    for name, (bf16_path, f32_path) in TENSOR_CORE_PATHS.items():
        want = (bf16.get(name, 0), grew[name] - bf16.get(name, 0), 0)
        got = (grew[f"{name}/{bf16_path}"], grew[f"{name}/{f32_path}"], grew[f"{name}/fma"])
        check(got == want, f"{what}: {name} launched ({bf16_path}, {f32_path}, fma) = {got}, "
                           f"expected {want}")


def all_bf16(grew: dict) -> dict:
    """check_paths' `bf16` for a run whose every recurrence forward and backward is bf16."""
    return {name: grew[name] for name in TENSOR_CORE_PATHS}


def nonzero(launches: dict) -> dict:
    """The kernels a count names, for the log."""
    return {k: v for k, v in launches.items() if v}


def expected(**per_request) -> dict:
    """Expected launches of one request: the kernels named, and none of the others."""
    return {name: per_request.get(name, 0) for name in counts()}


def stream_calls(n_samples, L, S, P):
    """Separator calls of one --streaming_hop request: (calls on whole latent hops,
    latent frames left for a final call).

    The CLI pads to the stride grid and feeds whole hops, each one call on the whole
    latent hops (P frames; P = 1 for Conv-TasNet) it completes, then finish(rest): one
    more call on its whole latent hops, if any.
    """
    hop = max(max(int(STREAMING_HOP * SAMPLE_RATE) // S, 1) * S, L)
    total = n_samples + (S - (n_samples - L) % S) % S
    calls = pending = 0
    for _ in range(total // hop):
        frames = (pending + hop - L) // S + 1
        calls, pending = calls + 1, pending + hop - frames // P * P * S
    buf = pending + total % hop
    frames = (buf - L) // S + 1 if buf >= L else 0
    return calls + (frames >= P), frames % P


def stream_launches(n_samples, bidir, blocks=DPRNN["sep_num_blocks"], L=DPRNN["kernel_size"],
                    S=DPRNN["stride"], P=DPRNN["sep_hop_size"]):
    """Launches of one --streaming_hop request of the stream-safe DPRNN-TasNet: each call
    that runs the dual-path stack launches one bidirectional kernel per block (the
    intra-chunk RNN; the carried inter-chunk RNN is a plain step loop), and every
    separator call decodes once. The final call, which empties the latent delay line,
    always decodes, and runs the stack on a partial hop only."""
    calls, left = stream_calls(n_samples, L, S, P)
    return expected(fused_mask_decode=calls + 1, **{bidir: blocks * (calls + (left > 0))})


def conv_stream_launches(n_samples, L=PAPER["kernel_size"], S=PAPER["stride"]):
    """Launches of one --streaming_hop request of causal Conv-TasNet: one decode per
    separator call, and no final call (no latent delay)."""
    return expected(fused_mask_decode=stream_calls(n_samples, L, S, 1)[0])


def scramble_norms(model):
    # Non-identity norm affines, so the norms (and the Conv-TasNet CLI's fold) do real work.
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(torch.from_numpy(0.5 + rng.random(p.shape, np.float32)))
            elif name.endswith(".beta"):
                p.copy_(torch.from_numpy(0.1 * rng.standard_normal(p.shape).astype(np.float32)))
    return model


def make_checkpoint(path, model):
    save_model(path, scramble_norms(model))


def write_mixtures(tmp):
    rng = np.random.default_rng(0)
    wavs = []
    for seconds in (1.0, 2.5, 4.0):
        path = os.path.join(tmp, f"mix_{seconds}s.wav")
        write_wav(path, 0.1 * rng.standard_normal(int(seconds * SAMPLE_RATE)), SAMPLE_RATE)
        wavs.append(path)
    return wavs


def separate(argv):
    """cli/separate.py's main, its progress line kept off the log."""
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(argv)


def serve(tag, ckpt, wavs, per_request, flags=()):
    """Six requests (three mixtures x f32/bf16) through cli/separate.py.

    Every launch count is set to 0 first; each request must add exactly
    `per_request` launches (a dict, or a function of the request's number of
    samples). Returns the outputs and the path's counts.
    """
    tmp = os.path.dirname(ckpt)
    outputs = {}
    reset_counts()
    for dtype in ("float32", "bfloat16"):
        for wav in wavs:
            before = all_counts()
            out_dir = os.path.join(tmp, f"out_{tag}_{dtype}_{os.path.basename(wav)[:-4]}")
            est = separate(["--model_path", ckpt, "--input", wav, "--out_dir", out_dir,
                            "--device", "cuda", "--dtype", dtype, *flags])
            grew_all = grown(before)
            grew = kernels_of(grew_all)
            n_in = read_wav(wav)[0].shape[0]
            want = per_request(n_in) if callable(per_request) else per_request
            files = sorted(os.listdir(out_dir))
            check(files == ["source0.wav", "source1.wav"], files)
            for f in files:
                sig, sr = read_wav(os.path.join(out_dir, f))
                check(sr == SAMPLE_RATE and sig.shape == (n_in,) and np.isfinite(sig).all(),
                      (f, sig.shape, n_in))
            check(est.shape == (2, n_in) and np.isfinite(est).all(), est.shape)
            check(grew == want, f"request {wav} ({dtype}) launched {grew}, expected {want}")
            check_paths(grew_all, all_bf16(grew_all) if dtype == "bfloat16" else {},
                        f"request {wav} ({dtype})", decode_path(tag, dtype))
            log(f"  {dtype} {os.path.basename(wav)}: 2 sources x {n_in} samples, "
                f"kernel launches {nonzero(grew_all)}")
            outputs[(dtype, wav)] = est
    launches = all_counts()
    log(f"  main-path kernel launches: {nonzero(launches)}")
    return outputs, launches


def phase_parity(tag, ckpt, wavs, outputs, flags=()):
    log(f"== phase 5: card vs CPU, bf16 vs f32 ({tag})")
    wav = wavs[0]
    ref = separate(["--model_path", ckpt, "--input", wav, "--out_dir",
                    os.path.join(os.path.dirname(ckpt), f"out_{tag}_cpu"), "--device", "cpu",
                    *flags])
    card = outputs[("float32", wav)]
    err = float(np.abs(card - ref).max())
    scale = float(np.abs(ref).max())
    log(f"  f32 card vs CPU (1 s): max abs err {err:.3e}, max|ref| {scale:.3e}, "
        f"limit {1e-3 * scale:.3e}")
    if not err <= 1e-3 * scale:
        raise AssertionError(f"card output disagrees with CPU: {err} > 1e-3 x {scale}")
    for w in wavs:
        f32, bf16 = outputs[("float32", w)], outputs[("bfloat16", w)]
        snr = 10 * np.log10(np.sum(f32 ** 2) / np.sum((bf16 - f32) ** 2))
        log(f"  bf16 vs f32 on the card, {os.path.basename(w)}: SNR {snr:.2f} dB "
            f"(limit {SNR_LIMIT_DB:g})")
        if not snr >= SNR_LIMIT_DB:
            raise AssertionError(f"bf16 output SNR {snr:.2f} dB < {SNR_LIMIT_DB} dB")
    return err


def cli_latency(ckpt, wav, what, card, flags=()):
    tmp = os.path.dirname(ckpt)
    lat = []
    for _ in range(LATENCY_RUNS):
        start = time.perf_counter()
        separate(["--model_path", ckpt, "--input", wav, "--out_dir",
                  os.path.join(tmp, "out_latency"), "--device", "cuda", "--dtype", "bfloat16",
                  *flags])
        lat.append(time.perf_counter() - start)
    log(f"  CLI request latency, 4 s mixture, bf16 ({what}): "
        f"median {np.median(lat) * 1e3:.1f} ms of {[round(v * 1e3, 1) for v in lat]} [{card}]")


def forward_throughput(model, what, card, warmup, iters, dtype=torch.bfloat16, tag=None):
    """The B=8 x 4 s forward of `model` (already in `dtype`); its recurrence forwards
    must take the dtype's tensor-core path, its decode decode_path(tag, dtype)."""
    B, T = 8, 4 * SAMPLE_RATE
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 1, T), dtype=np.float32))
    x = x.to("cuda", dtype)
    torch.cuda.reset_peak_memory_stats()
    before = all_counts()
    with torch.inference_mode():
        ms = median_ms(lambda: model(x), warmup=warmup, iters=iters)
    grew = grown(before)
    check_paths(grew, all_bf16(grew) if dtype == torch.bfloat16 else {}, f"{what} forward",
                decode_path(tag or what, dtype))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"  B=8 x 4 s {str(dtype)[6:]} {what} forward: {ms:.3f} ms, "
        f"{B * 4.0 / (ms / 1e3):.1f} audio-s/s, peak {peak:.1f} MiB [{card}]")


def phase_throughput(ckpt, wavs, card):
    log("== phase 6: throughput (informational), Conv-TasNet")
    model = load_model(ckpt, device="cuda")
    model = fold_for_serving(model)
    forward_throughput(model.to(torch.bfloat16), "heads-fold", card, warmup=3, iters=20,
                       tag="conv_tasnet")
    cli_latency(ckpt, wavs[-1], "load + fold + forward + write", card)


def phase_throughput_dprnn(tag, ckpt, wavs, card):
    log(f"== phase 6: throughput (informational), {tag}")
    model = load_model(ckpt, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):  # .to converts the model in place
        forward_throughput(model.to(dtype), tag, card, warmup=2, iters=5, dtype=dtype)
    cli_latency(ckpt, wavs[-1], "load + forward + write", card)


def phase_stream_offline(tag, ckpt, wavs, outputs, phase="4d"):
    """The f32 streamed output against the offline (stream-safe) forward, both on the card."""
    log(f"== phase {phase}: streamed vs offline on the card ({tag})")
    for wav in wavs:
        ref = separate(["--model_path", ckpt, "--input", wav, "--out_dir",
                        os.path.join(os.path.dirname(ckpt), f"out_{tag}_offline"),
                        "--device", "cuda"])
        got = outputs[("float32", wav)]
        err = float(np.abs(got - ref).max())
        scale = float(np.abs(ref).max())
        log(f"  {os.path.basename(wav)}: max|streamed - offline| {err:.3e}, max|offline| "
            f"{scale:.3e}, limit {STREAM_TOL * scale:.3e}")
        if not err <= STREAM_TOL * scale:
            raise AssertionError(f"streamed output disagrees with offline: {err} > "
                                 f"{STREAM_TOL} x {scale}")


def stream_hop_times(ckpt, wav, dtype, card):
    """ms per hop of the first STREAM_TIMED_HOPS hops of a 4 s stream, each hop ended by a
    synchronize, as a server would."""
    model = load_model(ckpt, device="cuda").to(dtype)
    x = read_wav(wav)[0].astype(np.float32)
    hop = int(STREAMING_HOP * SAMPLE_RATE)
    stream = ExactStreamingSeparator(model, hop_samples=hop)
    for lo in range(0, 4 * hop, hop):  # warm-up: a short stream, then a fresh one
        stream.process(x[lo:lo + hop])
    stream.reset()
    times = []
    for lo in range(0, min(len(x) // hop, STREAM_TIMED_HOPS) * hop, hop):
        start = time.perf_counter()
        stream.process(x[lo:lo + hop]).cpu()
        times.append((time.perf_counter() - start) * 1e3)
    ms, p90 = float(np.median(times)), float(np.percentile(times, 90))
    log(f"  {str(dtype)[6:]}: {len(times)} hops of {STREAMING_HOP * 1e3:g} ms audio: median "
        f"{ms:.3f} ms, p90 {p90:.3f} ms, max {max(times):.3f} ms per hop, real-time factor "
        f"{ms / (STREAMING_HOP * 1e3):.4f} [{card}]")


def phase_stream_hops():
    """Phase 6's ms per hop of the stream-safe causal DPRNN-TasNet alone, LSTM and GRU
    (`--only 6s`: the streaming metric of two trees compared in one call)."""
    log("== phase 6s: streaming ms per hop (informational)")
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        wav = write_mixtures(tmp)[-1]
        for rnn in ("lstm", "gru"):
            ckpt = os.path.join(tmp, f"{rnn}.pth")
            make_checkpoint(ckpt, DPRNNTasNet(**dict(DPRNN, rnn_type=rnn), causal=True,
                                              stream_safe=True, device="cuda",
                                              generator=torch.Generator().manual_seed(0)))
            log(f"  {rnn}:")
            for dtype in (torch.bfloat16, torch.float32):
                stream_hop_times(ckpt, wav, dtype, card)


def write_long_mixture(tmp):
    path = os.path.join(tmp, f"mix_{LONGFORM_SECONDS:g}s.wav")
    rng = np.random.default_rng(30)
    write_wav(path, 0.1 * rng.standard_normal(int(LONGFORM_SECONDS * SAMPLE_RATE)), SAMPLE_RATE)
    return path


def phase_longform(conv_ckpt, wav):
    """A 30 s mixture through --chunk_duration 4: one decode per bucketed chunk."""
    log(f"== phase 4g: long-form paper-config Conv-TasNet, {LONGFORM_SECONDS:g} s through "
        f"cli/separate.py --chunk_duration {CHUNK_DURATION:g}")
    n, chunk = int(LONGFORM_SECONDS * SAMPLE_RATE), int(CHUNK_DURATION * SAMPLE_RATE)
    real, bucketed = chunk_count(n, chunk, bucket=False), chunk_count(n, chunk)
    check((real, bucketed) == (14, 16), f"{n} samples in {chunk}-sample chunks: {real}, "
                                        f"bucketed {bucketed}; expected 14 and 16")
    log(f"  {real} real chunks of {chunk} samples at a hop of {chunk // 2}, bucketed to "
        f"{bucketed}")
    return serve("conv_tasnet_longform", conv_ckpt, [wav],
                 lambda n: expected(fused_mask_decode=chunk_count(n, chunk)),
                 flags=["--chunk_duration", str(CHUNK_DURATION)])


def phase_throughput_longform(ckpt, wav, card):
    """Long-form wall time per audio-second: the folded model (as the CLI serves it) over
    the 30 s mixture, ended by a host copy; median of 3 after one warm-up."""
    log("== phase 6: long-form (informational), paper-config Conv-TasNet")
    x = torch.from_numpy(read_wav(wav)[0].astype(np.float32))[None, None]
    chunk = int(CHUNK_DURATION * SAMPLE_RATE)
    model = load_model(ckpt, device="cuda")
    model = fold_for_serving(model)
    for dtype in (torch.float32, torch.bfloat16):  # .to converts the model in place
        model = model.to(dtype)
        mixture = x.to("cuda", dtype)
        times = []
        with torch.inference_mode():
            for _ in range(4):
                start = time.perf_counter()
                separate_longform(model, mixture, chunk, 2).cpu()
                times.append(time.perf_counter() - start)
        ms = float(np.median(times[1:])) * 1e3
        log(f"  {str(dtype)[6:]}: {LONGFORM_SECONDS:g} s in {chunk_count(x.shape[-1], chunk)} "
            f"chunks: {ms:.3f} ms, {ms / LONGFORM_SECONDS:.3f} ms per audio-second "
            f"(median of 3) [{card}]")


def phase_bench():
    """`python -m dnn_based_source_separation_torch.bench` as a user runs it (a process of
    its own), then its streaming line in this process."""
    log("== phase 6: the bench module (informational)")
    proc = subprocess.run([sys.executable, "-m", "dnn_based_source_separation_torch.bench"],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"bench failed: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(line["value"] > 0, line)
    log(f"  bench (default): {json.dumps(line)}")
    flags = ["--streaming_hop", str(STREAMING_HOP), "--causal"]
    with contextlib.redirect_stdout(io.StringIO()):
        line = bench_main(flags)
    check(line["value"] > 0, line)
    log(f"  bench {' '.join(flags)}: {json.dumps(line)}")


def phase_throughput_stream(tag, ckpt, wavs, card):
    log(f"== phase 6: streaming (informational), {tag}")
    for dtype in (torch.bfloat16, torch.float32):
        stream_hop_times(ckpt, wavs[-1], dtype, card)
    cli_latency(ckpt, wavs[-1], "load + stream + write", card,
                flags=["--streaming_hop", str(STREAMING_HOP)])


# Training: the models the train CLI builds, at the recipe's widths.
TRAIN_MODELS = {
    "dprnn_tasnet": (DPRNNTasNet, dict(DPRNN, causal=False)),
    "dprnn_tasnet_causal": (DPRNNTasNet, dict(DPRNN, causal=True)),
    "dprnn_tasnet_gru": (DPRNNTasNet, dict(DPRNN, causal=False, rnn_type="gru")),
    "dprnn_tasnet_gru_causal": (DPRNNTasNet, dict(DPRNN, causal=True, rnn_type="gru")),
    "conv_tasnet": (ConvTasNet, PAPER),
}
GRAD_TOL_L2 = 1e-3  # card vs the f64 CPU step: relative L2 of the whole gradient
GRAD_TOL_TENSOR = 5e-2  # card vs the f64 CPU step, each tensor, relative to its max|g|
LOSS_TOL = 1e-4  # card vs the f64 CPU step, relative
FIXED_BATCH_STEPS = 6  # phase 8: a fixed batch's loss must fall over these steps
# The recipes' flags (egs/wsj0-mix/dprnn-tasnet/train.sh:22; the Conv-TasNet
# defaults of cli/train_wsj0mix.py are the paper config).
CLI_RECIPES = {
    "dprnn_tasnet": ["--model", "dprnn-tasnet", "-N", "64", "-L", "2", "-K", "250",
                     "--sep_hop_size", "125", "--sep_num_blocks", "6",
                     "--sep_bottleneck_channels", "64", "--sep_hidden_channels", "128",
                     "--batch_size", "2"],
    "conv_tasnet": ["--model", "conv-tasnet", "--batch_size", "4"],
}


def train_step_launches(tag: str) -> dict:
    """Launches of one train step: each recurrence forward and backward once per layer,
    and no decode kernel (training decodes with the plain version)."""
    blocks = DPRNN["sep_num_blocks"]
    if tag.startswith("conv"):
        return expected()
    rnn = "gru" if "_gru" in tag else "lstm"
    if tag.endswith("causal"):
        return expected(**{f"{rnn}_scan_bidir": blocks, f"{rnn}_scan": blocks,
                           f"{rnn}_scan_bidir_bwd": blocks, f"{rnn}_scan_bwd": blocks})
    return expected(**{f"{rnn}_scan_bidir": 2 * blocks, f"{rnn}_scan_bidir_bwd": 2 * blocks})


def eval_launches(tag: str) -> dict:
    """Launches of one validation (or served, or evaluated) forward: the serving kernels."""
    blocks = DPRNN["sep_num_blocks"]
    if tag.startswith("conv"):
        return expected(fused_mask_decode=1)
    rnn = "gru" if "_gru" in tag else "lstm"
    causal = tag.endswith("causal")
    return expected(fused_mask_decode=1, **{f"{rnn}_scan_bidir": blocks * (2 - causal),
                                            f"{rnn}_scan": blocks * causal})


def train_batch(B, seconds, device, seed=7):
    """Two sources of noise and their sum, (B, 1, T) and (B, 2, T), from a seed."""
    rng = np.random.default_rng(seed)
    sources = 0.1 * rng.standard_normal((B, 2, int(seconds * SAMPLE_RATE)), dtype=np.float32)
    mixture = sources.sum(axis=1, keepdims=True)
    return torch.from_numpy(mixture).to(device), torch.from_numpy(sources).to(device)


def grads_of_step(model, batch):
    """One make_train_step with SGD at lr 0 (the weights stay; the gradients stay in .grad)."""
    step = make_train_step(model, PIT1d(NegSISDR(), n_sources=2),
                           make_optimizer("sgd", 0.0, params=model.parameters()))
    loss = float(step(*batch))
    return loss, {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def phase_train_parity():
    """One train step on the card against the same step on the CPU.

    Both f32 steps are held against an f64 step on the CPU. The randomly
    initialised paper-config Conv-TasNet (24 blocks, each ending in a
    scale-invariant gLN) is ill-conditioned in its backward: a PReLU slope or
    a bottleneck gradient comes out of f32 up to about 1e-2 off the f64 one in
    either implementation (the CPU's worst tensor read 8.8e-03 of its max|g|,
    and per-layer output gradients reach 2e-2 on both devices, at different
    layers). So the whole gradient vector must be within GRAD_TOL_L2 (relative
    L2) of the f64 one, or no further than 10x the CPU's f32 gradient is, and
    each tensor within GRAD_TOL_TENSOR x its max|g|: a missing or wrong
    backward is off by O(1).
    """
    log("== phase 7: one train step, card vs CPU (f32, TF32 off, B=1 x 0.125 s; f64 CPU "
        "reference)")
    for tag, (cls, cfg) in TRAIN_MODELS.items():
        def make(device):
            return scramble_norms(cls(**cfg, generator=torch.Generator().manual_seed(0),
                                      device=device))
        cpu_model = make("cpu")
        batch = train_batch(1, 0.125, "cpu")
        ref_loss, ref_grads = grads_of_step(copy.deepcopy(cpu_model).double(),
                                            tuple(t.double() for t in batch))
        cpu_loss, cpu_grads = grads_of_step(cpu_model, batch)
        reset_counts()
        card_loss, card_grads = grads_of_step(make("cuda"), train_batch(1, 0.125, "cuda"))
        torch.cuda.synchronize()
        launched = counts()
        check(launched == train_step_launches(tag),
              f"{tag}: a train step launched {launched}, expected {train_step_launches(tag)}")
        check_paths(all_counts(), {}, f"{tag}: an f32 train step")
        check_step_against_f64(tag, (ref_loss, ref_grads), (cpu_loss, cpu_grads),
                               (card_loss, card_grads), launched)


def check_step_against_f64(tag, ref, cpu, card, launched, null_floor=0.0):
    """A card train step's (loss, gradients) against an f64 CPU step's, beside the f32 CPU
    step's: the loss within LOSS_TOL relative (or 10x the CPU's error), the whole gradient
    within GRAD_TOL_L2 relative L2 (or 10x the CPU's), each tensor within GRAD_TOL_TENSOR x
    its max|g|, and none all zero on the card. `null_floor`: a tensor's max|g| is taken as
    at least null_floor x the largest of all (a gradient that is 0 but for rounding)."""
    (ref_loss, ref_grads), (cpu_loss, cpu_grads), (card_loss, card_grads) = ref, cpu, card
    zero = [n for n, g in card_grads.items() if g is None or not bool(g.abs().max() > 0)]
    if zero:
        raise AssertionError(f"{tag}: gradients all zero or missing on the card: {zero}")
    top = max(float(g.abs().max()) for g in ref_grads.values())
    card_sq = cpu_sq = ref_sq = 0.0
    rows = []
    for n, ref in ref_grads.items():
        card_d = card_grads[n].cpu().double() - ref
        cpu_d = cpu_grads[n].double() - ref
        card_sq += float(card_d.square().sum())
        cpu_sq += float(cpu_d.square().sum())
        ref_sq += float(ref.square().sum())
        scale = max(float(ref.abs().max()), null_floor * top) or 1.0
        rows.append((float(card_d.abs().max()) / scale, float(cpu_d.abs().max()) / scale, n))
    rows.sort(reverse=True)
    card_l2, cpu_l2 = (card_sq / ref_sq) ** 0.5, (cpu_sq / ref_sq) ** 0.5
    l2_limit = max(GRAD_TOL_L2, 10 * cpu_l2)
    loss_limit = max(LOSS_TOL * abs(ref_loss), 10 * abs(cpu_loss - ref_loss))
    log(f"  {tag}: loss card {card_loss:.6f}, CPU f32 {cpu_loss:.6f}, f64 {ref_loss:.6f} "
        f"(card err {abs(card_loss - ref_loss):.2e}, limit {loss_limit:.2e}); "
        f"{len(ref_grads)} gradients, none all zero on the card; whole-gradient relative "
        f"L2 vs f64: card {card_l2:.2e}, CPU f32 {cpu_l2:.2e} (limit {l2_limit:.2e}); "
        f"launches per step {nonzero(launched)}")
    for card_rel, cpu_rel, n in rows[:3]:
        log(f"    {n}: max|card-f64| / max|g| {card_rel:.2e}, CPU f32 {cpu_rel:.2e} "
            f"(limit {GRAD_TOL_TENSOR:g})")
    if not (abs(card_loss - ref_loss) <= loss_limit and card_l2 <= l2_limit
            and rows[0][0] <= GRAD_TOL_TENSOR):
        raise AssertionError(f"{tag}: card train step disagrees with CPU")


def train_through_cli(argv, launches=None):
    """train_wsj0mix.main in-process; with `launches`, check the run's kernel launches
    against its steps and validation forwards."""
    before = all_counts()
    trainer = train_cli.main(argv)
    grew_all = grown(before)
    grew = kernels_of(grew_all)
    losses = trainer.train_loss + trainer.valid_loss
    check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    if launches is not None:
        epochs = len(trainer.train_loss) - trainer.start_epoch
        steps, evals = epochs * len(trainer.train_loader), epochs * len(trainer.valid_loader)
        per_step, per_eval = train_step_launches(launches), eval_launches(launches)
        want = {k: steps * per_step[k] + evals * per_eval[k] for k in grew}
        check(grew == want, f"{argv[-1]}: launched {grew}, expected {want} for {steps} "
                            f"steps and {evals} validation forwards")
        # Mixed precision: the steps' forwards and backwards run on bf16 copies
        # ("mma", "tf32x2"), the validation forwards on the f32 weights ("tf32x3").
        mixed = "--mixed_precision" in argv
        check_paths(grew_all, {k: steps * per_step[k] for k in TENSOR_CORE_PATHS} if mixed
                    else {}, argv[-1], decode_path(launches, "float32"))
    model_dir = os.path.join(trainer.config.exp_dir, "model")
    check(sorted(os.listdir(model_dir)) == ["best.ckpt", "last.ckpt"], os.listdir(model_dir))
    stats = trainer.last_epoch_stats or {}
    log(f"  {argv[argv.index('--model') + 1]}{' gru' if 'gru' in argv else ''} "
        f"{'bf16' if '--mixed_precision' in argv else 'f32'}"
        f"{' causal' if '--causal' in argv else ''}: epochs {trainer.start_epoch + 1}-"
        f"{len(trainer.train_loss)}, train loss {[round(v, 4) for v in trainer.train_loss]}, "
        f"valid loss {[round(v, 4) for v in trainer.valid_loss]}, "
        f"{stats.get('audio_sec_per_sec', 0):.1f} audio-s/s, "
        f"p50 {stats.get('iter_p50_ms', 0):.1f} ms, launches {nonzero(grew_all)}")
    return trainer


def phase_train_cli(tmp, card):
    """Train through the CLI on a synthetic wsj0-style corpus; resume; serve the result."""
    log("== phase 8: train through cli/train_wsj0mix.py")
    corpus = os.path.join(tmp, "corpus")
    tr_root, tr_list = write_quality_corpus(corpus, "tr", 3)
    cv_root, cv_list = write_quality_corpus(corpus, "cv", 1)
    data = ["--train_wav_root", tr_root, "--train_list_path", tr_list, "--valid_wav_root",
            cv_root, "--valid_list_path", cv_list, "--duration", "4", "--valid_duration", "4",
            "--device", "cuda"]
    exp = os.path.join(tmp, "exp_dprnn")
    # The entry point itself, as a user runs it, in a process of its own.
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "dnn_based_source_separation_torch.cli.train_wsj0mix", *data,
         *CLI_RECIPES["dprnn_tasnet"], "--epochs", "2", "--exp_dir", exp],
        cwd=root, env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True,
        timeout=600)
    log("  python -m ...cli.train_wsj0mix (DPRNN-TasNet, 2 epochs):\n    "
        + "\n    ".join(proc.stdout.strip().splitlines()[-6:]))
    if proc.returncode != 0:
        raise AssertionError(f"the train CLI failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    first = proc.stdout.splitlines()[0] if proc.stdout else ""
    log(f"  its first line: {first}")
    check(first == f"device cuda; {TF32_OFF}", f"the train CLI's first line is not the TF32 "
                                               f"line: {first!r}")
    last = os.path.join(exp, "model", "last.ckpt")
    check(os.path.exists(os.path.join(exp, "model", "best.ckpt")) and os.path.exists(last),
          os.listdir(os.path.join(exp, "model")))

    reset_counts()  # the training path, in-process from here on
    resumed = train_through_cli([*data, *CLI_RECIPES["dprnn_tasnet"], "--epochs", "3",
                                 "--continue_from", last, "--exp_dir", exp], "dprnn_tasnet")
    check(resumed.start_epoch == 2 and len(resumed.train_loss) == 3,
          (resumed.start_epoch, resumed.train_loss))
    trainers = {"dprnn_tasnet": resumed}
    gru = ["--rnn_type", "gru"]
    for tag, flags in (("dprnn_tasnet_causal", ["--causal", "1"]),
                       ("dprnn_tasnet", ["--mixed_precision", "1"]),
                       ("dprnn_tasnet_causal", ["--causal", "1", "--mixed_precision", "1"]),
                       ("dprnn_tasnet_gru", gru),
                       ("dprnn_tasnet_gru", [*gru, "--mixed_precision", "1"]),
                       ("dprnn_tasnet_gru_causal", [*gru, "--causal", "1"]),
                       ("dprnn_tasnet_gru_causal", [*gru, "--causal", "1",
                                                    "--mixed_precision", "1"]),
                       ("conv_tasnet", [])):
        recipe = CLI_RECIPES["conv_tasnet" if tag.startswith("conv") else "dprnn_tasnet"]
        out = os.path.join(tmp, f"exp_{tag}_{'_'.join(flags).replace('-', '')}")
        trainer = train_through_cli([*data, *recipe, *flags, "--epochs", "1", "--exp_dir", out],
                                    tag)
        trainers.setdefault(tag, trainer)  # the f32 one of each model for the checks below

    # Per step and per validation forward, then a fixed batch trained for FIXED_BATCH_STEPS.
    for tag, trainer in trainers.items():
        batch = train_batch(2 if tag.startswith("dprnn") else 4, 4.0, "cuda", seed=11)
        before = all_counts()
        losses = [float(trainer.train_step(*batch))]
        step_all = grown(before)
        before = all_counts()
        trainer.eval_step(*batch)
        eval_all = grown(before)
        step_launches, eval_grew = kernels_of(step_all), kernels_of(eval_all)
        check(step_launches == train_step_launches(tag) and eval_grew == eval_launches(tag),
              f"{tag}: step launched {step_launches}, eval {eval_grew}")
        check_paths(step_all, {}, f"{tag}: an f32 train step")
        check_paths(eval_all, {}, f"{tag}: an f32 validation forward",
                    decode_path(tag, "float32"))
        losses += [float(trainer.train_step(*batch)) for _ in range(FIXED_BATCH_STEPS - 1)]
        log(f"  {tag}: one train step launched {nonzero(step_launches)}; one validation "
            f"forward {nonzero(eval_grew)}; a fixed batch over {FIXED_BATCH_STEPS} steps: loss "
            f"{losses[0]:.4f} "
            f"-> {losses[-1]:.4f}")
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{tag}: {FIXED_BATCH_STEPS} steps on one batch did not lower its loss: "
              f"{losses}")
    launches = all_counts()
    log(f"  training-path kernel launches: {nonzero(launches)}")

    wavs = write_mixtures(tmp)
    for tag, trainer in (("dprnn_tasnet", resumed), ("conv_tasnet", trainers["conv_tasnet"])):
        ckpt = os.path.join(trainer.config.exp_dir, "model", "last.ckpt")
        log(f"  serve the trained {tag} checkpoint through cli/separate.py")
        _, served = serve(f"trained_{tag}", ckpt, wavs[:1], eval_launches(tag))
        launches = {k: v + served[k] for k, v in launches.items()}
    checkpoints = {tag: os.path.join(trainers[tag].config.exp_dir, "model", "last.ckpt")
                   for tag in ("conv_tasnet", "dprnn_tasnet", "dprnn_tasnet_gru")}
    return launches, checkpoints


def timed_train_steps(cls, cfg, B, compute_dtype, card, what, warmup=3, iters=5):
    model = scramble_norms(cls(**cfg, generator=torch.Generator().manual_seed(0), device="cuda"))
    step = make_train_step(model, PIT1d(NegSISDR(), n_sources=2),
                           make_optimizer("adam", 1e-3, 5.0, params=model.parameters()),
                           compute_dtype)
    batch = train_batch(B, 4.0, "cuda")
    times = []
    torch.cuda.reset_peak_memory_stats()
    before = all_counts()
    for i in range(warmup + iters):
        start = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(time.perf_counter() - start)
    grew = grown(before)
    check_paths(grew, all_bf16(grew) if compute_dtype == torch.bfloat16 else {}, what)
    p50 = float(np.median(times))
    log(f"  {what}, B={B} x 4 s: p50 step {p50 * 1e3:.3f} ms of {iters} (min "
        f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), {B * 4.0 / p50:.1f} audio-s/s, "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB [{card}]")
    return model


BACKWARD_KERNELS = ("lstm_bwd_kernel", "gru_bwd_kernel", "bwd_tf32_kernel", "bwd_cluster_kernel",
                    "bwd_wide_kernel")
FORWARD_KERNELS = ("lstm_kernel", "gru_kernel", "scan_mma_kernel", "scan_tf32_kernel",
                   "scan_cluster_kernel", "scan_wide_kernel")


def evented_step(loss_of, optimizer):
    """A train step on `loss_of()` that records events[0..3]: before the forward, after
    the loss, after the backward and after the optimizer."""
    def step(events):
        events[0].record()
        optimizer.zero_grad()
        loss = loss_of()
        events[1].record()
        loss.backward()
        events[2].record()
        optimizer.step()
        events[3].record()
    return step


def timed_steps(loss_of, optimizer, iters=2):
    """1 + iters steps: (p50 of the timed ones on the host clock, the forward / backward /
    optimizer split of their median, CUDA events)."""
    step = evented_step(loss_of, optimizer)
    splits, walls = [], []
    for i in range(1 + iters):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        start = time.perf_counter()
        step(events)
        torch.cuda.synchronize()
        if i:
            walls.append((time.perf_counter() - start) * 1e3)
            splits.append([events[j].elapsed_time(events[j + 1]) for j in range(3)])
    return float(np.median(walls)), [float(np.median([s[j] for s in splits]))
                                     for j in range(3)]


def fitting_step(tag, optimizer, batch_of, loss_of, B, seconds, iters=2):
    """timed_steps at batch B or, where that runs out of device memory, at the largest
    power-of-two batch below it that fits (the widths kept): batch_of(B) makes the batch,
    loss_of(batch) the loss. -> (B, p50 ms, [forward, backward, optimizer] ms, peak MiB)."""
    while True:
        try:
            batch = batch_of(B)
            torch.cuda.reset_peak_memory_stats()
            p50, split = timed_steps(lambda: loss_of(batch), optimizer, iters)
            break
        except torch.cuda.OutOfMemoryError:
            pass  # freed below, once the exception (and the frames it holds) is gone
        batch = None
        optimizer.zero_grad()
        torch.cuda.empty_cache()
        check(B > 1, f"{tag}: one {seconds:g} s example does not fit the card")
        log(f"  {tag}: the recipe step at B={B} x {seconds:g} s ran out of device memory "
            f"({torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB allocated at the peak); "
            f"B={B // 2}")
        B //= 2
    return B, p50, split, torch.cuda.max_memory_allocated() / 2 ** 20


def device_times(prof) -> dict:
    """A torch.profiler run's device time by kernel name, ms."""
    from torch.autograd import DeviceType

    times = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    check(times, "the profiler recorded no device time")
    return times


def profile_train_step(loss_of, optimizer, what, card, check_backward):
    """One train step split by CUDA events into forward, backward and optimizer, with the
    device time of the recurrence kernels (FORWARD_KERNELS, BACKWARD_KERNELS) and the
    device's idle share from torch.profiler; then the backward alone profiled, its
    launches held by `check_backward(grown counts)`, and the ten longest device ops of
    the rest of it by name. -> the profiled step's numbers."""
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    step = evented_step(loss_of, optimizer)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    step(events)
    torch.cuda.synchronize()
    before = all_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step(events)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    grew = grown(before)
    fwd, bwd, opt = (events[i].elapsed_time(events[i + 1]) for i in range(3))
    device = device_times(prof)
    busy = sum(device.values())
    bwd_kernel = sum(t for k, t in device.items() if any(n in k for n in BACKWARD_KERNELS))
    fwd_kernel = sum(t for k, t in device.items() if any(n in k for n in FORWARD_KERNELS))
    idle = max(0.0, 1 - busy / wall)
    # The profiler can lose the records of long kernels: the idle share is a measurement
    # only where it recorded every recurrence launch of the step.
    recorded = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and any(n in e.name for n in FORWARD_KERNELS + BACKWARD_KERNELS))
    launched = sum(grew[name] for name in (*ls.LAUNCHES, *gs.LAUNCHES))
    idle_text = (f"not measured (the profiler recorded {recorded} of {launched} recurrence "
                 "launches)" if recorded < launched else f"{idle:.1%}")
    log(f"  profile of one {what} step: wall {wall:.3f} ms; forward "
        f"{fwd:.3f} ms (recurrence kernels {fwd_kernel:.3f} ms device), backward {bwd:.3f} ms "
        f"(backward kernels {bwd_kernel:.3f} ms device, other backward {bwd - bwd_kernel:.3f} "
        f"ms), optimizer {opt:.3f} ms; device busy {busy:.3f} ms, idle share "
        f"{idle_text} [{card}]")
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    log("    top device time: " + ", ".join(f"{k[:48]} {t:.3f} ms" for k, t in top))

    # The backward alone: what the rest of it is made of.
    optimizer.zero_grad()
    loss = loss_of()
    torch.cuda.synchronize()
    before = all_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    grew = grown(before)
    by_path = {k: n for k, n in grew.items() if "_bwd/" in k and n}
    check_backward(grew)
    alone = device_times(prof)
    rest = {k: t for k, t in alone.items() if not any(n in k for n in BACKWARD_KERNELS)}
    log(f"    backward alone: device {sum(alone.values()):.3f} ms, backward kernels "
        f"{sum(alone.values()) - sum(rest.values()):.3f} ms, launches by path {by_path}; "
        f"the rest {sum(rest.values()):.3f} ms, its ten longest ops by name:")
    for k, t in sorted(rest.items(), key=lambda kv: -kv[1])[:10]:
        log(f"      {t:9.3f} ms  {k[:110]}")
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                idle_share=None if recorded < launched else idle,
                recurrence_forward_ms=fwd_kernel, recurrence_backward_ms=bwd_kernel)


def profile_dprnn_step(model, compute_dtype, card, what):
    """profile_train_step of a B = 2 x 4 s DPRNN-TasNet step, f32 or bf16 (a cast copy of
    the parameters), every recurrence on the tensor cores."""
    from torch.func import functional_call

    criterion = PIT1d(NegSISDR(), n_sources=2)
    optimizer = make_optimizer("adam", 1e-3, 5.0, params=model.parameters())
    mixture, sources = train_batch(2, 4.0, "cuda")

    def loss_of():
        if compute_dtype is None:
            estimates = model(mixture)
        else:
            cast = {k: v.to(compute_dtype) if v.dtype == torch.float32 else v
                    for k, v in model.named_parameters()}
            estimates = functional_call(model, cast, (mixture.to(compute_dtype),)).float()
        return criterion(estimates, sources)[0]

    profile_train_step(
        loss_of, optimizer, f"{what} (B=2 x 4 s)", card,
        lambda grew: check_paths(grew, all_bf16(grew) if compute_dtype == torch.bfloat16 else {},
                                 f"{what}: the profiled backward"))


def phase_train_throughput(card):
    log("== phase 9: training throughput (informational)")
    for rnn in ("lstm", "gru"):
        dprnn = TRAIN_MODELS["dprnn_tasnet" + ("_gru" if rnn == "gru" else "")]
        for dtype in (None, torch.bfloat16):
            what = f"DPRNN-TasNet {rnn.upper()} non-causal {'bf16' if dtype else 'f32'}"
            model = timed_train_steps(*dprnn, 2, dtype, card, what)
            profile_dprnn_step(model, dtype, card, what)
    for dtype in (None, torch.bfloat16):
        timed_train_steps(*TRAIN_MODELS["conv_tasnet"], 4, dtype, card,
                          f"Conv-TasNet {'bf16' if dtype else 'f32'}")


def phase_quantized_serve(conv_ckpt, wavs, conv_out):
    """Quantize paper-config Conv-TasNet's weights on the card, dequantize, serve."""
    log("== phase 4e: int8-quantized paper-config Conv-TasNet through cli/separate.py")
    reset_counts()
    model = load_model(conv_ckpt, device="cuda")
    qstate = q8.quantize_state_dict(model.state_dict())
    n_quantized = sum(isinstance(v, dict) for v in qstate.values())
    model.load_state_dict(q8.dequantize_state_dict(qstate))
    quantized = counts()
    # The JAX tree's >= 2-D leaves: the encoder, decoder, bottleneck and mask
    # convolutions, and per TDCN layer its bottleneck, depthwise and skip
    # convolutions and, but in the last layer, its output convolution.
    layers = PAPER["sep_num_blocks"] * PAPER["sep_num_layers"]
    weights = 4 + 4 * layers - 1
    check(n_quantized == weights and quantized == expected(quantize_int8=weights),
          f"quantized {n_quantized} tensors with launches {quantized}, expected {weights}")
    ckpt = os.path.join(os.path.dirname(conv_ckpt), "conv_tasnet_int8.pth")
    save_model(ckpt, model)
    log(f"  {n_quantized} tensors quantized on the card, one quantize_int8 launch each")
    outputs, served = serve("conv_tasnet_int8", ckpt, wavs, expected(fused_mask_decode=1))
    for wav in wavs:
        ref, got = conv_out[("float32", wav)], outputs[("float32", wav)]
        snr = 10 * np.log10(np.sum(ref ** 2) / np.sum((got - ref) ** 2))
        log(f"  f32 {os.path.basename(wav)}: int8 weights vs f32 weights, SNR {snr:.2f} dB "
            f"(informational)")
    return {k: v + quantized.get(k, 0) for k, v in served.items()}


# Uneven test utterances (samples at 8 kHz): off the stride-8 grid of
# Conv-TasNet and off DPRNN-TasNet's chunk grid.
TEST_LENGTHS = (9001, 15997)
TEST_METRICS = ("loss", "loss_improvement", "sdr_improvement", "sir_improvement", "sar")
EVAL_TOL_DB = 0.05  # card vs CPU, each metric of each utterance


def write_test_list(tmp):
    """A wsj0-style test set of pseudo-speech pairs, one list file per utterance."""
    root = os.path.join(tmp, "tt_uneven")
    for sub in ("mix", "s1", "s2"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    speakers = _speaker_bank(6, seed=11)
    rng = np.random.default_rng(12)
    lists = []
    for i, T in enumerate(TEST_LENGTHS):
        s1 = synth_pseudo_speech(speakers[i], rng, T, SAMPLE_RATE)
        s2 = 0.7 * synth_pseudo_speech(speakers[i + 3], rng, T, SAMPLE_RATE)
        utt = f"tt{i}"
        for sub, sig in (("s1", s1), ("s2", s2), ("mix", s1 + s2)):
            write_wav(os.path.join(root, sub, f"{utt}.wav"), sig, SAMPLE_RATE)
        lists.append(os.path.join(root, f"{utt}.lst"))
        with open(lists[-1], "w") as f:
            f.write(utt + "\n")
    return root, lists


def evaluate(root, list_path, ckpt, device, flags=()):
    """cli/test_wsj0mix.main on one utterance -> its summary (its CSV lines kept off the log)."""
    with contextlib.redirect_stdout(io.StringIO()):
        return test_cli.main(["--test_wav_root", root, "--test_list_path", list_path,
                              "--model_path", ckpt, "--device", device, *flags])


def phase_evaluate(tmp, checkpoints, card):
    """The trained checkpoints through cli/test_wsj0mix.py on the card, against the CPU."""
    log("== phase 10: evaluate through cli/test_wsj0mix.py, card vs CPU")
    root, lists = write_test_list(tmp)
    total = dict.fromkeys(all_counts(), 0)
    for tag, ckpt in checkpoints.items():
        worst = 0.0
        reset_counts()
        for list_path, T in zip(lists, TEST_LENGTHS):
            before = all_counts()
            start = time.perf_counter()
            got = evaluate(root, list_path, ckpt, "cuda")
            wall = (time.perf_counter() - start) * 1e3
            grew_all = grown(before)
            grew = kernels_of(grew_all)
            check(grew == eval_launches(tag), f"{tag}: an utterance launched {grew}, expected "
                                              f"{eval_launches(tag)}")
            check_paths(grew_all, {}, f"{tag}: an f32 evaluation", decode_path(tag, "float32"))
            ref = evaluate(root, list_path, ckpt, "cpu")
            diffs = {k: abs(got[k] - ref[k]) for k in TEST_METRICS}
            check(all(np.isfinite(got[k]) for k in TEST_METRICS), got)
            worst = max(worst, *diffs.values())
            log(f"  {tag}, {T} samples: SI-SDRi {got['loss_improvement']:.3f} dB, SDRi "
                f"{got['sdr_improvement']:.3f}, SIRi {got['sir_improvement']:.3f}, SAR "
                f"{got['sar']:.3f}; max |card - CPU| {max(diffs.values()):.2e} dB; wall "
                f"{wall:.1f} ms = forward {got['forward_ms']:.1f} + BSS-Eval "
                f"{got['bss_eval_ms']:.1f} + load; launches {nonzero(grew)} [{card}]")
            if not max(diffs.values()) <= EVAL_TOL_DB:
                raise AssertionError(f"{tag}: card metrics differ from the CPU's: {diffs}")
        path = all_counts()
        total = {k: v + path[k] for k, v in total.items()}
        log(f"  {tag}: {len(lists)} utterances, worst |card - CPU| over every metric "
            f"{worst:.2e} dB (limit {EVAL_TOL_DB:g}); path launches {nonzero(path)}")
    return total


# Phase 11: musdb18 serving of paper-config ParallelOpenUnmix and bridged X-UMX.
MUSDB_TRACK_SECONDS = 20.0  # one test track of two 10 s chunks
MUSDB_CHUNK_SECONDS = 10.0  # the CLI's default --duration: S = 431 frames a chunk
MUSDB_TRACKS = 1  # BSS-Eval v4's 512-tap solves on the host take about 23 s a track
MUSDB_DB_TOL = 0.05  # card vs CPU, each median of each stem
# BSS-Eval v4's 512-tap solves took 27 s of each 30 s CLI run on the host; the card and the
# CPU runs are held to each other at 64 taps, as phase 12's served checkpoints are.
MUSDB_FILT_LEN = 64
WIENER_TOL = 1e-3  # the EM alone, card vs CPU, relative to max|CPU|
UMX_BIDIR_LAYERS = UMX["num_layers"] * 4  # one bidirectional layer a stem, per chunk
# The recurrences at UMX's serving shapes: a 10 s chunk at B = 1; H = 512 // 2 per
# direction (bidirectional) and 512 (causal); both on the cluster kernel (phase 3h).
UMX_SCAN_SHAPES = {"lstm_scan_bidir": (1, 431, UMX["hidden_channels"] // 2, 2),
                   "lstm_scan": (1, 431, UMX["hidden_channels"], 1)}


class RecordingEvaluater(Evaluater):
    """The musdb18 CLI's Evaluater, keeping the float stems (n_src, T, C) the CLI hands
    it, one list per thread (one CLI run a thread)."""

    stems: dict = {}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        RecordingEvaluater.stems[threading.get_ident()] = self.seen = []

    def add_track(self, references, estimates):
        self.seen.append(np.array(estimates))
        return super().add_track(references, estimates)


def umx_wrapper(kind, causal=False, device="cuda"):
    """Paper-config ParallelOpenUnmix or bridged X-UMX in its wrapper, weights from seed 0,
    BatchNorm statistics and the per-bin affines off their init so they do real work."""
    cls = {"umx": ParallelOpenUnmix, "xumx": CrossNetOpenUnmix}[kind]
    model = SpectrogramMaskingWrapper(
        cls(**UMX, causal=causal, generator=torch.Generator().manual_seed(0), device=device),
        **UMX_STFT, device=device)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_var", "norm1d.weight", "scale_in", "scale_out")):
                t.copy_(torch.from_numpy(0.5 + rng.random(t.shape, np.float32)))
            elif name.endswith(("running_mean", "norm1d.bias", "bias_in", "bias_out")):
                t.copy_(torch.from_numpy(0.1 * rng.standard_normal(t.shape).astype(np.float32)))
    return model.eval()


def run_musdb_cli(root, ckpt, device):
    """cli/test_musdb18.py on `device` -> (medians table, per-track stats, float stems).
    The CLI's own lines go to the log as they come (CPU runs share the log from threads)."""
    argv = ["--musdb18_root", root, "--model_path", ckpt, "--device", device,
            "--sample_rate", str(MUSDB_SAMPLE_RATE), "--duration", str(MUSDB_CHUNK_SECONDS),
            "--filt_len", str(MUSDB_FILT_LEN)]
    table, stats = musdb_cli.run(argv)
    return table, stats, RecordingEvaluater.stems.pop(threading.get_ident())


def musdb_chunks(root):
    """The chunks the CLI serves: each test track cut into 10 s chunks, the last padded."""
    chunk = int(MUSDB_CHUNK_SECONDS * MUSDB_SAMPLE_RATE)
    return sum(-(-mix.shape[-1] // chunk) for _, mix, _ in MusdbTestDataset(root))


def wiener_card_vs_cpu(model, root, card):
    """The EM alone on the first track's full-length inputs (the model's magnitudes of its
    chunks, the mixture spectrogram): card vs CPU, time and peak memory on the card."""
    _, mixture, _ = MusdbTestDataset(root)[0]
    chunk = int(MUSDB_CHUNK_SECONDS * MUSDB_SAMPLE_RATE)
    x = torch.from_numpy(mixture).cuda()
    with torch.inference_mode():
        amps = torch.cat([model(x[None, ..., i:i + chunk])[0]
                          for i in range(0, x.shape[-1], chunk)], dim=-1)
        spec = torch.cat([model.spectrogram(x[0, :, i:i + chunk])
                          for i in range(0, x.shape[-1], chunk)], dim=-1)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        card_est = multichannel_wiener_filter(spec, amps)
        peak = torch.cuda.max_memory_allocated()
        ms = median_ms(lambda: multichannel_wiener_filter(spec, amps), warmup=1, iters=5)
        ref = multichannel_wiener_filter(spec.cpu(), amps.cpu())
    err = float((card_est.cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"  Wiener EM alone, {tuple(amps.shape)} (one iteration): card vs CPU max abs err "
        f"{err:.3e}, max|CPU| {scale:.3e}, limit {WIENER_TOL * scale:.3e}; {ms:.3f} ms "
        f"(median of 5, CUDA events); peak allocated {peak / 2**20:.1f} MiB, "
        f"{(peak - base) / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held before "
        f"[{card}]")
    check(torch.isfinite(card_est).all() and err <= WIENER_TOL * scale,
          f"the Wiener EM on the card disagrees with the CPU: {err} > {WIENER_TOL} x {scale}")
    return dict(wiener_ms=ms, wiener_peak_bytes=peak, wiener_extra_bytes=peak - base)


def serve_musdb(kind, root, ckpt, chunks):
    """One model through the CLI on the card, every count set to 0 just before and read
    just after: exactly UMX_BIDIR_LAYERS lstm_scan_bidir launches a chunk, all on the
    cluster kernel, and no other kernel."""
    log(f"== phase 11: musdb18 serving, paper-config {kind.upper()} through "
        f"cli/test_musdb18.py --device cuda")
    reset_counts()
    table, stats, stems = run_musdb_cli(root, ckpt, "cuda")
    launches = all_counts()
    want = expected(lstm_scan_bidir=UMX_BIDIR_LAYERS * chunks)
    check(kernels_of(launches) == want, f"{kind}: the CLI launched {nonzero(launches)}, "
                                        f"expected {nonzero(want)}")
    B, _, H, chains = UMX_SCAN_SHAPES["lstm_scan_bidir"]
    route = plan(ls, B, chains, H, torch.float32)[0]
    n = UMX_BIDIR_LAYERS * chunks
    paths = {p: launches[f"lstm_scan_bidir/{p}"] for p in ls.PATH_LAUNCHES["lstm_scan_bidir"]}
    check(paths == {p: n * (p == route) for p in paths},
          f"{kind}: lstm_scan_bidir launched {paths} by path, expected all {n} on {route} "
          f"(B = {B}, H = {H})")
    log(f"  {chunks} chunks: kernel launches {nonzero(launches)} "
        f"({UMX_BIDIR_LAYERS} lstm_scan_bidir on {route} a chunk)")
    return dict(table=table, stats=stats, stems=stems, launches=launches)


def musdb_card_vs_cpu(kind, served, cpu_run, card):
    """The card's stems within 1e-3 x max|CPU| of the CPU's, every median within
    MUSDB_DB_TOL dB; the card's stage times, audio-s/s and EM peak memory logged."""
    log(f"== phase 11: {kind.upper()} card vs CPU (cli/test_musdb18.py --device cpu)")
    table, cpu_table, cpu_stems = served["table"], cpu_run[0], cpu_run[2]
    for i, (got, ref) in enumerate(zip(served["stems"], cpu_stems)):
        err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        log(f"  track {i}: stems {got.shape} card vs CPU max abs err {err:.3e}, max|ref| "
            f"{scale:.3e}, limit {1e-3 * scale:.3e}")
        check(np.isfinite(got).all() and err <= 1e-3 * scale,
              f"{kind}: the card's stems disagree with the CPU's: {err} > 1e-3 x {scale}")
    check(len(served["stems"]) == len(cpu_stems) == MUSDB_TRACKS, "tracks evaluated")
    worst = max(abs(table[s][m] - cpu_table[s][m]) for s in table for m in Evaluater.METRICS)
    for s in table:
        log(f"  {s}: " + ", ".join(f"{m} {table[s][m]:.3f} (CPU {cpu_table[s][m]:.3f})"
                                   for m in Evaluater.METRICS) + " dB")
    log(f"  medians card vs CPU: worst {worst:.4f} dB (limit {MUSDB_DB_TOL})")
    check(worst <= MUSDB_DB_TOL, f"{kind}: a median differs from the CPU's by {worst:.4f} dB")
    for st in served["stats"]:
        log(f"  {st['name']}: BSS-Eval v4 {st['evaluate_s']:.2f} s on the host (the CLI's "
            f"card run, beside the CPU runs)")


def musdb_stage_times(kind, model, root, card, repeats=3):
    """A track's separation on a quiet host (no CLI run beside it): the CLI's
    separate_track on the test track, after one warm-up, median of `repeats`;
    device ms by stage (CUDA events), audio-s/s on the host clock (host copy included),
    the EM's peak allocation."""
    _, mixture, _ = MusdbTestDataset(root)[0]
    x = torch.from_numpy(mixture).cuda()
    chunk = int(MUSDB_CHUNK_SECONDS * MUSDB_SAMPLE_RATE)
    chunks = -(-x.shape[-1] // chunk)
    runs = []
    with torch.inference_mode():
        for i in range(1 + repeats):
            start = time.perf_counter()
            wave, clock, peak = musdb_cli.separate_track(model, x, chunk, 1)
            wave.cpu()
            if i:
                runs.append(dict(clock.ms(), separate_s=time.perf_counter() - start, peak=peak))
    med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    seconds = x.shape[-1] / MUSDB_SAMPLE_RATE
    log(f"  {kind.upper()} stage times, {seconds:g} s track in {chunks} chunks (median of "
        f"{repeats}): forward {med['forward'] / chunks:.3f} ms a chunk, mixture STFT "
        f"{med['stft'] / chunks:.3f} ms a chunk, Wiener EM {med['wiener']:.3f} ms, iSTFT "
        f"{med['istft']:.3f} ms (CUDA events); separated in {med['separate_s'] * 1e3:.1f} ms = "
        f"{seconds / med['separate_s']:.2f} audio-s/s (host clock, host copy included); EM "
        f"peak allocated {med['peak'] / 2**20:.1f} MiB [{card}]")
    return dict(chunk_forward_ms=med["forward"] / chunks, track_audio_s_per_s=seconds /
                med["separate_s"], em_peak_bytes=med["peak"])


def causal_umx(root, card):
    """Causal paper-config UMX (one-chain LSTM, H = 512, on the cluster kernel) over one
    10 s chunk: card vs CPU, launches (every count set to 0 just before) and forward
    time."""
    log("== phase 11: causal paper-config UMX, one 10 s chunk, card vs CPU")
    model = umx_wrapper("umx", causal=True)
    cpu = umx_wrapper("umx", causal=True, device="cpu")
    cpu.load_state_dict(model.state_dict())
    _, mixture, _ = MusdbTestDataset(root)[0]
    x = torch.from_numpy(mixture[..., :int(MUSDB_CHUNK_SECONDS * MUSDB_SAMPLE_RATE)])[None]
    reset_counts()
    with torch.inference_mode():
        got = model(x.cuda())
        torch.cuda.synchronize()
        launches = all_counts()
        ref = cpu(x)
        ms = median_ms(lambda: model(x.cuda()), warmup=1, iters=5)
    want = expected(lstm_scan=UMX_BIDIR_LAYERS)
    B, _, H, chains = UMX_SCAN_SHAPES["lstm_scan"]
    route = plan(ls, B, chains, H, torch.float32)[0]
    paths = {p: launches[f"lstm_scan/{p}"] for p in ls.PATH_LAUNCHES["lstm_scan"]}
    check(kernels_of(launches) == want and
          paths == {p: UMX_BIDIR_LAYERS * (p == route) for p in paths},
          f"causal UMX launched {nonzero(launches)} ({paths} by path), expected "
          f"{nonzero(want)} on {route}")
    err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
    log(f"  {tuple(got.shape)}: launches {nonzero(launches)}; card vs CPU max abs err "
        f"{err:.3e}, max|ref| {scale:.3e}, limit {1e-3 * scale:.3e}; forward {ms:.3f} ms "
        f"(median of 5, CUDA events) [{card}]")
    check(err <= 1e-3 * scale, f"causal UMX on the card disagrees with the CPU: {err}")
    return launches


def musdb_bench(card):
    """The bench module's `--model umx` and `--model xumx` lines, in this process (phase 6
    runs `python -m dnn_based_source_separation_torch.bench` as a user would)."""
    log("== phase 11: the bench module's musdb18 lines (informational; in this process, its "
        "line kept off stdout)")
    for kind in ("umx", "xumx"):
        with contextlib.redirect_stdout(io.StringIO()):
            line = bench_main(["--model", kind])
        check(line["value"] > 0, line)
        log(f"  bench --model {kind}: {json.dumps(line)}")


def phase_musdb(card=None):
    """Phase 11 -> its launches (all_counts of each card run). BSS-Eval on the host
    dominates the CLI runs, so the two CPU runs go in threads beside the card runs (one at
    a time, each counted alone); the stage times come from a quiet host afterwards."""
    card = card or card_line()
    musdb_cli.Evaluater = RecordingEvaluater
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "musdb18")
        with contextlib.redirect_stdout(io.StringIO()):
            write_musdb_quality_corpus(root, n_train=0, n_valid=0, n_test=MUSDB_TRACKS,
                                       track_sec=MUSDB_TRACK_SECONDS,
                                       sample_rate=MUSDB_SAMPLE_RATE)
        chunks = musdb_chunks(root)
        models, ckpts, served = {}, {}, {}
        for kind in ("umx", "xumx"):
            models[kind] = umx_wrapper(kind)
            ckpts[kind] = os.path.join(tmp, f"{kind}.pth")
            save_model(ckpts[kind], models[kind])
        log("== phase 11: cli/test_musdb18.py --device cpu for UMX and X-UMX, in two threads "
            "beside the card runs")
        with ThreadPoolExecutor(2) as pool:
            cpu_runs = {kind: pool.submit(run_musdb_cli, root, ckpts[kind], "cpu")
                        for kind in ckpts}
            for kind in ckpts:
                served[kind] = serve_musdb(kind, root, ckpts[kind], chunks)
            cpu_runs = {kind: run.result() for kind, run in cpu_runs.items()}
        for kind in ckpts:
            musdb_card_vs_cpu(kind, served[kind], cpu_runs[kind], card)
            served[kind].update(wiener_card_vs_cpu(models[kind], root, card))
            served[kind].update(musdb_stage_times(kind, models[kind], root, card))
        causal = causal_umx(root, card)
    musdb_cli.Evaluater = Evaluater
    musdb_bench(card)
    return dict(served=served, causal_launches=causal)


# Phase 12: musdb18 training of UMX and X-UMX at the recipe widths: the train CLI's
# defaults, which egs/musdb18/{umx,x-umx}/train.sh keep (n_fft 4096, hop 1024, max_bin
# 1487, hidden 512, 3 layers, dropout 0.4, four stems, B = 16 x 6 s, Adam at 1e-3).
MUSDB_TRAIN_SECONDS = 6.0  # --duration: 259 STFT frames
MUSDB_TRAIN_BATCH = 16  # --batch_size
MUSDB_PARITY_BATCH = 1  # the card step held to an f64 CPU step (the f64 step's cost)
MUSDB_TRAIN_STEPS = 4  # steps a CLI epoch; two epochs a model
MUSDB_TRAIN_TRACK_SECONDS = 20.0  # corpus tracks: four train, one valid, one test
MUSDB_NULL_GRAD = 1e-4  # bias_in's gradient is 0 but for rounding (train-mode BatchNorm)
UMX_STEP_LAUNCHES = UMX["num_layers"] * 4  # one biLSTM layer a stem and layer, each way


def musdb_model_and_criterion(kind, dropout, device):
    """The train CLI's own model (seed 0) and criterion for `kind` at its defaults."""
    args = musdb_train_cli.build_parser().parse_args(
        ["--musdb18_root", "", "--model", kind, "--seed", "0", "--dropout", str(dropout)])
    return musdb_train_cli.build_model_and_criterion(args, args.sources.split(","), device)


def musdb_batch(B, device, seed=12):
    """Four stereo stems of noise and their sum, (B, 1, 2, T) and (B, 4, 2, T), 6 s at
    44.1 kHz, from a seed."""
    rng = np.random.default_rng(seed)
    sources = 0.1 * rng.standard_normal(
        (B, 4, 2, int(MUSDB_TRAIN_SECONDS * MUSDB_SAMPLE_RATE)), dtype=np.float32)
    return (torch.from_numpy(sources.sum(axis=1, keepdims=True)).to(device),
            torch.from_numpy(sources).to(device))


def check_musdb_launches(launches, what, forwards, backwards, batch):
    """`forwards` model forwards and `backwards` model backwards of `batch` sequences
    (each UMX_STEP_LAUNCHES lstm_scan_bidir, or backwards, at H = 256 on the route _plan,
    or _plan_bwd, gives that batch: "cluster" at B = 1), and no other kernel or route."""
    n_fwd, n_bwd = UMX_STEP_LAUNCHES * forwards, UMX_STEP_LAUNCHES * backwards
    want = expected(lstm_scan_bidir=n_fwd, lstm_scan_bidir_bwd=n_bwd)
    check(kernels_of(launches) == want, f"{what}: launched {nonzero(launches)}, expected "
                                        f"{nonzero(want)}")
    H = UMX_TRAIN_SHAPE[2]
    route = plan(ls, batch, 2, H, torch.float32)[0]
    bwd_route = plan_bwd(ls, batch, 2, H, torch.float32)[0]
    fwd = {p: launches[f"lstm_scan_bidir/{p}"] for p in ls.PATH_LAUNCHES["lstm_scan_bidir"]}
    bwd = {p: launches[f"lstm_scan_bidir_bwd/{p}"]
           for p in ls.BWD_PATH_LAUNCHES["lstm_scan_bidir_bwd"]}
    check(fwd == {p: n_fwd * (p == route) for p in fwd} and
          bwd == {p: n_bwd * (p == bwd_route) for p in bwd},
          f"{what}: lstm_scan_bidir took {fwd}, its backward {bwd}; expected {n_fwd} on "
          f"{route} and {n_bwd} on {bwd_route} (B = {batch})")


def musdb_grads_of_step(model, criterion, batch):
    """One make_train_step with SGD at lr 0 (the weights stay; the gradients stay in .grad)."""
    step = make_train_step(model, criterion, make_optimizer("sgd", 0.0, params=model.parameters()))
    loss = float(step(*batch))
    return loss, {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def musdb_train_parity():
    """One UMX and one X-UMX train step at the recipe widths, dropout 0, card against an
    f64 CPU step beside the f32 CPU step (the kernels' plain versions), as phase 7. A
    comparison, not a main-path run: its launches are checked and not kept."""
    for kind in ("umx", "xumx"):
        cpu_model, criterion = musdb_model_and_criterion(kind, 0.0, "cpu")
        batch = musdb_batch(MUSDB_PARITY_BATCH, "cpu")
        ref = musdb_grads_of_step(copy.deepcopy(cpu_model).double(), criterion,
                                  tuple(t.double() for t in batch))
        cpu = musdb_grads_of_step(cpu_model, criterion, batch)
        card_model, card_criterion = musdb_model_and_criterion(kind, 0.0, "cuda")
        reset_counts()
        card = musdb_grads_of_step(card_model, card_criterion,
                                   musdb_batch(MUSDB_PARITY_BATCH, "cuda"))
        torch.cuda.synchronize()
        launched = all_counts()
        check_musdb_launches(launched, f"{kind}: a train step", 1, 1, MUSDB_PARITY_BATCH)
        check_step_against_f64(f"{kind.upper()} (B={MUSDB_PARITY_BATCH} x 6 s)", ref, cpu, card,
                               kernels_of(launched), null_floor=MUSDB_NULL_GRAD)


class CountedValidationTrainer(Trainer):
    """The CLI's Trainer with the launches of its validation epochs kept apart
    (`validated`), so that a CLI run's counts split into its train steps' and its
    validation forwards'."""

    def run_one_epoch_eval(self, epoch):
        before = all_counts()
        loss = super().run_one_epoch_eval(epoch)
        grew = grown(before)
        self.validated = {k: v + grew[k] for k, v in
                          getattr(self, "validated", dict.fromkeys(grew, 0)).items()}
        return loss


def musdb_train_through_cli(root, kind, tmp, card):
    """cli/train_musdb18.py for two epochs of MUSDB_TRAIN_STEPS steps (every count set to 0
    just before, read just after), then its last.ckpt served through cli/test_musdb18.py
    on the card -> (the train steps' launches (B = 16 x 6 s, with cs), the B = 1 10 s
    forwards' launches (validation and serving), the steps)."""
    exp = os.path.join(tmp, f"exp_{kind}")
    argv = ["--musdb18_root", root, "--model", kind, "--seed", "0", "--epochs", "2",
            "--samples_per_epoch", str(MUSDB_TRAIN_BATCH * MUSDB_TRAIN_STEPS),
            "--cache_in_memory", "1", "--exp_dir", exp, "--device", "cuda"]
    musdb_train_cli.Trainer = CountedValidationTrainer
    reset_counts()
    start = time.perf_counter()
    trainer = musdb_train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    trained = all_counts()
    musdb_train_cli.Trainer = Trainer
    validated = trainer.validated
    stepped = {k: v - validated[k] for k, v in trained.items()}
    steps = 2 * len(trainer.train_loader)
    check(steps == 2 * MUSDB_TRAIN_STEPS, f"{kind}: {steps} steps")
    check_musdb_launches(stepped, f"{kind}: the train CLI's steps", steps, steps,
                         MUSDB_TRAIN_BATCH)
    check_musdb_launches(validated, f"{kind}: the train CLI's validation",
                         2 * len(trainer.valid_loader), 0, 1)
    losses = trainer.train_loss + trainer.valid_loss
    stats = trainer.last_epoch_stats
    log(f"  {kind.upper()} through the CLI: {steps} steps of B={MUSDB_TRAIN_BATCH} x 6 s in "
        f"{seconds:.1f} s, train loss by epoch {trainer.train_loss}, valid loss "
        f"{trainer.valid_loss}; last epoch {stats['audio_sec_per_sec']:.2f} audio-s/s, "
        f"iteration p50 {stats['iter_p50_ms']:.1f} ms, loader stall {stats['fetch_frac']:.1%}; "
        f"launches: steps {nonzero(stepped)}, validation {nonzero(validated)} [{card}]")
    check(np.isfinite(losses).all(), f"{kind}: non-finite losses {losses}")
    check(trainer.train_loss[1] < trainer.train_loss[0],
          f"{kind}: the train loss did not fall over {steps} steps: {trainer.train_loss}")
    last = os.path.join(exp, "model", "last.ckpt")
    reset_counts()
    # BSS-Eval v4's 512-tap solves take about 13 s on the host whatever the track's length;
    # MUSDB_FILT_LEN taps keep the CLI's evaluation (its medians only logged) at a fraction.
    table, _ = musdb_cli.run(["--musdb18_root", root, "--model_path", last, "--device", "cuda",
                              "--sample_rate", str(MUSDB_SAMPLE_RATE), "--duration",
                              str(MUSDB_CHUNK_SECONDS), "--max_duration", str(MUSDB_CHUNK_SECONDS),
                              "--filt_len", str(MUSDB_FILT_LEN)])
    served = all_counts()
    check_musdb_launches(served, f"{kind}: serving the trained checkpoint", 1, 0, 1)
    log(f"  the trained {kind.upper()} last.ckpt served through cli/test_musdb18.py (one 10 s "
        f"chunk): launches {nonzero(served)}; median SDR "
        + ", ".join(f"{s} {row['SDR']:.3f}" for s, row in table.items()) + " dB")
    return stepped, {k: v + served[k] for k, v in validated.items()}, steps


def musdb_step_profile(kind, card, warmup=2, iters=5):
    """The recipe step (B = 16 x 6 s, dropout 0.4) timed on the card: p50 of the forward
    with the loss / backward / optimizer split by CUDA events and of the wall step (host
    clock, synchronised), audio-s/s, peak allocation; then profile_train_step of it."""
    model, criterion = musdb_model_and_criterion(kind, 0.4, "cuda")
    set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(0))
    optimizer = make_optimizer("adam", 1e-3, params=model.parameters())
    mixture, sources = musdb_batch(MUSDB_TRAIN_BATCH, "cuda")
    model.train()
    step = evented_step(lambda: criterion(model(mixture), sources), optimizer)

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(warmup):
        step(events)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = all_counts()
    splits, walls = [], []
    for _ in range(iters):
        start = time.perf_counter()
        step(events)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        splits.append([events[i].elapsed_time(events[i + 1]) for i in range(3)])
    peak = torch.cuda.max_memory_allocated()
    check_musdb_launches(grown(before), f"{kind}: the timed steps", iters, iters,
                         MUSDB_TRAIN_BATCH)
    fwd, bwd, opt = (float(np.median([s[i] for s in splits])) for i in range(3))
    p50 = float(np.median(walls)) * 1e3
    result = dict(p50_ms=p50, forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
                  audio_s_per_s=MUSDB_TRAIN_BATCH * MUSDB_TRAIN_SECONDS / (p50 / 1e3),
                  peak_bytes=peak)
    log(f"  {kind.upper()} step, B={MUSDB_TRAIN_BATCH} x 6 s, dropout 0.4: p50 {p50:.3f} ms of "
        f"{iters} (min {min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}; host clock), "
        f"{result['audio_s_per_s']:.2f} audio-s/s; CUDA events p50: forward with the loss "
        f"{fwd:.3f} ms, backward {bwd:.3f} ms, optimizer {opt:.3f} ms; peak allocated "
        f"{peak / 2**20:.1f} MiB [{card}]")
    result.update(profile_train_step(
        lambda: criterion(model(mixture), sources), optimizer,
        f"{kind.upper()} B={MUSDB_TRAIN_BATCH} x 6 s", card,
        lambda grew: check_musdb_launches(grew, f"{kind}: the profiled backward", 0, 1,
                                          MUSDB_TRAIN_BATCH)))
    return result


def phase_musdb_train(card=None):
    """Phase 12 -> {"train": the CLI train steps' launches (B = 16 x 6 s), "serve": the
    launches of its B = 1 10 s forwards (validation and the trained checkpoints'
    serving), "profile": {kind: musdb_step_profile}}, each count set to 0 just before a
    run and read just after."""
    card = card or card_line()
    log("== phase 12: musdb18 training, one step card vs CPU (f32, TF32 off, recipe widths, "
        f"B={MUSDB_PARITY_BATCH} x 6 s, dropout 0; f64 CPU reference)")
    musdb_train_parity()
    train = serve = None
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "musdb18")
        with contextlib.redirect_stdout(io.StringIO()):
            write_musdb_quality_corpus(root, n_train=4, n_valid=1, n_test=1,
                                       track_sec=MUSDB_TRAIN_TRACK_SECONDS,
                                       sample_rate=MUSDB_SAMPLE_RATE)
        for kind in ("umx", "xumx"):
            log(f"== phase 12: train {kind.upper()} through cli/train_musdb18.py, serve it "
                "through cli/test_musdb18.py")
            stepped, served, _ = musdb_train_through_cli(root, kind, tmp, card)
            train = stepped if train is None else {k: v + stepped[k] for k, v in train.items()}
            serve = served if serve is None else {k: v + served[k] for k, v in serve.items()}
    log("== phase 12: the recipe train step timed and profiled (informational)")
    profiles = {kind: musdb_step_profile(kind, card) for kind in ("umx", "xumx")}
    return dict(train=train, serve=serve, profile=profiles)


# DPTNet (phase 13): the recipe config (egs/wsj0-mix/dptnet/train.sh), H = 256 a direction,
# K = 100 at hop 50, six blocks. At B = 8 x 4 s (T' = 31999 frames, padded by 1 to 639
# chunks) each block runs the intra-chunk biLSTM over 5112 sequences of 100 steps and the
# inter-chunk LSTM over 800 sequences of 639; recipe training (B = 2) over 1278 and 200.
DPT_H, DPT_K = DPTNET["sep_hidden_channels"], DPTNET["sep_chunk_size"]
DPT_BLOCKS, DPT_E = DPTNET["sep_num_blocks"], DPTNET["sep_bottleneck_channels"]
DPT_SHAPES = [  # label, (B, T, chains), dtypes, training (cs written, backward checked)
    ("serve intra", (5112, 100, 2), (torch.float32, torch.bfloat16), False),
    ("serve inter", (800, 639, 2), (torch.float32, torch.bfloat16), False),
    ("serve causal inter", (800, 639, 1), (torch.float32, torch.bfloat16), False),
    ("train intra", (1278, 100, 2), (torch.float32,), True),
    ("train inter", (200, 639, 2), (torch.float32,), True),
    ("train causal inter", (200, 639, 1), (torch.float32,), True),
]
DPT_WARMUP = 20  # --warmup_steps of the CLI run: the ramp reaches 2e-3 by step 8
DPT_TRAIN_UTTS = 8  # synthetic train utterances: at least 5 steps of B = 2 x 4 s an epoch


def dptnet_chunks(n_samples):
    """S: the chunks of K frames at hop K // 2 that DPTNet's separator cuts the latent of
    one n-sample input into (the stride-grid pad, then the symmetric chunk-grid pad)."""
    L, stride = DPTNET["kernel_size"], DPTNET["stride"]
    frames = (n_samples + (stride - (n_samples - L) % stride) % stride - L) // stride + 1
    P = DPT_K // 2
    return (frames + (P - (frames - DPT_K) % P) % P - DPT_K) // P + 1


def dptnet_routes(B, n_samples, causal, dtype, backward=False):
    """The recurrence launches of one DPTNet forward (and its backward) on (B, 1, n), by
    "kernel/route": per block the intra-chunk biLSTM over B·S sequences of K steps and the
    inter-chunk LSTM over B·K sequences of S steps, each on the route _plan (_plan_bwd)
    gives its shape on this card."""
    S = dptnet_chunks(n_samples)
    inter = "lstm_scan" if causal else "lstm_scan_bidir"
    routes = {}
    for name, rows, chains in (("lstm_scan_bidir", B * S, 2), (inter, B * DPT_K, 2 - causal)):
        keys = [f"{name}/{plan(ls, rows, chains, DPT_H, dtype)[0]}"]
        if backward:
            keys.append(f"{name}_bwd/{plan_bwd(ls, rows, chains, DPT_H, dtype)[0]}")
        for key in keys:
            routes[key] = routes.get(key, 0) + DPT_BLOCKS
    return routes


def add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def check_dptnet_launches(grew, routes, what, decodes=0, decode=None):
    """A run's launches: exactly `routes` ("kernel/route" counts) of the LSTM kernels,
    of which "kernel/padded" on a zero-padded call (ls.PADDED_LAUNCHES, a part of the
    kernel's "cluster" count), `decodes` fused_mask_decode launches (on `decode`), and
    nothing else."""
    per_kernel = {}
    for key, n in routes.items():
        if not key.endswith("/padded"):
            per_kernel[key.split("/")[0]] = per_kernel.get(key.split("/")[0], 0) + n
    want = expected(fused_mask_decode=decodes, **per_kernel)
    check(kernels_of(grew) == want, f"{what}: launched {kernels_of(grew)}, expected {want}")
    for table in (ls.PATH_LAUNCHES, ls.BWD_PATH_LAUNCHES):
        for name, paths in table.items():
            for path in paths:
                key = f"{name}/{path}"
                check(grew[key] == routes.get(key, 0),
                      f"{what}: {key} launched {grew[key]} times, expected "
                      f"{routes.get(key, 0)}")
    for name in ls.PADDED_LAUNCHES:
        key = f"{name}/padded"
        check(grew[key] == routes.get(key, 0),
              f"{what}: {key} launched {grew[key]} times, expected {routes.get(key, 0)}")
    if decode is not None:
        got = {p: grew[f"fused_mask_decode/{p}"] for p in md.PATH_LAUNCHES}
        check(got == {p: decodes * (p == decode) for p in got},
              f"{what}: fused_mask_decode launched {got} by path, expected {decode}")


def routes_of(grew) -> dict:
    """The nonzero "kernel/route" and "kernel/padded" counts of the LSTM kernels in an
    all_counts() dict."""
    keys = [f"{name}/{path}" for table in (ls.PATH_LAUNCHES, ls.BWD_PATH_LAUNCHES)
            for name, paths in table.items() for path in paths]
    keys += [f"{name}/padded" for name in ls.PADDED_LAUNCHES]
    return {key: grew[key] for key in keys if grew[key]}


def dptnet_model(causal, device="cuda", blocks=DPT_BLOCKS):
    return scramble_norms(DPTNet(**dict(DPTNET, causal=causal, sep_num_blocks=blocks),
                                 generator=torch.Generator().manual_seed(0), device=device))


def serve_routed(tag, ckpt, wavs, request_routes, decode_of, flags=(), decodes_of=None):
    """Six requests (three mixtures x f32/bf16) through cli/separate.py, every count set
    to 0 first; each request launches request_routes(n_samples, dtype) ("kernel/route"
    counts of the LSTM kernels), decodes_of(n_samples) fused_mask_decode (1 by default)
    on decode_of(dtype), and nothing else. -> (outputs, the path's counts)."""
    tmp = os.path.dirname(ckpt)
    outputs = {}
    reset_counts()
    for dtype in ("float32", "bfloat16"):
        for wav in wavs:
            before = all_counts()
            out_dir = os.path.join(tmp, f"out_{tag}_{dtype}_{os.path.basename(wav)[:-4]}")
            est = separate(["--model_path", ckpt, "--input", wav, "--out_dir", out_dir,
                            "--device", "cuda", "--dtype", dtype, *flags])
            grew = grown(before)
            n_in = read_wav(wav)[0].shape[0]
            check(est.shape == (2, n_in) and np.isfinite(est).all(), est.shape)
            routes = request_routes(n_in, getattr(torch, dtype))
            decodes = decodes_of(n_in) if decodes_of else 1
            check_dptnet_launches(grew, routes, f"{tag} request {os.path.basename(wav)} "
                                  f"({dtype})", decodes=decodes, decode=decode_of(dtype))
            log(f"  {dtype} {os.path.basename(wav)}: 2 sources x {n_in} samples, launches by "
                f"route {routes_of(grew)}, fused_mask_decode {decodes} ({decode_of(dtype)})")
            outputs[(dtype, wav)] = est
    launches = all_counts()
    log(f"  {tag} serving launches: {nonzero(launches)}")
    return outputs, launches


def serve_dptnet(tag, ckpt, wavs, causal):
    """serve_routed with DPTNet's routes (dptnet_routes at B = 1) and decode path."""
    return serve_routed(tag, ckpt, wavs, lambda n, dtype: dptnet_routes(1, n, causal, dtype),
                        lambda dtype: decode_path(tag, dtype))


class SpanClock:
    """CUDA events around every call of a model's modules of the given classes (forward
    hooks), so a forward's time in them is the sum of their spans (the device runs them in
    order): MultiheadAttention for the attention, the LSTM for the recurrences (its input
    projection and flips included)."""

    def __init__(self, model, classes):
        self.spans, self.handles = [], []
        for m in model.modules():
            if isinstance(m, classes):
                self.handles.append(m.register_forward_pre_hook(self._start))
                self.handles.append(m.register_forward_hook(self._end))

    def _start(self, module, args):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.spans.append([event, None])

    def _end(self, module, args, out):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.spans[-1][1] = event

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)

    def close(self):
        for h in self.handles:
            h.remove()


DECODE_KERNEL = re.compile(r"mask_decode_kernel|rows_kernel|(?<!scan_)mma_kernel")


def forward_profile(model, dtype, what, per_forward, decode, card, decodes=1):
    """The B = 8 x 4 s forward in `dtype`: ms (median of 3 after one warm-up), its launches
    by route (each held to `per_forward`, the "kernel/route" counts of one forward, and
    `decodes` fused_mask_decode on `decode`), then one profiled forward: device busy and idle share,
    the recurrence kernels' and the decode's device time (torch.profiler), the attention's
    (CUDA events around each MultiheadAttention call) and the rest. -> (numbers,
    launches)."""
    from torch.profiler import ProfilerActivity, profile

    B, n = 8, 4 * SAMPLE_RATE
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((B, 1, n), dtype=np.float32))
    x = x.to("cuda", dtype)
    what = f"{what} B=8 x 4 s {str(dtype)[6:]}"
    torch.cuda.reset_peak_memory_stats()
    before = all_counts()
    with torch.inference_mode():
        ms = median_ms(lambda: model(x), warmup=1, iters=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        clocks = (SpanClock(model, MultiheadAttention), SpanClock(model, LSTM))
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                start = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - start) * 1e3
            attention, lstm_spans = (clock.ms() for clock in clocks)
        finally:
            for clock in clocks:
                clock.close()
    launches = grown(before)  # the four timed forwards and the profiled one
    check_dptnet_launches(launches, {k: 5 * v for k, v in per_forward.items()}, what,
                          decodes=5 * decodes, decode=decode)
    device = device_times(prof)
    busy = sum(device.values())
    recurrence = sum(t for k, t in device.items() if any(n in k for n in FORWARD_KERNELS))
    decoding = sum(t for k, t in device.items() if DECODE_KERNEL.search(k))
    idle = max(0.0, 1 - busy / wall)
    rest = busy - recurrence - attention - decoding
    # The profiler can lose the records of long kernels: where it recorded fewer recurrence
    # kernels than the forward launched, its busy time and idle share are not measurements.
    from torch.autograd import DeviceType

    recorded = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                   and any(n in e.name for n in FORWARD_KERNELS))
    launched = sum(n for k, n in per_forward.items() if not k.endswith("/padded"))
    lost = recorded < launched
    idle_text = (f"not measured (the profiler recorded {recorded} of {launched} recurrence "
                 "launches)" if lost else f"{idle:.1%}")
    log(f"  {what}: {ms:.3f} ms a forward (median of 3), {B * 4.0 / (ms / 1e3):.1f} "
        f"audio-s/s, peak {peak:.1f} MiB; launches a forward by route {per_forward}; "
        f"profiled forward: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{idle_text}; "
        f"recurrence kernels {recurrence:.3f} ms ({recurrence / busy:.1%}), LSTM calls "
        f"{lstm_spans:.3f} ms of CUDA-event spans, attention {attention:.3f} ms of CUDA-event "
        f"spans ({attention / busy:.1%}), decode {decoding:.3f} ms ({decoding / busy:.1%}), "
        f"the rest {rest:.3f} ms [{card}]")
    top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
    log("    top device time: " + ", ".join(f"{k[:48]} {t:.3f} ms" for k, t in top))
    return dict(ms=ms, peak_mib=peak, wall_ms=wall, busy_ms=busy,
                idle_share=None if lost else idle, recurrence_ms=recurrence,
                lstm_span_ms=lstm_spans, attention_ms=attention, decode_ms=decoding), launches


def lstm_kernel_timing(model, label, B, T, H, chains, dtype, training, features,
                       tiles=False, check_steps=None):
    """One LSTM forward kernel at a model's shape on its planned route against the plain
    version (hs, and cs when `training`), REPEATS more launches checked; timed alone from
    CUDA graphs, with the FMA kernel forced and checked in the same run where the plan
    takes another route (FMA, route, route, FMA), beside the plain version, cuDNN's
    nn.LSTM (the model's input width `features`) and the bound. A padded route (H = 500 on
    the cluster kernel at 512) is held to the FMA kernel's hs (and cs) too, and timed whole,
    its pads and slices included, as `ms`, the kernel alone as `kernel_ms`. With `tiles`,
    every tf32x3 tile too, held to the same plain run (tf32_tiles). With `check_steps`, the
    plain version runs over each chain's first check_steps steps only and the launches are
    held to it there (a chain's output at step t depends on its first t + 1 inputs alone,
    so those steps are the same computation), and its time is of those steps
    (`plain_steps`); the planned route is then held over all T steps to the FMA kernel."""
    name = "lstm_scan_bidir" if chains == 2 else "lstm_scan"
    inputs = lstm_chains(B, T, H, chains, dtype, seed=B + T)
    path, tile = plan(ls, B, chains, H, dtype)
    width = ls.launch_width(H, path)
    what = f"{name} {model} {label} (B={B}, T={T}, H={H}) {str(dtype)[6:]}"
    hs, cs, launch = ls._staged_forward(inputs, training, path)
    padded = ls.PADDED_LAUNCHES[name]
    on_path(ls.PATH_LAUNCHES[name], name, launch, path)
    check(ls.PADDED_LAUNCHES[name] - padded == (width != H),
          f"{what}: {ls.PADDED_LAUNCHES[name] - padded} padded launches at width {width}")
    # The plain (hs, cs), timed as the plain version (with cs when `training`, as the kernel).
    plain = ls.lstm_forward_reference if training else (
        lambda xw, w: (ls.lstm_scan_reference(xw, w), None))
    steps = check_steps or T
    refs, plain_ms = timed_once(lambda: [plain(xw[:, :steps], w) for xw, w in inputs])

    def error_of(hs, cs):
        return forward_error_of(refs, [h[:, :steps] for h in hs],
                                [c[:, :steps] for c in cs] if training else None, dtype)

    err, limit = error_of(hs, cs)
    worst = err
    for _ in range(REPEATS if path != "fma" else 2):
        launch()
        worst = max(worst, error_of(hs, cs)[0])
    log(f"  {what} {path} ({tile_label(tile)}{', with cs' if training else ''}): "
        f"max|kernel-plain| {err:.3e}, worst of the launches {worst:.3e} (limit {limit:.3g})"
        + (f" over the first {steps} of {T} steps" if steps < T else ""))
    check(worst <= limit, f"{what} disagrees with plain: {worst} > {limit}")
    repeats = CLUSTER_REPEATS if path == "cluster" else 1
    timing = dict(path=path, max_abs_err=err)
    if width != H:
        timing["padded_width"] = width
    if path == "cluster":
        timing["cluster"] = tile[1]
    elif path == "wide":
        timing["tile"] = list(tile)
    if tiles:
        timing["tiles_ms"] = tf32_tiles(inputs, training, dtype, refs, steps)
    if path == "fma":  # a long launch: fewer timed replays
        timing["ms"] = graph_ms(launch, repeats, iters=5)
    else:
        fma_hs, fma_cs, fma = ls._staged_forward(inputs, training, "fma")
        on_path(ls.PATH_LAUNCHES[name], name, fma, "fma")
        timing["fma_max_abs_err"], _ = error_of(fma_hs, fma_cs)
        check(timing["fma_max_abs_err"] <= limit, f"{what}: FMA disagrees with plain")
        # The padded route, or the route over all T steps where the plain version ran over
        # the first check_steps only, against the FMA kernel's whole output, same limit.
        if width != H or steps < T:
            fma_refs = [(h, c) for h, c in zip(fma_hs, fma_cs or [None] * chains)]
            vs_fma, vs_limit = forward_error_of(fma_refs, hs, cs if training else None, dtype)
            log(f"    {'padded ' if width != H else ''}{path} vs the FMA kernel over all "
                f"{T} steps: max|diff| {vs_fma:.3e} (limit {vs_limit:.3g})")
            check(vs_fma <= vs_limit, f"{what}: {path} disagrees with FMA: {vs_fma}")
            timing["vs_fma_max_abs_err"] = vs_fma
        turns = (graph_ms(fma, 1), graph_ms(launch, repeats), graph_ms(launch, repeats),
                 graph_ms(fma, 1))
        timing.update(ms=(turns[1] + turns[2]) / 2, fma_ms=(turns[0] + turns[3]) / 2)
        if width != H:  # the whole call: pads, the kernel, the slices copied out
            whole = (lambda: ls._forward_cuda(inputs, training))
            timing["kernel_ms"] = timing["ms"]
            timing["ms"] = graph_ms(whole, repeats)
            log(f"    padded to {width}: whole call {timing['ms']:.4f} ms, kernel alone "
                f"{timing['kernel_ms']:.4f} ms (pads and slices "
                f"{(timing['ms'] - timing['kernel_ms']) / timing['ms']:.1%} of the call)")
    timing["plain_ms"] = plain_ms
    if steps < T:
        timing["plain_steps"] = steps
    timing["library_ms"] = library_lstm_ms(B, T, H, chains, dtype, features=features,
                                           iters=10)
    # The wide and tf32x3 routes' f32 product is three TF32 products at the tensor cores'
    # TF32 peak.
    tf32 = 3 if path in ("wide", "tf32x3") and dtype == torch.float32 else 0
    timing.update(recurrence_bound(B, T, H, 4, chains, cell_state=training, dtype=dtype,
                                   tf32=tf32))
    log(f"    {path} {timing['ms']:.4f} ms" + (f" (FMA forced {timing['fma_ms']:.4f} ms)"
                                                if "fma_ms" in timing else "")
        + f", plain {timing['plain_ms']:.4f} ms, cuDNN nn.LSTM {timing['library_ms']:.4f} ms "
        f"(F={features}, median of 10), bound {timing['bound_ms']:.4f} ms ({timing['bound_by']})")
    return timing, inputs, hs, cs


def autograd_case(inputs, hs, cs):
    """The backward of one or two (xw, w_hh) chains whose forward gave hs and cs, under
    autograd through the public wrapper -> (kernel name, grads_of() giving the gradients in
    lstm_scan_bwd_reference's order, the plain version's chains (with the cotangents))."""
    B, T, _ = inputs[0][0].shape
    H, dtype = inputs[0][1].shape[0], inputs[0][0].dtype
    gen = torch.Generator(device="cuda").manual_seed(B + T + 1)
    grads = [torch.randn(B, T, H, device="cuda", generator=gen).to(dtype) for _ in inputs]
    kname = "lstm_scan_bidir_bwd" if len(inputs) == 2 else "lstm_scan_bwd"
    leaves = [t.clone().requires_grad_() for c in inputs for t in c]
    fn = ls.lstm_scan_bidir if len(inputs) == 2 else ls.lstm_scan

    def grads_of():
        outs = fn(*leaves[0::2], *leaves[1::2])
        return torch.autograd.grad(outs if len(grads) == 2 else (outs,), leaves, grads)

    return kname, grads_of, [(xw, w, h, c, g) for (xw, w), h, c, g in zip(inputs, hs, cs, grads)]


def autograd_backward(label, inputs, hs, cs, timed, features=UMX["hidden_channels"],
                      tiles=False):
    """autograd_case's backward on its planned route against lstm_scan_bwd_reference
    (check_backward; timed whole and alone beside the FMA backward if `timed`, the plain
    version's time that of computing the reference; cuDNN's backward at `features`, none
    if None; with `tiles`, every split-TF32 tile held to the same reference,
    tf32_bwd_tiles) -> check_backward's timing."""
    kname, grads_of, plain_chains = autograd_case(inputs, hs, cs)
    ref, plain_ms = timed_once(
        lambda: [d for c in plain_chains for d in ls.lstm_scan_bwd_reference(*c)])
    timing = check_backward(ls, kname, label, grads_of, plain_chains, ref, plain_ms,
                            timed=timed, features=features)
    if tiles:
        timing["tiles_kernel_ms"] = tf32_bwd_tiles(plain_chains, ref)
    return timing


def lstm_backward_timing(model, label, inputs, hs, cs, features, tiles=False):
    """The backward at a model's training shape under autograd on its planned route against
    lstm_scan_bwd_reference; timed whole and alone beside the FMA backward
    (autograd_backward), or, where the plan takes the FMA backward itself, each timed once
    (median of 5); with cuDNN's nn.LSTM backward at the model's input width `features` and
    the route's bounds (the wide and tensor-core routes' recurrent product as TF32
    products); `tiles` goes to autograd_backward."""
    B, T, _ = inputs[0][0].shape
    H, dtype = inputs[0][1].shape[0], inputs[0][0].dtype
    chains = len(inputs)
    path = plan_bwd(ls, B, chains, H, dtype)[0]
    what = f"{model} {label} (B={B}, T={T}, H={H}) {str(dtype)[6:]}"
    if path == "fma":
        timing = fma_backward_timing(what, inputs, hs, cs)
    else:
        timing = autograd_backward(what, inputs, hs, cs, timed=True, features=None,
                                   tiles=tiles)
    timing["path"] = path
    if ls.launch_width(H, path) != H:
        timing["padded_width"] = ls.launch_width(H, path)
    timing["library_ms"] = library_lstm_bwd_ms(B, T, H, chains, dtype, features=features)
    tf32 = {"wide": 3, "tf32x3": 3, "tf32x2": 2}.get(path, 0)
    timing.update(recurrence_bound(B, T, H, 4, chains, backward=True, cell_state=True,
                                   dtype=dtype, tf32=tf32))
    timing["kernel_bound_ms"] = backward_kernel_bound(
        B, T, H, 4, chains, dtype, tf32 or 1, peak="tf32" if tf32 else torch.float32)["bound_ms"]
    if tf32:
        timing["fma_bound_ms"] = recurrence_bound(B, T, H, 4, chains, backward=True,
                                                  cell_state=True, dtype=dtype)["bound_ms"]
    log(f"    cuDNN nn.LSTM backward {timing['library_ms']:.4f} ms (F={features}); bound "
        f"{timing['bound_ms']:.4f} ms whole, {timing['kernel_bound_ms']:.4f} ms the kernel")
    return timing


def fma_backward_timing(label, inputs, hs, cs):
    """The FMA backward (the plan's route) under autograd against lstm_scan_bwd_reference
    (check_backward), then the whole backward (the gate recompute, the kernel, d_W_hh) and
    the kernel alone, each a median of 5 after one warm-up, beside the plain version (the
    reference's one run, between CUDA events)."""
    kname, grads_of, plain_chains = autograd_case(inputs, hs, cs)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = [d for c in plain_chains for d in ls.lstm_scan_bwd_reference(*c)]
    end.record()
    end.synchronize()
    check_backward(ls, kname, label, grads_of, plain_chains, ref, None, timed=False)
    errs = grad_errors(kname, grads_of(), ref, hs[0].dtype)
    whole = median_ms(lambda: ls._backward_cuda(plain_chains, "fma"), warmup=1, iters=5)
    alone = median_ms(ls._staged_backward(plain_chains, "fma")[1], warmup=1, iters=5)
    timing = dict(max_abs_err=max(x for x, _ in errs), ms=whole, kernel_ms=alone,
                  plain_ms=start.elapsed_time(end))
    log(f"    fma: whole backward {whole:.4f} ms, kernel alone {alone:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms (CUDA events)")
    return timing


def phase_dptnet_kernels(card=None):
    """Phase 13's kernels: every LSTM launch DPTNet's main path makes, at its shapes, against
    the plain version, timed. -> {(name, label, dtype): timing}."""
    card = card or card_line()
    log("== phase 13: DPTNet's recurrences at its shapes vs plain on the card (kernels from "
        f"CUDA graphs, CUDA events) [{card}]")
    result = {}
    for label, (B, T, chains), dtypes, training in DPT_SHAPES:
        name = "lstm_scan_bidir" if chains == 2 else "lstm_scan"
        for dtype in dtypes:
            timing, inputs, hs, cs = lstm_kernel_timing("DPTNet", label, B, T, DPT_H, chains,
                                                        dtype, training, DPT_E)
            result[(name, label, dtype)] = timing
            if training:
                result[(f"{name}_bwd", label, dtype)] = lstm_backward_timing(
                    "DPTNet", label, inputs, hs, cs, DPT_E)
            del inputs, hs, cs
    return result


def dptnet_train_parity():
    """One DPTNet train step on the card against an f64 CPU step (and the f32 CPU step):
    the recipe's widths (N64, bottleneck 64, H256, K100, four heads) at two blocks and
    B = 1 x 0.25 s, so the f64 reference fits the host; non-causal and causal. -> the two card
    steps' launches (the main path's one-chain backward is the causal step's)."""
    log("== phase 13: one DPTNet train step, card vs CPU (f32, TF32 off, recipe widths, 2 "
        "blocks, B=1 x 0.25 s; f64 CPU reference)")
    n = SAMPLE_RATE // 4
    launches = {}
    for causal in (False, True):
        tag = f"dptnet{'_causal' if causal else ''}"
        cpu_model = dptnet_model(causal, "cpu", blocks=2)
        batch = train_batch(1, 0.25, "cpu")
        ref = grads_of_step(copy.deepcopy(cpu_model).double(), tuple(t.double() for t in batch))
        cpu = grads_of_step(cpu_model, batch)
        reset_counts()
        card_step = grads_of_step(dptnet_model(causal, blocks=2), train_batch(1, 0.25, "cuda"))
        torch.cuda.synchronize()
        grew = all_counts()
        routes = {k: v // DPT_BLOCKS * 2 for k, v in
                  dptnet_routes(1, n, causal, torch.float32, backward=True).items()}
        check_dptnet_launches(grew, routes, f"{tag}: a train step")
        check_step_against_f64(tag, ref, cpu, card_step, kernels_of(grew))
        log(f"    launches by route: {routes_of(grew)}")
        launches = add_counts(launches, grew)
    return launches


def dptnet_train_cli(tmp, card):
    """cli/train_wsj0mix.py --model dptnet at the recipe (B = 2 x 4 s, f32) with
    --warmup_steps on a synthetic corpus, 2 epochs of at least 5 steps: every step and
    validation forward on its routes, the epoch train loss falling; then its checkpoint
    through cli/separate.py and cli/test_wsj0mix.py on the card; and the recipe step's
    p50 split by CUDA events with its idle share. -> (launches, checkpoint)."""
    log("== phase 13: train DPTNet through cli/train_wsj0mix.py (recipe, B=2 x 4 s, f32, "
        f"--warmup_steps {DPT_WARMUP})")
    corpus = os.path.join(tmp, "dpt_corpus")
    tr_root, tr_list = write_quality_corpus(corpus, "tr", DPT_TRAIN_UTTS)
    cv_root, cv_list = write_quality_corpus(corpus, "cv", 1)
    exp = os.path.join(tmp, "exp_dptnet")
    argv = ["--train_wav_root", tr_root, "--train_list_path", tr_list, "--valid_wav_root",
            cv_root, "--valid_list_path", cv_list, "--duration", "4", "--valid_duration", "4",
            "--device", "cuda", "--model", "dptnet", "-N", "64", "-L", "2", "-K", "100",
            "--sep_num_blocks", "6", "--sep_num_heads", "4", "--sep_bottleneck_channels", "64",
            "--sep_hidden_channels", "256", "--mask_nonlinear", "relu", "--batch_size", "2",
            "--warmup_steps", str(DPT_WARMUP), "--epochs", "2", "--exp_dir", exp]
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        trainer = train_cli.main(argv)
    grew = all_counts()
    steps = 2 * len(trainer.train_loader)
    check(steps >= 10, f"the DPTNet CLI run took {steps} steps, fewer than 10")
    routes = {k: steps * v for k, v in
              dptnet_routes(2, 4 * SAMPLE_RATE, False, torch.float32, backward=True).items()}
    evals = 0
    for mixture, _ in trainer.valid_loader:  # B = 1, each utterance's own length
        routes = add_counts(routes, {k: 2 * v for k, v in dptnet_routes(
            1, np.shape(mixture)[-1], False, torch.float32).items()})
        evals += 2
    check_dptnet_launches(grew, routes, "the DPTNet CLI run", decodes=evals,
                          decode=decode_path("dptnet", "float32"))
    losses = trainer.train_loss
    log(f"  {steps} steps, {evals} validation forwards: train loss by epoch "
        f"{[round(v, 4) for v in losses]}, valid {[round(v, 4) for v in trainer.valid_loss]}; "
        f"the CLI's last lines: " + " | ".join(out.getvalue().strip().splitlines()[-2:]))
    log(f"    launches by route: {routes_of(grew)}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the DPTNet CLI's epoch train loss did not fall: {losses}")
    ckpt = os.path.join(exp, "model", "last.ckpt")
    launches = all_counts()

    log("  serve and evaluate the trained DPTNet checkpoint on the card")
    wav = write_mixtures(tmp)[-1]
    _, served = serve_dptnet("trained_dptnet", ckpt, [wav], False)
    launches = add_counts(launches, served)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        card_metrics = test_cli.main(["--test_wav_root", cv_root, "--test_list_path", cv_list,
                                      "--model_path", ckpt, "--device", "cuda"])
        cpu_metrics = test_cli.main(["--test_wav_root", cv_root, "--test_list_path", cv_list,
                                     "--model_path", ckpt, "--device", "cpu"])
    evaluated = all_counts()
    check(evaluated["fused_mask_decode"] >= 1, "the evaluation launched no decode")
    launches = add_counts(launches, evaluated)
    diffs = {k: abs(card_metrics[k] - cpu_metrics[k]) for k in TEST_METRICS}
    log(f"  cli/test_wsj0mix.py card vs CPU: " + ", ".join(
        f"{k} {card_metrics[k]:.4f} / {cpu_metrics[k]:.4f}" for k in TEST_METRICS)
        + f" (limit {EVAL_TOL_DB} dB each)")
    check(all(d <= EVAL_TOL_DB for d in diffs.values()), f"evaluation card vs CPU: {diffs}")

    log(f"  the recipe step (B=2 x 4 s, f32, the warmup schedule): p50 split [{card}]")
    model = dptnet_model(False)
    optimizer = make_warmup_optimizer(0.2, 4e-4, DPT_E, DPT_WARMUP, 10,
                                      max_norm=5.0, params=model.parameters())
    criterion = PIT1d(NegSISDR(), n_sources=2)
    mixture, sources = train_batch(2, 4.0, "cuda")
    model.train()
    step = evented_step(lambda: criterion(model(mixture), sources)[0], optimizer)
    splits, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + 5):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        start = time.perf_counter()
        step(events)
        torch.cuda.synchronize()
        if i >= 1:
            walls.append((time.perf_counter() - start) * 1e3)
            splits.append([events[j].elapsed_time(events[j + 1]) for j in range(3)])
    fwd, bwd, opt = (float(np.median([s[j] for s in splits])) for j in range(3))
    p50 = float(np.median(walls))
    log(f"    p50 step {p50:.3f} ms of 5 (forward + loss {fwd:.3f}, backward {bwd:.3f}, "
        f"optimizer {opt:.3f} ms, CUDA events), {2 * 4.0 / (p50 / 1e3):.1f} audio-s/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
    step_routes = dptnet_routes(2, 4 * SAMPLE_RATE, False, torch.float32, backward=True)
    profile_train_step(
        lambda: criterion(model(mixture), sources)[0], optimizer, "DPTNet (B=2 x 4 s, f32)",
        card, lambda g: check(routes_of(g) == {k: v for k, v in step_routes.items()
                                               if k.split("/")[0].endswith("_bwd")},
                              f"the profiled DPTNet backward launched {routes_of(g)}"))
    return launches, ckpt


def phase_dptnet(card=None, tmp=None):
    """Phase 13, DPTNet on wsj0-2mix -> {"launches": the main path's counts (serving, the
    B = 8 forwards, the CLI's training, serving and evaluation), "kernels": the timings of
    phase_dptnet_kernels}."""
    card = card or card_line()
    with contextlib.ExitStack() as stack:
        tmp = tmp or stack.enter_context(tempfile.TemporaryDirectory())
        wavs = write_mixtures(tmp)
        total = {}
        ckpts = {}
        for causal in (False, True):
            tag = f"dptnet{'_causal' if causal else ''}"
            log(f"== phase 13: serve recipe-config DPTNet, causal={causal}, through "
                "cli/separate.py")
            ckpts[tag] = os.path.join(tmp, f"{tag}.pth")
            make_checkpoint(ckpts[tag], DPTNet(**dict(DPTNET, causal=causal), device="cuda",
                                               generator=torch.Generator().manual_seed(0)))
            outputs, launches = serve_dptnet(tag, ckpts[tag], wavs, causal)
            total = add_counts(total, launches)
            phase_parity(tag, ckpts[tag], wavs, outputs)
        log(f"== phase 13: DPTNet's B=8 x 4 s forward, ms and where the device time goes [{card}]")
        forwards = {}
        for tag, ckpt in ckpts.items():
            model = load_model(ckpt, device="cuda")
            causal = tag.endswith("causal")
            for dtype in (torch.float32, torch.bfloat16):  # .to converts the model in place
                reset_counts()
                forwards[(tag, dtype)], launches = forward_profile(
                    model.to(dtype), dtype, "DPTNet causal" if causal else "DPTNet",
                    dptnet_routes(8, 4 * SAMPLE_RATE, causal, dtype),
                    decode_path("dptnet", dtype), card)
                total = add_counts(total, launches)
            del model
        total = add_counts(total, dptnet_train_parity())
        trained, _ = dptnet_train_cli(tmp, card)
        total = add_counts(total, trained)
    log("== phase 13: the bench module, --model dptnet (informational; in this process, its "
        "line kept off stdout)")
    for flags in ([], ["--dtype", "float32"]):
        with contextlib.redirect_stdout(io.StringIO()), bench_iters(BENCH_LINE_ITERS):
            line = bench_main(["--model", "dptnet", *flags])
        check(line["value"] > 0 and line["mfu"] > 0, line)
        log(f"  bench --model dptnet {' '.join(flags)}: {json.dumps(line)}")
    kernels = phase_dptnet_kernels(card)
    log(f"  phase 13 main-path launches: {nonzero(total)}")
    return dict(launches=total, kernels=kernels, forwards=forwards)


# Phase 14: LSTM-TasNet, SepFormer and GALRNet on wsj0-2mix at the recipe configs
# (bench.LSTM_TASNET, SEPFORMER, GALRNET: egs/wsj0-mix/{lstm-tasnet,sepformer,galrnet}/
# train.sh), seed-0 weights. At B = 8 x 4 s LSTM-TasNet (T' = 1599 frames) runs its four
# LSTM layers (2 blocks x 2) over 8 sequences at H = 500: the cluster kernels on the call
# zero-padded to H = 512 (ls.cluster_width), since H = 500 is neither a multiple of 16 (the
# tensor cores) nor of 128 (the cluster route unpadded). GALRNet
# (T' = 3999, padded to 79 chunks of 100) runs six intra-chunk biLSTMs over 632 sequences
# at H = 128 (the tensor cores) and attends over 256 sequences of 79 chunks; SepFormer
# (31 chunks of 250) runs no recurrence. Recipe training (B = 4) halves the sequences.
SLICE_D = {"lstm_tasnet": (LSTMTasNet, LSTM_TASNET), "sepformer": (SepFormer, SEPFORMER),
           "galrnet": (GALRNet, GALRNET)}
SLICE_D_NAMES = {"lstm_tasnet": "LSTM-TasNet", "sepformer": "SepFormer", "galrnet": "GALRNet"}
# The recipes' CLI flags (egs/wsj0-mix/<model>/train.sh), at the CLI's default batch of 4.
SLICE_D_CLI = {
    "lstm_tasnet": ["--model", "lstm-tasnet", "-N", "500", "-L", "40", "--enc_basis",
                    "trainableGated", "--sep_num_blocks", "2", "--sep_num_layers", "2",
                    "--sep_hidden_channels", "500", "--mask_nonlinear", "softmax"],
    "sepformer": ["--model", "sepformer", "-N", "256", "-L", "16", "-K", "250",
                  "--sep_hop_size", "125", "--sep_num_blocks", "2", "--sep_num_layers", "8",
                  "--sep_num_heads", "8", "--sep_bottleneck_channels", "256",
                  "--mask_nonlinear", "relu"],
    "galrnet": ["--model", "galrnet", "-N", "64", "-L", "16", "-K", "100", "--sep_hop_size",
                "50", "-Q", "32", "--sep_num_blocks", "6", "--sep_num_heads", "8",
                "--sep_hidden_channels", "128", "--mask_nonlinear", "relu"],
}
SLICE_D_TRAIN_UTTS = 15  # synthetic train utterances: 20 windows of 4 s
SLICE_D_CLI_STEPS = 5  # steps of B = 4 an epoch
SLICE_D_PARITY_DEPTH = {  # the train step against f64 (B = 1 x 1 s) at a small depth
    "lstm_tasnet": dict(sep_num_blocks=1),
    "sepformer": dict(sep_num_blocks=1, sep_num_layers_intra=2, sep_num_layers_inter=2),
    "galrnet": dict(sep_num_blocks=2),
}
# The recurrences at the new shapes, phase 14k: (model, label, (B, T, H, chains), dtypes,
# training: cs written and the backward checked).
SLICE_D_SHAPES = [
    ("lstm_tasnet", "serve", (8, 1599, 500, 2), (torch.float32, torch.bfloat16), False),
    ("lstm_tasnet", "serve causal", (8, 1599, 500, 1), (torch.float32, torch.bfloat16), False),
    ("lstm_tasnet", "train", (4, 1599, 500, 2), (torch.float32, torch.bfloat16), True),
    ("lstm_tasnet", "train causal", (4, 1599, 500, 1), (torch.float32, torch.bfloat16), True),
    ("galrnet", "serve intra", (632, 100, 128, 2), (torch.float32, torch.bfloat16), False),
    ("galrnet", "train intra", (316, 100, 128, 2), (torch.float32, torch.bfloat16), True),
]
SLICE_D_FEATURES = {"lstm_tasnet": 500, "galrnet": 64}  # the first LSTM layer's input width


def slice_d_frames(tag, n_samples):
    """T': the latent frames of one n-sample input after the stride-grid pad."""
    cfg = SLICE_D[tag][1]
    L = cfg["kernel_size"]
    stride = cfg.get("stride") or L // 2
    return (n_samples + (stride - (n_samples - L) % stride) % stride - L) // stride + 1


def slice_d_chunks(tag, n_samples):
    """S: the chunks of K frames at hop P after the symmetric chunk-grid pad."""
    cfg = SLICE_D[tag][1]
    K, P = cfg["sep_chunk_size"], cfg["sep_hop_size"]
    frames = slice_d_frames(tag, n_samples)
    return (frames + (P - (frames - K) % P) % P - K) // P + 1


def slice_d_routes(tag, B, n_samples, causal, dtype, backward=False, **depth):
    """The recurrence launches of one forward (and its backward) on (B, 1, n), by
    "kernel/route": LSTM-TasNet's blocks x layers LSTM layers over B sequences of T' steps
    (one chain when causal), GALRNet's intra-chunk biLSTM over B·S sequences of K steps a
    block (bidirectional whether causal or not), none for SepFormer; each on the route
    _plan (_plan_bwd) gives its shape on this card, and "kernel/padded" for the launches
    that run zero-padded (LSTM-TasNet's H = 500 at 512). `depth` overrides the config's."""
    cfg = dict(SLICE_D[tag][1], **depth)
    if tag == "lstm_tasnet":
        name = "lstm_scan" if causal else "lstm_scan_bidir"
        rows, chains, H = B, 1 + (not causal), cfg["sep_hidden_channels"]
        count = cfg["sep_num_blocks"] * cfg["sep_num_layers"]
    elif tag == "galrnet":
        name, chains, H = "lstm_scan_bidir", 2, cfg["sep_hidden_channels"]
        rows, count = B * slice_d_chunks(tag, n_samples), cfg["sep_num_blocks"]
    else:
        return {}
    paths = {name: plan(ls, rows, chains, H, dtype)[0]}
    if backward:
        paths[f"{name}_bwd"] = plan_bwd(ls, rows, chains, H, dtype)[0]
    # LSTM-TasNet's H = 500 takes the cluster kernels padded to 512, GALRNet's H = 128 the
    # tensor cores: no FMA kernel.
    check(all((p == "cluster") == (tag == "lstm_tasnet") and p != "fma"
              for p in paths.values()), f"{tag} at H = {H}, {rows} sequences: routes {paths}")
    routes = {f"{kernel}/{p}": count for kernel, p in paths.items()}
    routes.update({f"{kernel}/padded": count for kernel, p in paths.items()
                   if ls.launch_width(H, p) != H})
    return routes


def slice_d_decode(tag, dtype):
    """The fused_mask_decode path of a model's decode in `dtype` (ops/mask_decode.py:
    _plan): bf16 on the tensor cores ("mma") but for LSTM-TasNet, whose N = 500 is no
    multiple of 8 (and whose bf16 rows of 1000 bytes are not 16-byte aligned): "generic";
    every f32 decode of the three on "generic"."""
    bf16 = dtype in ("bfloat16", torch.bfloat16)
    return "mma" if bf16 and tag != "lstm_tasnet" else "generic"


def slice_d_model(tag, causal, device="cuda", **depth):
    cls, cfg = SLICE_D[tag]
    return scramble_norms(cls(**dict(cfg, causal=causal, **depth),
                              generator=torch.Generator().manual_seed(0), device=device))


def slice_d_serve(tmp, wavs, card):
    """Serving: each model, causal and not, through cli/separate.py in f32 and bf16 (each
    request held to its routes), card vs CPU and bf16 vs f32 (phase 5); then causal
    LSTM-TasNet with the trainable encoder streamed through --streaming_hop (one decode a
    separator call, no recurrence kernel: the carried LSTMs run the plain step loop),
    streamed vs offline, ms a hop. -> (launches, checkpoints)."""
    launches, ckpts = {}, {}
    for tag in SLICE_D:
        for causal in (False, True):
            key = f"{tag}{'_causal' if causal else ''}"
            log(f"== phase 14: serve recipe-config {SLICE_D_NAMES[tag]}, causal={causal}, "
                "through cli/separate.py")
            ckpts[key] = os.path.join(tmp, f"{key}.pth")
            save_model(ckpts[key], slice_d_model(tag, causal))
            outputs, served = serve_routed(
                key, ckpts[key], wavs,
                lambda n, dtype, tag=tag, causal=causal: slice_d_routes(tag, 1, n, causal, dtype),
                lambda dtype, tag=tag: slice_d_decode(tag, dtype))
            launches = add_counts(launches, served)
            phase_parity(key, ckpts[key], wavs, outputs)
    tag = "lstm_tasnet_stream"
    log(f"== phase 14: stream causal LSTM-TasNet (trainable encoder) through cli/separate.py "
        f"--streaming_hop {STREAMING_HOP}")
    ckpt = os.path.join(tmp, f"{tag}.pth")
    save_model(ckpt, slice_d_model("lstm_tasnet", True, enc_basis="trainable"))
    flags = ["--streaming_hop", str(STREAMING_HOP)]
    L, S = LSTM_TASNET["kernel_size"], LSTM_TASNET["kernel_size"] // 2
    outputs, streamed = serve_routed(tag, ckpt, wavs, lambda n, dtype: {},
                                     lambda dtype: slice_d_decode("lstm_tasnet", dtype), flags,
                                     decodes_of=lambda n: stream_calls(n, L, S, 1)[0])
    launches = add_counts(launches, streamed)
    phase_stream_offline(tag, ckpt, wavs, outputs, phase="14")
    phase_parity(tag, ckpt, wavs, outputs, flags=flags)
    log(f"  ms a hop of the streamed causal LSTM-TasNet (informational) [{card}]")
    for dtype in (torch.bfloat16, torch.float32):
        stream_hop_times(ckpt, wavs[-1], dtype, card)
    return launches, ckpts


def slice_d_forwards(ckpts, card):
    """The B = 8 x 4 s forward of each served checkpoint in both dtypes, every launch on its
    route, profiled (forward_profile). -> (numbers, launches)."""
    log(f"== phase 14: the B=8 x 4 s forward, ms and where the device time goes [{card}]")
    forwards, launches = {}, {}
    for key, ckpt in ckpts.items():
        tag, causal = key.replace("_causal", ""), key.endswith("causal")
        model = load_model(ckpt, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):  # .to converts the model in place
            reset_counts()
            forwards[(key, dtype)], grew = forward_profile(
                model.to(dtype), dtype, SLICE_D_NAMES[tag] + (" causal" if causal else ""),
                slice_d_routes(tag, 8, 4 * SAMPLE_RATE, causal, dtype),
                slice_d_decode(tag, dtype), card)
            launches = add_counts(launches, grew)
        del model
    return forwards, launches


def slice_d_train_parity():
    """One train step of each model on the card against an f64 CPU step (and the f32 CPU
    step), as phase 7: the recipe widths at a small depth (SLICE_D_PARITY_DEPTH), B = 1 x
    1 s; LSTM-TasNet causal too (the one-chain padded cluster backward at H = 500). -> the
    card steps' launches."""
    log("== phase 14: one train step a model, card vs CPU (f32, TF32 off, recipe widths at a "
        "small depth, B=1 x 1 s; f64 CPU reference)")
    launches = {}
    for tag, causal in (("lstm_tasnet", False), ("lstm_tasnet", True), ("sepformer", False),
                        ("galrnet", False)):
        key = f"{tag}{'_causal' if causal else ''}"
        depth = SLICE_D_PARITY_DEPTH[tag]
        cpu_model = slice_d_model(tag, causal, "cpu", **depth)
        batch = train_batch(1, 1.0, "cpu")
        ref = grads_of_step(copy.deepcopy(cpu_model).double(), tuple(t.double() for t in batch))
        cpu = grads_of_step(cpu_model, batch)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        card_step = grads_of_step(slice_d_model(tag, causal, **depth),
                                  train_batch(1, 1.0, "cuda"))
        torch.cuda.synchronize()
        grew = all_counts()
        log(f"  {key}: the card step's peak allocation "
            f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
        routes = slice_d_routes(tag, 1, SAMPLE_RATE, causal, torch.float32, backward=True,
                                **depth)
        check_dptnet_launches(grew, routes, f"{key}: a train step")
        # GALR's fc_map bias has a gradient of 0 but for rounding: the LayerNorm over the
        # channels after fc_map removes a constant added to every channel of a position.
        check_step_against_f64(key, ref, cpu, card_step, kernels_of(grew),
                               null_floor=1e-4 if tag == "galrnet" else 0.0)
        log(f"    launches by route: {routes_of(grew)}")
        launches = add_counts(launches, grew)
    return launches


def slice_d_train_cli(tag, tmp, card):
    """cli/train_wsj0mix.py at the recipe flags (B = 4 x 4 s, f32) on a synthetic corpus, 2
    epochs of 5 steps: every step and validation forward on its routes, the epoch train
    loss falling; its checkpoint served through cli/separate.py and evaluated through
    cli/test_wsj0mix.py card vs CPU; the recipe step's p50 split by CUDA events with its
    peak allocation and a profile with its idle share. -> launches."""
    name = SLICE_D_NAMES[tag]
    log(f"== phase 14: train {name} through cli/train_wsj0mix.py (recipe, B=4 x 4 s, f32)")
    corpus = os.path.join(tmp, "slice_d_corpus")
    tr_root, tr_list = write_quality_corpus(corpus, "tr", SLICE_D_TRAIN_UTTS)
    cv_root, cv_list = write_quality_corpus(corpus, "cv", 1)
    exp = os.path.join(tmp, f"exp_{tag}")
    argv = ["--train_wav_root", tr_root, "--train_list_path", tr_list, "--valid_wav_root",
            cv_root, "--valid_list_path", cv_list, "--duration", "4", "--valid_duration", "4",
            "--device", "cuda", *SLICE_D_CLI[tag], "--epochs", "2", "--exp_dir", exp]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        trainer = train_cli.main(argv)
    grew = all_counts()
    steps = 2 * len(trainer.train_loader)
    check(steps == 2 * SLICE_D_CLI_STEPS, f"the {name} CLI run took {steps} steps, not "
                                          f"{2 * SLICE_D_CLI_STEPS}")
    routes = {k: steps * v for k, v in
              slice_d_routes(tag, 4, 4 * SAMPLE_RATE, False, torch.float32,
                             backward=True).items()}
    evals = 0
    for mixture, _ in trainer.valid_loader:  # B = 1, each utterance's own length
        routes = add_counts(routes, {k: 2 * v for k, v in slice_d_routes(
            tag, 1, np.shape(mixture)[-1], False, torch.float32).items()})
        evals += 2
    check_dptnet_launches(grew, routes, f"the {name} CLI run", decodes=evals,
                          decode=slice_d_decode(tag, torch.float32))
    losses = trainer.train_loss
    log(f"  {steps} steps, {evals} validation forwards, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB: train loss by epoch "
        f"{[round(v, 4) for v in losses]}, valid {[round(v, 4) for v in trainer.valid_loss]}; "
        f"the CLI's last lines: " + " | ".join(out.getvalue().strip().splitlines()[-2:]))
    log(f"    launches by route: {routes_of(grew)}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the {name} CLI's epoch train loss did not fall: {losses}")
    ckpt = os.path.join(exp, "model", "last.ckpt")
    launches = all_counts()

    log(f"  serve and evaluate the trained {name} checkpoint on the card")
    wav = write_mixtures(tmp)[-1]
    _, served = serve_routed(f"trained_{tag}", ckpt, [wav],
                             lambda n, dtype: slice_d_routes(tag, 1, n, False, dtype),
                             lambda dtype: slice_d_decode(tag, dtype))
    launches = add_counts(launches, served)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        card_metrics = test_cli.main(["--test_wav_root", cv_root, "--test_list_path", cv_list,
                                      "--model_path", ckpt, "--device", "cuda"])
        cpu_metrics = test_cli.main(["--test_wav_root", cv_root, "--test_list_path", cv_list,
                                     "--model_path", ckpt, "--device", "cpu"])
    evaluated = all_counts()
    with open(cv_list) as f:
        utts = [line.strip() for line in f if line.strip()]
    routes = {}
    for utt in utts:  # one forward an utterance, at its own length
        n = read_wav(os.path.join(cv_root, "mix", f"{utt}.wav"))[0].shape[0]
        routes = add_counts(routes, slice_d_routes(tag, 1, n, False, torch.float32))
    check_dptnet_launches(evaluated, routes, f"the {name} evaluation", decodes=len(utts),
                          decode=slice_d_decode(tag, torch.float32))
    launches = add_counts(launches, evaluated)
    diffs = {k: abs(card_metrics[k] - cpu_metrics[k]) for k in TEST_METRICS}
    log(f"  cli/test_wsj0mix.py card vs CPU: " + ", ".join(
        f"{k} {card_metrics[k]:.4f} / {cpu_metrics[k]:.4f}" for k in TEST_METRICS)
        + f" (limit {EVAL_TOL_DB} dB each)")
    check(all(d <= EVAL_TOL_DB for d in diffs.values()), f"evaluation card vs CPU: {diffs}")

    log(f"  the recipe step (B=4 x 4 s, f32): p50 split [{card}]")
    model = slice_d_model(tag, False)
    optimizer = make_optimizer("adam", 1e-3, 5.0, params=model.parameters())
    criterion = PIT1d(NegSISDR(), n_sources=2)
    mixture, sources = train_batch(4, 4.0, "cuda")
    model.train()
    step = evented_step(lambda: criterion(model(mixture), sources)[0], optimizer)
    splits, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + 5):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        start = time.perf_counter()
        step(events)
        torch.cuda.synchronize()
        if i >= 1:
            walls.append((time.perf_counter() - start) * 1e3)
            splits.append([events[j].elapsed_time(events[j + 1]) for j in range(3)])
    fwd, bwd, opt = (float(np.median([s[j] for s in splits])) for j in range(3))
    p50 = float(np.median(walls))
    log(f"    p50 step {p50:.3f} ms of 5 (forward + loss {fwd:.3f}, backward {bwd:.3f}, "
        f"optimizer {opt:.3f} ms, CUDA events), {4 * 4.0 / (p50 / 1e3):.1f} audio-s/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
    step_routes = slice_d_routes(tag, 4, 4 * SAMPLE_RATE, False, torch.float32, backward=True)
    profile_train_step(
        lambda: criterion(model(mixture), sources)[0], optimizer, f"{name} (B=4 x 4 s, f32)",
        card, lambda g: check(routes_of(g) == {k: v for k, v in step_routes.items()
                                               if k.split("/")[0].endswith("_bwd")},
                              f"the profiled {name} backward launched {routes_of(g)}"))
    del model, optimizer
    return launches


def phase_slice_d_kernels(card=None):
    """Phase 14k: every recurrence shape of the three models' main paths against the plain
    version, timed (lstm_kernel_timing, lstm_backward_timing), and fused_mask_decode at the
    three decoder widths (decode_case: one whole call and the kernel alone, beside the
    generic kernel, the plain version and einsum). A padded route's rows also carry the
    cluster kernel's co-resident clusters at the padded width (`co_resident`) and the
    waves their sequences take (`waves`). -> {(name, model, label, dtype): timing} and
    {(model, dtype): decode timing}."""
    card = card or card_line()
    log("== phase 14k: the recurrences and decodes at LSTM-TasNet's, SepFormer's and "
        f"GALRNet's shapes vs plain on the card (CUDA graphs, CUDA events) [{card}]")
    width = ls.cluster_width(LSTM_TASNET["sep_hidden_channels"])
    counts = {False: ls._cluster_counts(width, "cuda"), True: ls._cluster_bwd_counts(width, "cuda")}
    log(f"  LSTM-TasNet's H = {LSTM_TASNET['sep_hidden_channels']} runs at H = {width}: "
        f"clusters the card holds at once, by blocks a cluster: the forward's {counts[False]}, "
        f"the backward's {counts[True]}")

    def waves(timing, B, chains, backward):
        if "padded_width" in timing and timing["path"] == "cluster":
            C = timing["cluster"]
            n = counts[backward][C]
            timing.update(co_resident=n, waves=-(-chains * B // n))
            log(f"    {chains} x {B} sequences on {n} co-resident {C}-block clusters: "
                f"{timing['waves']} wave(s)")

    result = {}
    for tag, label, (B, T, H, chains), dtypes, training in SLICE_D_SHAPES:
        name = "lstm_scan_bidir" if chains == 2 else "lstm_scan"
        for dtype in dtypes:
            timing, inputs, hs, cs = lstm_kernel_timing(
                SLICE_D_NAMES[tag], label, B, T, H, chains, dtype, training,
                SLICE_D_FEATURES[tag])
            waves(timing, B, chains, False)
            result[(name, tag, label, dtype)] = timing
            if training:
                timing = lstm_backward_timing(SLICE_D_NAMES[tag], label, inputs, hs, cs,
                                              SLICE_D_FEATURES[tag])
                waves(timing, B, chains, True)
                result[(f"{name}_bwd", tag, label, dtype)] = timing
            del inputs, hs, cs
    decodes = {}
    for tag, shape in SLICE_D_DECODE_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            decodes[(tag, dtype)] = decode_case(shape, True, dtype,
                                                f"{SLICE_D_NAMES[tag]} decoder shape")
    return dict(recurrences=result, decodes=decodes)


def phase_slice_d(card=None, tmp=None):
    """Phase 14, LSTM-TasNet, SepFormer and GALRNet on wsj0-2mix -> {"launches": the main
    path's counts (serving, streaming, the B = 8 forwards, the train steps, the CLIs'
    training, serving and evaluation), none on the FMA kernels, "kernels": the timings of
    phase_slice_d_kernels, "forwards"}."""
    card = card or card_line()
    kernels = phase_slice_d_kernels(card)  # the kernels at the new shapes before anything else
    with contextlib.ExitStack() as stack:
        tmp = tmp or stack.enter_context(tempfile.TemporaryDirectory())
        wavs = write_mixtures(tmp)
        total, ckpts = slice_d_serve(tmp, wavs, card)
        forwards, launches = slice_d_forwards(ckpts, card)
        total = add_counts(total, launches)
        total = add_counts(total, slice_d_train_parity())
        for tag in SLICE_D:
            total = add_counts(total, slice_d_train_cli(tag, tmp, card))
    log("== phase 14: the bench module, --model lstm-tasnet|sepformer|galrnet (informational; "
        "in this process, its line kept off stdout)")
    for tag in SLICE_D:
        for flags in ([], ["--dtype", "float32"]):
            with contextlib.redirect_stdout(io.StringIO()), bench_iters(BENCH_LINE_ITERS):
                line = bench_main(["--model", tag.replace("_", "-"), *flags])
            check(line["value"] > 0 and line["mfu"] > 0, line)
            log(f"  bench --model {tag.replace('_', '-')} {' '.join(flags)}: {json.dumps(line)}")
    fma = {k: n for k, n in total.items() if k.endswith("/fma") and n}
    check(not fma, f"phase 14 launched the FMA kernels {fma}")
    padded = {k: n for k, n in total.items() if k.endswith("/padded")}
    check(all(padded.values()), f"phase 14 launched no padded kernel of some of {padded}")
    log(f"  phase 14 main-path launches: {nonzero(total)}; no FMA launch; padded launches "
        f"(LSTM-TasNet's H = 500 at 512) {padded}")
    return dict(launches=total, kernels=kernels, forwards=forwards)


# Phase 15: the rest of the wsj0-mix zoo and musdb18's waveform models at their recipe widths,
# seed-0 weights with scrambled norm affines. wsj0-mix: DPRNN-TasNet (bench.DPRNN) with
# rnn_type "rnn" (the step loop) and "sru" (the doubling scan): plain PyTorch, no recurrence
# kernel, the decode on "rows" (f32) or "mma" (bf16); FurcaNet
# (egs/wsj0-mix/furcanet/train.sh: Hc = Hr = 128, Bc = Br = 6, k = 3), six biLSTM layers
# over every sample at H = 128, no decode. musdb18 (egs/musdb18/{conv-tasnet,mrx,
# meta-tasnet}/train.sh): stereo Conv-TasNet (N 256, L 20, C·L = 40: the "generic" decode),
# MRX (three resolutions x three biLSTM layers at H = 256 over the STFT frames, on
# "cluster") and Meta-TasNet (N 440, L 20, mono: the "generic" decode); WaveNet at the JAX
# class's default widths (no CLI builds it).
FURCANET = dict(conv_hidden_channels=128, rnn_hidden_channels=128, num_conv_blocks=6,
                num_rnn_blocks=6, kernel_size=3, n_sources=2)
FURCANET_CLI = ["--model", "furcanet", "-Hc", "128", "-Hr", "128", "-Bc", "6", "-Br", "6",
                "--sep_kernel_size", "3", "--duration", "2", "--batch_size", "4"]
SRU_CLI = CLI_RECIPES["dprnn_tasnet"] + ["--rnn_type", "sru"]
WAVE_CLI = {  # cli/train_musdb18.py at each recipe's flags
    "conv-tasnet": ["--model", "conv-tasnet", "--criterion", "mse", "-N", "256", "-L", "20",
                    "-HH", "512", "-B", "256", "-Sc", "128", "-X", "10", "-R", "4",
                    "--duration", "8", "--batch_size", "4", "--lr", "3e-4", "--max_norm", "5"],
    "mrx": ["--model", "mrx", "--mrx_n_fft", "512,1024,2048", "--hop_length", "256",
            "--hidden_channels", "512", "--num_layers", "3", "--duration", "6",
            "--batch_size", "16", "--lr", "1e-3"],
    "meta-tasnet": ["--model", "meta-tasnet", "-N", "440", "-L", "20", "-HH", "160", "-B",
                    "160", "-Sc", "160", "-X", "8", "-R", "3", "--duration", "8",
                    "--batch_size", "4", "--lr", "1e-3"],
}
WAVE_DEPTH = {  # the train step against f64 at a small depth: the widths kept
    "conv-tasnet": ["-X", "2", "-R", "1"], "mrx": ["--num_layers", "1"],
    "meta-tasnet": ["-X", "2", "-R", "1"]}
WAVENET = dict(in_channels=1, out_channels=256, output_nonlinear="softmax")
MRX_HOP, MRX_LAYERS = 256, 9  # three resolutions x three biLSTM layers, H = 512 // 2
WAVE_SECONDS = 10.0  # the CLI's --valid_duration: the validation forward, B = 1
WAVE_PARITY_SECONDS = 0.5  # the card-vs-CPU forward of each waveform model
REST_STEPS = 1  # musdb18 CLI steps an epoch, two epochs a model
REST_FORWARDS = 2  # timed B = 8 x 4 s forwards of the RNN and SRU models, after one
# The new kernel shapes, phase 15k: (model, label, (B, T, H, chains), dtypes, training, F).
# FurcaNet's forward launches are held to the plain version over their first 4000 steps, of
# 32000 at B = 8 x 4 s (its plain step loop took 9.0 and 14.2 s a dtype over all of them, 3.3
# and 4.0 s over 8000) and of 16000 at training's B = 4 (5.2 s over all of them); its
# training backward over all.
FURCANET_CHECK_STEPS = 4000
REST_SHAPES = [
    ("FurcaNet", "train", (4, 16000, 128, 2), (torch.float32,), True, 128),
    ("FurcaNet", "serve", (8, 32000, 128, 2), (torch.float32, torch.bfloat16), False, 128),
    ("MRX", "serve", (1, int(WAVE_SECONDS * MUSDB_SAMPLE_RATE) // MRX_HOP + 2, 256, 2),
     (torch.float32,), False, 512),
    ("MRX", "train", (16, int(6 * MUSDB_SAMPLE_RATE) // MRX_HOP + 2, 256, 2),
     (torch.float32,), True, 512),
]
# The decodes of the two musdb18 TasNets at their validation forward (B = 1 x 10 s: T' =
# 44099 frames of stride 10): stereo Conv-TasNet's mask is the separator's strided view.
WAVE_DECODE_SHAPES = {"conv-tasnet": (dict(B=1, S=4, T=44099, N=256, CL=40), True),
                      "meta-tasnet": (dict(B=1, S=4, T=44099, N=440, CL=20), False)}


def furcanet_routes(B, n_samples, dtype, backward=False, layers=FURCANET["num_rnn_blocks"]):
    """FurcaNet's recurrence launches of one forward (and its backward) on (B, 1, n): its
    biLSTM layers over B sequences of n steps, each on the route _plan (_plan_bwd) gives,
    never FMA."""
    routes = {f"lstm_scan_bidir/{plan(ls, B, 2, 128, dtype)[0]}": layers}
    if backward:
        routes[f"lstm_scan_bidir_bwd/{plan_bwd(ls, B, 2, 128, dtype)[0]}"] = layers
    check(not any(k.endswith("/fma") for k in routes), f"FurcaNet at B = {B}: {routes}")
    return routes


def mrx_routes(B, backward=False, layers=MRX_LAYERS):
    """MRX's recurrence launches of one f32 forward (and its backward) of B sequences."""
    routes = {f"lstm_scan_bidir/{plan(ls, B, 2, 256, torch.float32)[0]}": layers}
    if backward:
        routes[f"lstm_scan_bidir_bwd/{plan_bwd(ls, B, 2, 256, torch.float32)[0]}"] = layers
    check(not any(k.endswith("/fma") for k in routes), f"MRX at B = {B}: {routes}")
    return routes


def wave_decode(kind):
    """The decodes of one forward of a musdb18 waveform model and their path ("generic":
    C·L = 40 and 20 are above the "mma" path's 16; f32 only, as the JAX CLI trains)."""
    return (0, None) if kind == "mrx" else (1, "generic")


def wave_routes(kind, B, backward=False):
    return mrx_routes(B, backward) if kind == "mrx" else {}


def rest_wsj0_model(tag, device="cuda", **depth):
    if tag == "furcanet":
        model = FurcaNet(**dict(FURCANET, **depth), generator=torch.Generator().manual_seed(0),
                         device=device)
    else:
        model = DPRNNTasNet(**dict(DPRNN, causal=False, rnn_type=tag.split("_")[1], **depth),
                            generator=torch.Generator().manual_seed(0), device=device)
    return scramble_norms(model)


def wave_args(kind, *extra):
    return musdb_train_cli.build_parser().parse_args(
        ["--musdb18_root", "", "--seed", "0", *WAVE_CLI[kind], *extra])


def wave_model(kind, device="cuda", *extra):
    """The musdb18 train CLI's own model (seed 0) and criterion for `kind` at its recipe."""
    args = wave_args(kind, *extra)
    model, criterion = musdb_train_cli.build_model_and_criterion(
        args, args.sources.split(","), device)
    return scramble_norms(model), criterion


def wave_batch(B, seconds, device, seed=12):
    """Four stereo stems of noise and their sum at 44.1 kHz, (B, 1, 2, T) and (B, 4, 2, T)."""
    rng = np.random.default_rng(seed)
    sources = 0.1 * rng.standard_normal((B, 4, 2, int(seconds * MUSDB_SAMPLE_RATE)),
                                        dtype=np.float32)
    return (torch.from_numpy(sources.sum(axis=1, keepdims=True)).to(device),
            torch.from_numpy(sources).to(device))


def phase_rest_kernels(card=None):
    """Phase 15k: the LSTM kernels at FurcaNet's and MRX's shapes against the plain version
    (lstm_kernel_timing, lstm_backward_timing: FMA forced beside the planned route, cuDNN's
    nn.LSTM at the layer's input width, the bound), FurcaNet's also at F = 256 (its layers
    after the first) and over every tf32x3 tile the card holds, forward and backward; and
    fused_mask_decode at the two musdb18 TasNets' decoder widths (decode_case). ->
    {"recurrences": {(name, model, label, dtype): timing}, "decodes": {kind: timing}}."""
    card = card or card_line()
    log("== phase 15k: the recurrences at FurcaNet's and MRX's shapes and the decodes at "
        f"stereo Conv-TasNet's and Meta-TasNet's widths vs plain on the card [{card}]")
    result = {}
    for model, label, (B, T, H, chains), dtypes, training, features in REST_SHAPES:
        name = "lstm_scan_bidir" if chains == 2 else "lstm_scan"
        for dtype in dtypes:
            # FurcaNet's tiles at its training shape only: one tile a chain at both shapes
            timing, inputs, hs, cs = lstm_kernel_timing(
                model, label, B, T, H, chains, dtype, training, features,
                tiles=model == "FurcaNet" and training,
                check_steps=FURCANET_CHECK_STEPS if model == "FurcaNet" else None)
            result[(name, model, label, dtype)] = timing
            if model == "FurcaNet" and dtype == torch.float32:  # bf16 cuDNN: 15x the kernel
                timing["library_f256_ms"] = library_lstm_ms(B, T, H, chains, dtype, 256,
                                                            iters=10)
                log(f"    cuDNN nn.LSTM at F=256 (its later layers) "
                    f"{timing['library_f256_ms']:.4f} ms")
            if training:
                result[(f"{name}_bwd", model, label, dtype)] = lstm_backward_timing(
                    model, label, inputs, hs, cs, features, tiles=model == "FurcaNet")
            del inputs, hs, cs
    names = {"conv-tasnet": "stereo Conv-TasNet", "meta-tasnet": "Meta-TasNet"}
    decodes = {kind: decode_case(shape, strided, torch.float32, f"{names[kind]} decoder shape")
               for kind, (shape, strided) in WAVE_DECODE_SHAPES.items()}
    return dict(recurrences=result, decodes=decodes)


def tf32_tiles(inputs, with_cs, dtype, refs, steps):
    """Every tf32x3 tile (M, C) the card holds at the shape of `inputs`: its hs (and cs)
    over the first `steps` steps against the plain version's `refs` there, the kernel alone
    from a CUDA graph -> {"MxC": ms}."""
    B, T, _ = inputs[0][0].shape
    H = inputs[0][1].shape[0]
    clusters = ls._tf32_clusters(H, "cuda")
    out = {}
    for c, n in sorted(clusters.items()):
        for m in (16, 32, 64):
            if n < 1 or H % (8 * c):
                continue
            hs, cs, launch = ls._staged_forward(inputs, with_cs, "tf32x3", tile=(m, c))
            launch()
            err, limit = forward_error_of(refs, [h[:, :steps] for h in hs],
                                          [x[:, :steps] for x in cs] if with_cs else None,
                                          dtype)
            check(err <= limit, f"tf32x3 tile ({m}, {c}) at B={B}, T={T} disagrees: {err}")
            out[f"{m}x{c}"] = graph_ms(launch, 1)
    log(f"    tf32x3 forward by tile (M x C, kernel alone): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
        + f"; the plan takes {tile_label(plan(ls, B, len(inputs), H, dtype)[1])}")
    return out


def tf32_bwd_tiles(plain_chains, ref):
    """Every split-TF32 backward tile the card holds at the shape of autograd_case's
    `plain_chains`, the kernel alone from a CUDA graph, each held to
    lstm_scan_bwd_reference's `ref` (every chain's gradients in order) -> {"MxC": ms}."""
    B, T, _ = plain_chains[0][0].shape
    H, dtype = plain_chains[0][1].shape[0], plain_chains[0][0].dtype
    name = "lstm_scan_bidir_bwd" if len(plain_chains) == 2 else "lstm_scan_bwd"
    out = {}
    for c, n in sorted(ls._tf32_bwd_clusters(H, "cuda").items()):
        for m in ls.BWD_TILE_ROWS:
            if n < 1 or H % (8 * c):
                continue
            staged, launch = ls._staged_backward(plain_chains, None, tile=(m, c))
            launch()
            errs = staged_bwd_errors(name, staged, plain_chains, [ref], dtype)
            check(all(x <= lim for x, lim in errs), f"backward tile ({m}, {c}): {errs}")
            out[f"{m}x{c}"] = graph_ms(launch, 1)
    log(f"    {name} kernel alone by tile (M x C): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
        + f"; the plan takes {tile_label(plan_bwd(ls, B, len(plain_chains), H, dtype)[1])}")
    return out


def rest_serve(tmp, wavs, card):
    """The wsj0-mix models through cli/separate.py in f32 and bf16 on the three mixtures,
    each request held to its routes (FurcaNet: six lstm_scan_bidir on the tensor cores,
    no decode; DPRNN-TasNet with "rnn" or "sru": no recurrence kernel, one decode on
    "rows" / "mma"), card vs CPU and bf16 vs f32 (phase 5). -> (launches, checkpoints)."""
    launches, ckpts = {}, {}
    for tag in ("dprnn_rnn", "dprnn_sru", "furcanet"):
        log(f"== phase 15: serve recipe-config {tag} through cli/separate.py")
        ckpts[tag] = os.path.join(tmp, f"{tag}.pth")
        save_model(ckpts[tag], rest_wsj0_model(tag))
        if tag == "furcanet":
            routes, decode, decodes = (lambda n, dtype: furcanet_routes(1, n, dtype),
                                       lambda dtype: None, lambda n: 0)
        else:
            routes, decode, decodes = (lambda n, dtype: {}, lambda dtype: decode_path(tag, dtype),
                                       None)
        outputs, served = serve_routed(tag, ckpts[tag], wavs, routes, decode,
                                       decodes_of=decodes)
        launches = add_counts(launches, served)
        phase_parity(tag, ckpts[tag], wavs, outputs)
    return launches, ckpts


def wave_card_vs_cpu(card):
    """Stereo Conv-TasNet, MRX and Meta-TasNet (under their musdb18 adapters) and WaveNet:
    one B = 1 forward on the card, every count set to 0 just before and read just after and
    held to its routes, against the CPU's (<= 1e-3 x max|CPU|); WAVE_PARITY_SECONDS of
    44.1 kHz stereo (WaveNet: 0.25 s of 16 kHz mono). -> the card forwards' launches."""
    log(f"== phase 15: musdb18's waveform models and WaveNet, card vs CPU (f32, "
        f"{WAVE_PARITY_SECONDS:g} s)")
    launches = {}
    for kind in (*WAVE_CLI, "wavenet"):
        if kind == "wavenet":
            make = lambda device: WaveNet(**WAVENET, generator=torch.Generator().manual_seed(0),
                                          device=device)  # noqa: E731
            x = torch.from_numpy(np.random.default_rng(3).standard_normal(
                (1, 1, 4000), dtype=np.float32))
            routes, (decodes, decode) = {}, (0, None)
        else:
            make = lambda device, kind=kind: wave_model(kind, device)[0]  # noqa: E731
            x = wave_batch(1, WAVE_PARITY_SECONDS, "cpu")[0]
            routes, (decodes, decode) = wave_routes(kind, 1), wave_decode(kind)
        card_model, cpu_model = make("cuda").eval(), make("cpu").eval()
        cpu_model.load_state_dict(card_model.state_dict())
        reset_counts()
        with torch.inference_mode():
            got = card_model(x.cuda())
            torch.cuda.synchronize()
            grew = all_counts()
            ref = cpu_model(x)
        check_dptnet_launches(grew, routes, f"{kind}: a card forward", decodes=decodes,
                              decode=decode)
        err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
        log(f"  {kind} {tuple(got.shape)}: card vs CPU max abs err {err:.3e}, max|CPU| "
            f"{scale:.3e}, limit {1e-3 * scale:.3e}; launches {nonzero(grew)} [{card}]")
        check(torch.isfinite(got).all() and got.shape == ref.shape and err <= 1e-3 * scale,
              f"{kind}: the card's forward disagrees with the CPU's: {err}")
        launches = add_counts(launches, grew)
        del card_model, cpu_model
    return launches


def rest_train_parity():
    """One train step of each new CLI model on the card against an f64 CPU step (and the
    f32 CPU step), as phase 7, at the recipe widths: DPRNN-TasNet with "rnn" and "sru" (two
    blocks, B = 1 x 1 s), FurcaNet (two layers of each, B = 1 x 0.25 s: its CPU recurrence
    is a step loop over every sample) with PIT SI-SDR; the musdb18 models at a small depth
    (WAVE_DEPTH) with their CLI's criterion, B = 1 x 0.25 s. -> the card steps' launches."""
    log("== phase 15: one train step a model, card vs CPU (f32, TF32 off, recipe widths at a "
        "small depth; f64 CPU reference)")
    launches = {}
    for tag in ("dprnn_rnn", "dprnn_sru", "furcanet", *WAVE_CLI):
        if tag in WAVE_CLI:
            def make(device, tag=tag):
                return wave_model(tag, device, *WAVE_DEPTH[tag])
            batch, B = wave_batch(1, 0.25, "cpu"), 1
            routes = wave_routes(tag, B, backward=True)
            if routes:
                routes = {k: 3 for k in routes}  # three resolutions, one layer each
        else:
            depth = (dict(num_conv_blocks=2, num_rnn_blocks=2) if tag == "furcanet"
                     else dict(sep_num_blocks=2))

            def make(device, tag=tag, depth=depth):
                return rest_wsj0_model(tag, device, **depth), PIT1d(NegSISDR(), n_sources=2)
            seconds = 0.25 if tag == "furcanet" else 1.0
            batch = train_batch(1, seconds, "cpu")
            routes = (furcanet_routes(1, batch[0].shape[-1], torch.float32, backward=True,
                                      layers=2) if tag == "furcanet" else {})
        (cpu_model, criterion), (card_model, _) = make("cpu"), make("cuda")
        card_model.load_state_dict(cpu_model.state_dict())
        ref = musdb_grads_of_step(copy.deepcopy(cpu_model).double(), criterion,
                                  tuple(t.double() for t in batch))
        cpu = musdb_grads_of_step(cpu_model, criterion, batch)
        reset_counts()
        card = musdb_grads_of_step(card_model, criterion, tuple(t.cuda() for t in batch))
        torch.cuda.synchronize()
        grew = all_counts()
        check_dptnet_launches(grew, routes, f"{tag}: a train step")
        # A parameter with no path to the loss (Meta-TasNet's last block's residual head)
        # has no gradient in any of the three steps; every other one is compared.
        unused = [n for n, g in ref[1].items() if g is None]
        check(all(cpu[1][n] is None and card[1][n] is None for n in unused),
              f"{tag}: gradients present on one device only: {unused}")
        if unused:
            log(f"  {tag}: no path to the loss, no gradient anywhere: {unused}")
        ref, cpu, card = ((loss, {n: g for n, g in grads.items() if n not in unused})
                          for loss, grads in (ref, cpu, card))
        check_step_against_f64(tag, ref, cpu, card, kernels_of(grew))
        launches = add_counts(launches, grew)
        del cpu_model, card_model
    return launches


def rest_wsj0_cli(tag, tmp, corpus, card):
    """cli/train_wsj0mix.py at the recipe's flags (FurcaNet B = 4 x 2 s, DPRNN-TasNet with
    --rnn_type sru B = 2 x 4 s) on the synthetic corpus, two epochs of REST_STEPS steps:
    every step and validation forward on its routes, the epoch train loss falling; the
    checkpoint served through cli/separate.py. -> launches."""
    argv_model = FURCANET_CLI if tag == "furcanet" else SRU_CLI
    log(f"== phase 15: train {tag} through cli/train_wsj0mix.py (recipe flags, f32)")
    tr_root, tr_list, cv_root, cv_list = corpus
    exp = os.path.join(tmp, f"exp_{tag}")
    argv = ["--train_wav_root", tr_root, "--train_list_path", tr_list, "--valid_wav_root",
            cv_root, "--valid_list_path", cv_list, "--valid_duration", "2",
            "--device", "cuda", *argv_model, "--epochs", "2", "--exp_dir", exp]
    if "--duration" not in argv_model:
        argv += ["--duration", "4"]
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        trainer = train_cli.main(argv)
    grew = all_counts()
    steps = 2 * len(trainer.train_loader)
    B = trainer.train_loader.batch_size
    n = trainer.train_loader.dataset[0][0].shape[-1]
    if tag == "furcanet":
        routes = {k: steps * v for k, v in furcanet_routes(B, n, torch.float32, True).items()}
    else:
        routes = {}
    evals = 0
    for mixture, _ in trainer.valid_loader:
        if tag == "furcanet":
            routes = add_counts(routes, {k: 2 * v for k, v in furcanet_routes(
                1, np.shape(mixture)[-1], torch.float32).items()})
        evals += 2
    decodes = 0 if tag == "furcanet" else evals
    check_dptnet_launches(grew, routes, f"the {tag} CLI run", decodes=decodes,
                          decode=None if tag == "furcanet" else "rows")
    losses = trainer.train_loss
    log(f"  {steps} steps of B={B}, {evals} validation forwards, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB: train loss by epoch "
        f"{[round(v, 4) for v in losses]}, valid {[round(v, 4) for v in trainer.valid_loss]}; "
        f"launches by route {routes_of(grew)}; the CLI's last lines: "
        + " | ".join(out.getvalue().strip().splitlines()[-2:]) + f" [{card}]")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the {tag} CLI's epoch train loss did not fall: {losses}")
    ckpt = os.path.join(exp, "model", "last.ckpt")
    _, served = serve_routed(
        f"trained_{tag}", ckpt, [write_mixtures(tmp)[0]],
        (lambda n, dtype: furcanet_routes(1, n, dtype)) if tag == "furcanet" else
        (lambda n, dtype: {}),
        (lambda dtype: None) if tag == "furcanet" else (lambda dtype: decode_path(tag, dtype)),
        decodes_of=(lambda n: 0) if tag == "furcanet" else None)
    return add_counts(grew, served)


def wave_recipe_step(kind, card, iters=2):
    """The musdb18 recipe's train step at its batch on the card, or, where that runs out of
    device memory, at the largest power-of-two batch below it that fits (the widths kept):
    p50 of the step (host clock), its forward / backward / optimizer split (CUDA events),
    audio-s/s and peak allocation; the validation forward (B = 1 x 10 s) ms. -> (batch,
    numbers)."""
    args = wave_args(kind)
    seconds = args.duration
    model, criterion = wave_model(kind)
    optimizer = make_optimizer("adam", args.lr, args.max_norm, params=model.parameters())
    model.train()
    B, p50, (fwd, bwd, opt), peak = fitting_step(
        kind, optimizer, lambda B: wave_batch(B, seconds, "cuda"),
        lambda batch: criterion(model(batch[0]), batch[1]), args.batch_size, seconds, iters)
    x = wave_batch(1, WAVE_SECONDS, "cuda")[0]
    model.eval()
    with torch.inference_mode():
        forward = median_ms(lambda: model(x), warmup=1, iters=3)
    log(f"  {kind}: recipe step at B={B} x {seconds:g} s (recipe B={args.batch_size}): p50 "
        f"{p50:.3f} ms of {iters} (forward + loss {fwd:.3f}, backward {bwd:.3f}, optimizer "
        f"{opt:.3f} ms, CUDA events), {B * seconds / (p50 / 1e3):.2f} audio-s/s, peak "
        f"{peak:.1f} MiB; the B=1 x {WAVE_SECONDS:g} s validation forward {forward:.3f} ms "
        f"(median of 3) [{card}]")
    del model, optimizer
    torch.cuda.empty_cache()
    return B, dict(p50_ms=p50, forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
                   peak_mib=peak, valid_forward_ms=forward, batch=B)


def rest_wave_cli(kind, root, batch, tmp, card):
    """cli/train_musdb18.py at the recipe's flags and `batch` (the recipe's, or what fits)
    on the synthetic corpus, two epochs of REST_STEPS steps: every step (no decode kernel:
    training decodes with the plain version; MRX's nine biLSTM layers and their backwards
    on their routes) and validation forward (B = 1 x 10 s) counted, the epoch train loss
    falling; the last checkpoint reopened by load_model, its forward equal to the trained
    model's. -> launches."""
    log(f"== phase 15: train {kind} through cli/train_musdb18.py (recipe flags, B={batch})")
    exp = os.path.join(tmp, f"exp_{kind}")
    argv = ["--musdb18_root", root, "--seed", "0", *WAVE_CLI[kind], "--batch_size",
            str(batch), "--epochs", "2", "--samples_per_epoch", str(batch * REST_STEPS),
            "--valid_duration", str(WAVE_SECONDS), "--cache_in_memory", "1", "--exp_dir", exp,
            "--device", "cuda"]
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        trainer = musdb_train_cli.main(argv)
    torch.cuda.synchronize()
    grew = all_counts()
    steps, evals = 2 * len(trainer.train_loader), 2 * len(trainer.valid_loader)
    decodes, decode = wave_decode(kind)
    routes = add_counts({k: steps * v for k, v in wave_routes(kind, batch, True).items()},
                        {k: evals * v for k, v in wave_routes(kind, 1).items()})
    check_dptnet_launches(grew, routes, f"the {kind} CLI run", decodes=evals * decodes,
                          decode=decode)
    losses = trainer.train_loss
    log(f"  {steps} steps of B={batch}, {evals} validation forwards: train loss by epoch "
        f"{[round(v, 5) for v in losses]}, valid {[round(v, 5) for v in trainer.valid_loss]}; "
        f"launches {nonzero(grew)}; the CLI's last lines: "
        + " | ".join(out.getvalue().strip().splitlines()[-2:]) + f" [{card}]")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the {kind} CLI's epoch train loss did not fall: {losses}")
    model = load_model(os.path.join(exp, "model", "last.ckpt"), device="cuda")
    x = wave_batch(1, 1.0, "cuda")[0]
    reset_counts()
    with torch.inference_mode():
        got, want = model(x), trainer.model.eval()(x)
    served = all_counts()
    check_dptnet_launches(served, {k: 2 * v for k, v in wave_routes(kind, 1).items()},
                          f"{kind}: the reopened checkpoint", decodes=2 * decodes,
                          decode=decode)
    err = float((got - want).abs().max())
    check(err <= 1e-6 * float(want.abs().max()),
          f"{kind}: the reopened checkpoint computes another function: {err}")
    return add_counts(grew, served)


def rest_forwards(ckpts, card):
    """The B = 8 x 4 s forward of each served wsj0-mix checkpoint (FurcaNet in both dtypes
    by forward_profile: every launch on its route, the device time split; the RNN and SRU
    models in f32, median of 2) and its recipe train step's p50 (of 2 after one) and peak
    allocation (f32). -> (numbers, launches)."""
    log(f"== phase 15: the B=8 x 4 s forward and the recipe step, ms and peak [{card}]")
    numbers, launches = {}, {}
    for tag, ckpt in ckpts.items():
        model = load_model(ckpt, device="cuda")
        if tag == "furcanet":  # both dtypes, profiled
            for dtype in (torch.float32, torch.bfloat16):
                reset_counts()
                numbers[(tag, dtype)], grew = forward_profile(
                    model.to(dtype), dtype, tag, furcanet_routes(8, 4 * SAMPLE_RATE, dtype),
                    None, card, decodes=0)
                launches = add_counts(launches, grew)
        else:  # the plain RNN / SRU recurrences (no kernel): f32, timed, not profiled
            x = train_batch(8, 4.0, "cuda")[0]
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                ms = median_ms(lambda: model(x), warmup=1, iters=REST_FORWARDS)
            grew = all_counts()
            check_dptnet_launches(grew, {}, f"{tag}: the B=8 x 4 s forwards",
                                  decodes=1 + REST_FORWARDS,
                                  decode=decode_path(tag, torch.float32))
            numbers[(tag, torch.float32)] = dict(
                ms=ms, peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
            log(f"  {tag} B=8 x 4 s float32: {ms:.3f} ms a forward (median of {REST_FORWARDS}), "
                f"{8 * 4.0 / (ms / 1e3):.1f} audio-s/s, peak "
                f"{numbers[(tag, torch.float32)]['peak_mib']:.1f} MiB [{card}]")
            launches = add_counts(launches, grew)
        del model
        B, seconds = (4, 2.0) if tag == "furcanet" else (2, 4.0)
        model = rest_wsj0_model(tag)
        optimizer = make_optimizer("adam", 1e-3, 5.0, params=model.parameters())
        criterion = PIT1d(NegSISDR(), n_sources=2)
        mixture, sources = train_batch(B, seconds, "cuda")
        model.train()
        step = evented_step(lambda: criterion(model(mixture), sources)[0], optimizer)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        walls = []
        for i in range(3):
            events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            start = time.perf_counter()
            step(events)
            torch.cuda.synchronize()
            if i:
                walls.append((time.perf_counter() - start) * 1e3)
        grew = all_counts()
        routes = ({k: 3 * v for k, v in furcanet_routes(B, int(seconds * SAMPLE_RATE),
                                                         torch.float32, True).items()}
                  if tag == "furcanet" else {})
        check_dptnet_launches(grew, routes, f"{tag}: the recipe steps")
        launches = add_counts(launches, grew)
        p50 = float(np.median(walls))
        numbers[(tag, "step")] = dict(p50_ms=p50, peak_mib=torch.cuda.max_memory_allocated()
                                      / 2 ** 20)
        log(f"  {tag}: recipe step B={B} x {seconds:g} s f32 p50 {p50:.3f} ms of 2, "
            f"{B * seconds / (p50 / 1e3):.1f} audio-s/s, peak "
            f"{numbers[(tag, 'step')]['peak_mib']:.1f} MiB; launches {routes_of(grew)} [{card}]")
        del model, optimizer
    return numbers, launches


def phase_rest(card=None, tmp=None):
    """Phase 15 -> {"launches": the main path's counts (serving, the card forwards, the
    train steps, the CLIs' training, validation and serving, the recipe forwards and
    steps), none on the FMA kernels, "kernels": phase 15k's timings, "numbers"}."""
    card = card or card_line()
    kernels = phase_rest_kernels(card)
    numbers = {}
    with contextlib.ExitStack() as stack:
        tmp = tmp or stack.enter_context(tempfile.TemporaryDirectory())
        wavs = write_mixtures(tmp)
        total, ckpts = rest_serve(tmp, wavs, card)
        total = add_counts(total, wave_card_vs_cpu(card))
        total = add_counts(total, rest_train_parity())
        corpus = os.path.join(tmp, "rest_corpus")
        wsj0 = (*write_quality_corpus(corpus, "tr", 3), *write_quality_corpus(corpus, "cv", 1))
        for tag in ("furcanet", "dprnn_sru"):
            total = add_counts(total, rest_wsj0_cli(tag, tmp, wsj0, card))
        root = os.path.join(tmp, "musdb18_wave")
        with contextlib.redirect_stdout(io.StringIO()):
            write_musdb_quality_corpus(root, n_train=2, n_valid=1, n_test=0,
                                       track_sec=WAVE_SECONDS, sample_rate=MUSDB_SAMPLE_RATE)
        for kind in WAVE_CLI:
            batch, numbers[kind] = wave_recipe_step(kind, card)
            total = add_counts(total, rest_wave_cli(kind, root, batch, tmp, card))
        forwards, launches = rest_forwards(ckpts, card)
        numbers.update(forwards)
        total = add_counts(total, launches)
    fma = {k: n for k, n in total.items() if k.endswith("/fma") and n}
    check(not fma, f"phase 15 launched the FMA kernels {fma}")
    for key in ("lstm_scan_bidir/tf32x3", "lstm_scan_bidir/mma", "lstm_scan_bidir/cluster",
                "lstm_scan_bidir_bwd/tf32x3", "lstm_scan_bidir_bwd/cluster",
                width_key("generic", "float32", 256, 40), width_key("generic", "float32", 440, 20)):
        check(total.get(key, 0) > 0, f"phase 15 never launched {key}")
    log(f"  phase 15 main-path launches: {nonzero(total)}; no FMA launch")
    return dict(launches=total, kernels=kernels, numbers=numbers)


# Phase 16: Wavesplit and the embedding / attractor family (DANet, ADANet, deep clustering)
# at their recipes' widths (egs/wsj0-mix/{wavesplit,danet,adanet,deep-clustering}/train.sh).
WAVESPLIT_STEP = (4, 4.0)  # the recipe step's B x seconds: smaller where it does not fit
WAVESPLIT_DEPTH = dict(spk_num_layers=2, sep_num_blocks=1, sep_num_layers=2)  # f64 parity
WAVESPLIT_CLI = ["-D", "512", "--spk_num_layers", "14", "--sep_num_blocks", "4",
                 "--sep_num_layers", "10", "--reconst_criterion", "sdr", "--spk_criterion",
                 "distance", "--batch_size", "2", "--duration", "1", "--valid_duration", "2"]
SPEC16 = {"danet": (DANet, DANET, "danet"), "adanet": (ADANet, ADANET, "adanet"),
          "deep-clustering": (DeepEmbedding, DEEP_CLUSTERING, "embedding")}
SPEC_H = DANET["hidden_channels"]  # 300: the cluster and wide kernels padded to 384
SPEC_BATCH, SPEC_SECONDS = 64, 0.8  # the recipes' train batch: 101 frames of hop 64
SPEC_FRAMES = int(SPEC_SECONDS * SAMPLE_RATE) // SPEC_STFT["hop_length"] + 1
SPEC_SERVE_FRAMES = 4 * SAMPLE_RATE // SPEC_STFT["hop_length"] + 1  # a 4 s utterance: 501
# 16k: (label, (B, T, chains), dtypes, training); the first layer's input is F = 129 bins.
SPEC_SHAPES = [
    ("train", (SPEC_BATCH, SPEC_FRAMES, 2), (torch.float32,), True),
    ("serve", (1, SPEC_SERVE_FRAMES, 2), (torch.float32, torch.bfloat16), False),
]
DANET_CLI = ["--model", "danet", "--n_fft", "256", "--hop_length", "64", "--ideal_mask", "ibm",
             "--threshold", "60", "-K", "20", "-H", "300", "-B", "4", "--duration", "0.8",
             "--criterion", "se", "--optimizer", "rmsprop", "--lr", "1e-4", "--batch_size",
             "64"]
SPEC_EVAL_FLAGS = ["--spec_kind", "danet", "--n_fft", "256", "--hop_length", "64"]


def spec_layers(tag) -> int:
    config = SPEC16[tag][1]
    return config.get("num_blocks", config.get("num_layers"))


def spec_routes(tag, B, T, dtype, backward=False):
    """One forward's (and its backward's) recurrence launches of a spectrogram model over B
    sequences of T frames: a biLSTM layer each, on the route _plan (_plan_bwd) gives, and
    "kernel/padded" for those zero-padded (H = 300 on the cluster and wide kernels at 384:
    requests on the cluster kernel, training's B = 64 where the plan's constants put it)."""
    paths = {"lstm_scan_bidir": plan(ls, B, 2, SPEC_H, dtype)[0]}
    if backward:
        paths["lstm_scan_bidir_bwd"] = plan_bwd(ls, B, 2, SPEC_H, dtype)[0]
    routes = {f"{kernel}/{p}": spec_layers(tag) for kernel, p in paths.items()}
    routes.update({f"{kernel}/padded": spec_layers(tag) for kernel, p in paths.items()
                   if ls.launch_width(SPEC_H, p) != SPEC_H})
    return routes


def spec_model(tag, device="cuda", **over):
    cls, config, _ = SPEC16[tag]
    return cls(**dict(config, **over), generator=torch.Generator().manual_seed(0),
               device=device)


def spec_batch(B, seconds, device, seed=13):
    """IdealMaskSpectrogramTrainDataset's items (data/wsj0mix.py:ideal_mask_item) of B
    noise pairs at the recipes' flags (n_fft 256, hop 64, Hann, ibm, 60 dB), stacked:
    (|mixture|, |sources|, ideal binary mask, threshold weight)."""
    rng = np.random.default_rng(seed)
    sources = 0.1 * rng.standard_normal((B, 2, int(seconds * SAMPLE_RATE))).astype(np.float32)
    window = wsj0mix_data.np_window(256)

    def spec(x):
        return wsj0mix_data._np_stft(x, 256, 64, window)

    items = [wsj0mix_data.ideal_mask_item(spec(s.sum(axis=0, keepdims=True)), spec(s), "ibm",
                                          60.0) for s in sources]
    return tuple(torch.from_numpy(np.stack(a)).to(device) for a in zip(*items))


def spec_loss(tag, model, batch):
    """The train CLI's loss of `tag` on one batch (PIT over L2 for DANet with the oracle
    assignment and for ADANet; the affinity loss for deep clustering)."""
    mix, src, mask, weight = batch
    if tag == "deep-clustering":
        emb = model(mix)
        B, F, T, D = emb.shape
        return AffinityLoss()(emb.reshape(B, F * T, D), mask.permute(0, 2, 3, 1).reshape(
            B, F * T, 2), binary_mask=weight.reshape(B, F * T))
    est = model(mix, mask, weight) if tag == "danet" else model(mix, weight, 2)
    return PIT2d(L2Loss(), n_sources=2)(est, src)[0]


def grads_of_loss(model, loss_of):
    """(loss, every gradient) of one backward of loss_of()."""
    model.zero_grad()
    loss = loss_of()
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()
                                  if p.requires_grad}


def phase_spec_kernels(card=None):
    """Phase 16k: lstm_scan_bidir at H = 300, the recipes' training shape (64, 101) x 2 with
    cs and its backward, and a 4 s utterance's (1, 501) x 2 in f32 and bf16, on the route
    _plan gives (the cluster kernels padded to 384 for the request, the route the plan's
    constants give training), against the plain version at the full length and, padded,
    the FMA kernel forced; the kernel alone from CUDA graphs in turns with the FMA kernel and
    the whole call (pads and slices included), beside the plain version, cuDNN's nn.LSTM with
    its input projection (F = 129) and the bound of the unpadded work. -> {(name, label,
    dtype): timing}."""
    card = card or card_line()
    log("== phase 16k: lstm_scan_bidir at H = 300 (DANet, ADANet, deep clustering) vs plain "
        f"on the card (CUDA graphs, CUDA events) [{card}]")
    result = {}
    F = DANET["n_bins"]
    for label, (B, T, chains), dtypes, training in SPEC_SHAPES:
        for dtype in dtypes:
            timing, inputs, hs, cs = lstm_kernel_timing("DANet", label, B, T, SPEC_H, chains,
                                                        dtype, training, F)
            if timing["path"] == "fma":  # the whole call beside the kernel alone
                timing["kernel_ms"] = timing["ms"]
                timing["ms"] = graph_ms(lambda: ls._forward_cuda(inputs, training), 1, iters=5)
                log(f"    whole call {timing['ms']:.4f} ms, kernel alone "
                    f"{timing['kernel_ms']:.4f} ms")
            result[("lstm_scan_bidir", label, dtype)] = timing
            if training:
                result[("lstm_scan_bidir_bwd", label, dtype)] = lstm_backward_timing(
                    "DANet", label, inputs, hs, cs, F)
            del inputs, hs, cs
    return result


def wavesplit_model(device="cuda", **depth):
    return scramble_norms(WaveSplit(**dict(WAVESPLIT, **depth),
                                    generator=torch.Generator().manual_seed(0),
                                    device=device))


def oracle_order(B, T, device, seed=3):
    """A speaker order for every sample: (B, T, 2), [0, 1] or [1, 0]."""
    first = np.random.default_rng(seed).integers(0, 2, (B, T, 1))
    return torch.from_numpy(np.concatenate([first, 1 - first], axis=-1)).to(device)


def wavesplit_loss(model, mixture, sources, spk_idx):
    """WaveSplitTrainer's loss: every layer's negative SDR plus the mean speaker loss."""
    est_all, spk_loss = model.forward_train(mixture, spk_idx)
    return NegSDR()(est_all, sources[:, None]) + spk_loss.mean()


def wavesplit_forwards(card):
    """The B = 8 x 4 s forward, f32 and bf16, on the oracle and the KMeans paths (no kernel
    of the port: every count 0), ms (median of 3) and peak; bf16 vs f32 SNR."""
    log("== phase 16: Wavesplit (recipe: D 512, 14 speaker layers, 4 x 10 separation "
        "layers) B=8 x 4 s forward, f32 and bf16, oracle and KMeans paths")
    B, T = 8, 4 * SAMPLE_RATE
    model = wavesplit_model().eval()
    x, order = train_batch(B, 4.0, "cuda")[0], oracle_order(B, T, "cuda")
    numbers, outs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        model.to(dtype)
        xin = x.to(dtype)
        for path in ("oracle", "kmeans"):
            def call(path=path):
                return model(xin, order) if path == "oracle" else model(xin)
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                out = call()
                ms = median_ms(call, warmup=0, iters=2)
            torch.cuda.synchronize()
            check_dptnet_launches(all_counts(), {}, f"wavesplit {path} {dtype}: the forwards")
            check(out.shape == (B, 2, T) and torch.isfinite(out).all(),
                  f"wavesplit {path} {dtype}: {tuple(out.shape)}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            numbers[(path, str(dtype)[6:])] = dict(ms=ms, peak_mib=peak)
            outs[(path, dtype)] = out.float()
            log(f"  {str(dtype)[6:]} {path}: {ms:.3f} ms a forward (median of 2), "
                f"{B * 4.0 / (ms / 1e3):.1f} audio-s/s, peak {peak:.1f} MiB; no kernel "
                f"launched [{card}]")
        numbers[("profile", str(dtype)[6:])] = wavesplit_profile(model, xin, order, dtype, card)
    for path in ("oracle", "kmeans"):
        f32, bf16 = outs[(path, torch.float32)], outs[(path, torch.bfloat16)]
        snr = float(10 * torch.log10(f32.square().sum() / (bf16 - f32).square().sum()))
        numbers[(path, "bf16_snr_db")] = snr
        log(f"  bf16 vs f32 ({path}): SNR {snr:.2f} dB"
            + (f" (limit {SNR_LIMIT_DB:g})" if path == "oracle" else
               " (informational: bf16 KMeans clusters bf16 vectors)"))
        if path == "oracle":
            check(snr >= SNR_LIMIT_DB, f"wavesplit bf16 SNR {snr:.2f} dB < {SNR_LIMIT_DB}")
    del model, outs
    torch.cuda.empty_cache()
    return numbers


def wavesplit_profile(model, x, order, dtype, card):
    """One oracle-path forward under torch.profiler: wall ms, device busy ms and idle share,
    the device time of the depthwise convolutions, the products, the norms' and FiLM's
    elementwise kernels and reductions, and the six longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x, order)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            model(x, order)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3
    times = device_times(prof)
    busy = sum(times.values())
    kinds = {"conv": 0.0, "gemm": 0.0, "reduce": 0.0, "elementwise": 0.0, "other": 0.0}
    for name, ms in times.items():
        low = name.lower()
        kind = ("conv" if "conv" in low or "depthwise" in low else
                "gemm" if "gemm" in low else
                "reduce" if "reduce" in low else "elementwise" if "elementwise" in low else
                "other")
        kinds[kind] += ms
    top = sorted(times.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile of one {str(dtype)[6:]} oracle forward: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms, idle share {max(0.0, 1 - busy / wall):.1%}; by kind "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in kinds.items()) + f" [{card}]")
    log("    top device time: " + ", ".join(f"{k[:56]} {t:.3f} ms" for k, t in top))
    return dict(wall_ms=wall, busy_ms=busy, idle_share=max(0.0, 1 - busy / wall), **kinds)


@contextlib.contextmanager
def kmeans_draws(drawn, replay=False):
    """Within it every KMeans' initial centroids are recorded into the list `drawn` as the
    port draws them or, with `replay`, taken from it in order onto the data's device: the
    card and the CPU start their clustering from the same centroids (kmeans++ draws from
    the distances, which differ in their last bits)."""
    draw, queue = KMeans._init, iter(list(drawn))

    def init(self, data):
        if replay:
            return next(queue).to(data.device, data.dtype)
        drawn.append(draw(self, data))
        return drawn[-1]

    KMeans._init = init
    try:
        yield
    finally:
        KMeans._init = draw


def wavesplit_card_vs_cpu():
    """B = 1 x 1 s, f32, card vs CPU (<= 1e-3 x max|CPU|) on the oracle path and on the
    KMeans path with the CPU run's initial centroids handed to the card."""
    log("== phase 16: Wavesplit card vs CPU (f32, B=1 x 1 s, recipe widths)")
    card_model, cpu_model = wavesplit_model().eval(), wavesplit_model("cpu").eval()
    x, order = train_batch(1, 1.0, "cpu")[0], oracle_order(1, SAMPLE_RATE, "cpu")
    drawn = []
    with torch.inference_mode():
        with kmeans_draws(drawn):
            refs = {"oracle": cpu_model(x, order), "kmeans": cpu_model(x)}
        reset_counts()
        with kmeans_draws(drawn, replay=True):
            gots = {"oracle": card_model(x.to("cuda"), order.to("cuda")),
                    "kmeans": card_model(x.to("cuda"))}
        torch.cuda.synchronize()
    check_dptnet_launches(all_counts(), {}, "wavesplit: the card forwards")
    for path, ref in refs.items():
        err, scale = float((gots[path].cpu() - ref).abs().max()), float(ref.abs().max())
        log(f"  {path}: card vs CPU max abs err {err:.3e}, max|CPU| {scale:.3e}, limit "
            f"{1e-3 * scale:.3e}")
        check(err <= 1e-3 * scale, f"wavesplit {path}: card disagrees with the CPU: {err}")


def wavesplit_train_parity():
    """One train step (WaveSplitTrainer's loss) card vs an f64 CPU step and the f32 CPU step,
    D = 512 at a small depth (WAVESPLIT_DEPTH), B = 1 x 0.5 s."""
    log("== phase 16: one Wavesplit train step, card vs CPU (f32, TF32 off, D 512, 2 speaker "
        "layers, 1 x 2 separation layers, B=1 x 0.5 s; f64 CPU reference)")
    mixture, sources = train_batch(1, 0.5, "cpu")
    spk_idx = torch.tensor([[3, 57]])
    cpu_model = wavesplit_model("cpu", **WAVESPLIT_DEPTH).train()
    card_model = wavesplit_model(**WAVESPLIT_DEPTH).train()
    ref_model = copy.deepcopy(cpu_model).double()
    ref = grads_of_loss(ref_model, lambda: wavesplit_loss(
        ref_model, mixture.double(), sources.double(), spk_idx))
    cpu = grads_of_loss(cpu_model, lambda: wavesplit_loss(cpu_model, mixture, sources, spk_idx))
    reset_counts()
    on_card = grads_of_loss(card_model, lambda: wavesplit_loss(
        card_model, mixture.to("cuda"), sources.to("cuda"), spk_idx.to("cuda")))
    torch.cuda.synchronize()
    grew = all_counts()
    check_dptnet_launches(grew, {}, "wavesplit: a train step")
    check_step_against_f64("wavesplit", ref, cpu, on_card, kernels_of(grew))


def wavesplit_recipe_step(card):
    """The recipe's train step (Adam, clipping 5) at B = 4 x 4 s or, where that runs out of
    device memory, the largest power-of-two batch that fits: p50 of 2, split, peak."""
    seconds = WAVESPLIT_STEP[1]
    model = wavesplit_model().train()
    optimizer = make_optimizer("adam", 1e-3, 5.0, params=model.parameters())

    def batch_of(B):
        mixture, sources = train_batch(B, seconds, "cuda")
        return mixture, sources, torch.arange(2 * B, device="cuda").view(B, 2)

    B, p50, (fwd, bwd, opt), peak = fitting_step(
        "wavesplit", optimizer, batch_of, lambda batch: wavesplit_loss(model, *batch),
        WAVESPLIT_STEP[0], seconds)
    log(f"  wavesplit: recipe step at B={B} x {seconds:g} s (recipe B={WAVESPLIT_STEP[0]}): "
        f"p50 {p50:.3f} ms of 2 (forward + loss {fwd:.3f}, backward {bwd:.3f}, optimizer "
        f"{opt:.3f} ms, CUDA events), {B * seconds / (p50 / 1e3):.2f} audio-s/s, peak "
        f"{peak:.1f} MiB; no kernel launched [{card}]")
    del model, optimizer
    torch.cuda.empty_cache()
    return dict(batch=B, p50_ms=p50, forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
                peak_mib=peak)


def write_speaker_corpus(root, split, n_utts, seconds, first_speaker=0, n_speakers=6):
    """A wsj0-2mix-style split whose IDs name their speakers (`<spk>a<utt>_<gain>_<spk>c<utt>_
    <gain>`, the form data/wsj0mix.py:speaker_keys reads), pseudo-speech of n_speakers
    speakers. -> (wav_root, list_path)."""
    wav_root, list_path = os.path.join(root, split), os.path.join(root, f"{split}.lst")
    for sub in ("mix", "s1", "s2"):
        os.makedirs(os.path.join(wav_root, sub), exist_ok=True)
    bank = _speaker_bank(first_speaker + n_speakers, seed=7)
    rng = np.random.default_rng(first_speaker + 21)
    utts = []
    for i in range(n_utts):
        a, b = rng.choice(n_speakers, size=2, replace=False) + first_speaker
        T = int(seconds * SAMPLE_RATE)
        s1 = synth_pseudo_speech(bank[a], rng, T, SAMPLE_RATE)
        s2 = 0.7 * synth_pseudo_speech(bank[b], rng, T, SAMPLE_RATE)
        scale = 0.9 / max(float(np.abs(s1 + s2).max()), 1e-9)
        utt = f"{100 + a:03d}a{i:04d}_1.5_{100 + b:03d}c{i:04d}_-1.5"
        for sub, sig in (("s1", s1), ("s2", s2), ("mix", s1 + s2)):
            write_wav(os.path.join(wav_root, sub, f"{utt}.wav"), scale * sig, SAMPLE_RATE)
        utts.append(utt)
    with open(list_path, "w") as f:
        f.write("\n".join(utts))
    return wav_root, list_path


def wavesplit_cli(tmp, card):
    """cli/train_wsj0mix_wavesplit.py at the recipe's widths (B = 2 x 1 s) on a corpus of
    wsj0-style IDs, two epochs: no kernel launched, the epoch train loss falling."""
    log("== phase 16: train Wavesplit through cli/train_wsj0mix_wavesplit.py (recipe widths, "
        "B=2 x 1 s, f32)")
    root = os.path.join(tmp, "ws_corpus")
    tr_root, tr_list = write_speaker_corpus(root, "tr", 8, 2.0)
    cv_root, cv_list = write_speaker_corpus(root, "cv", 2, 2.0, first_speaker=6)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        trainer = wavesplit_train_cli.main(
            ["--train_wav_root", tr_root, "--train_list_path", tr_list, "--valid_wav_root",
             cv_root, "--valid_list_path", cv_list, *WAVESPLIT_CLI, "--epochs", "2",
             "--exp_dir", os.path.join(tmp, "exp_wavesplit"), "--device", "cuda"])
    torch.cuda.synchronize()
    check_dptnet_launches(all_counts(), {}, "the Wavesplit CLI run")
    losses = trainer.train_loss
    log(f"  {2 * len(trainer.train_loader)} steps, {len(trainer.model.spk_embedding)} speakers "
        f"in the table: train loss by epoch {[round(v, 4) for v in losses]}, valid "
        f"{[round(v, 4) for v in trainer.valid_loss]}; the CLI's last lines: "
        + " | ".join(out.getvalue().strip().splitlines()[-2:]) + f" [{card}]")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the Wavesplit CLI's epoch train loss did not fall: {losses}")


def spec_forwards(card):
    """A 4 s utterance through each model's serving path (SpectrogramSeparator: STFT,
    clustering or anchors, iSTFT), f32 and bf16, every launch on its route, ms (median of
    3); DANet and ADANet card vs CPU (<= 1e-3 x max|CPU|; DANet's KMeans from the CPU run's
    initial centroids). -> (numbers, launches)."""
    log("== phase 16: DANet, ADANet and deep clustering: a 4 s utterance served (STFT, "
        "clustering, iSTFT), f32 and bf16, and card vs CPU")
    x = train_batch(1, 4.0, "cpu")[0]
    numbers, launches = {}, {}
    for tag, (_, _, kind) in SPEC16.items():
        base = spec_model(tag).eval()
        for dtype in (torch.float32, torch.bfloat16):
            serve = SpectrogramSeparator(base.to(dtype), **SPEC_STFT, kind=kind).eval()
            reset_counts()
            with torch.inference_mode():
                out = serve(x.to("cuda"))
                ms = median_ms(lambda: serve(x.to("cuda")), warmup=0, iters=3)
            torch.cuda.synchronize()
            grew = all_counts()
            routes = {k: 4 * v for k, v in spec_routes(tag, 1, SPEC_SERVE_FRAMES, dtype).items()}
            check_dptnet_launches(grew, routes, f"{tag} {dtype}: four served utterances")
            check(out.shape == (1, 2, x.shape[-1]) and torch.isfinite(out).all(), out.shape)
            launches = add_counts(launches, grew)
            numbers[(tag, str(dtype)[6:])] = ms
            log(f"  {tag} {str(dtype)[6:]}: {ms:.3f} ms a 4 s utterance (median of 3); "
                f"launches by route {routes_of(grew)} [{card}]")
        base.float()
        cpu_base = spec_model(tag, "cpu").eval()
        cpu_base.load_state_dict(base.state_dict())
        with torch.inference_mode():
            if tag == "deep-clustering":  # KMeans into binary masks: a flipped bin is not
                # noise, so the embeddings that KMeans clusters, at the served shape
                amp = stft(x, SPEC_STFT["n_fft"], SPEC_STFT["hop_length"],
                           window=torch.from_numpy(wsj0mix_data.np_window(
                               SPEC_STFT["n_fft"]))).abs()
                what, ref, got = "embeddings", cpu_base(amp), base(amp.to("cuda"))
            else:
                drawn = []
                with kmeans_draws(drawn):
                    ref = SpectrogramSeparator(cpu_base, **SPEC_STFT, kind=kind)(x)
                with kmeans_draws(drawn, replay=True):
                    got = SpectrogramSeparator(base, **SPEC_STFT, kind=kind)(x.to("cuda"))
                what = "estimates"
        err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
        log(f"  {tag} card vs CPU (f32 {what}): max abs err {err:.3e}, max|CPU| {scale:.3e}, "
            f"limit {1e-3 * scale:.3e}")
        check(err <= 1e-3 * scale, f"{tag}: card disagrees with the CPU: {err}")
        del base, cpu_base
    return numbers, launches


def spec_steps(card):
    """Each model's train step (its CLI's loss; ADANet at dropout 0) at the recipe widths,
    card vs an f64 CPU step and the f32 CPU step (B = 2 x 0.8 s); then the recipe's B = 64 x
    0.8 s step (ADANet in train mode with dropout 0.5, masks from a generator), p50 of 2,
    split and peak; every launch on its route. -> (numbers, launches)."""
    log("== phase 16: DANet, ADANet and deep clustering train steps: card vs CPU (f32, TF32 "
        "off, recipe widths, B=2 x 0.8 s; f64 CPU reference), then the recipe's B=64 x 0.8 s")
    numbers, launches = {}, {}
    for tag in SPEC16:
        over = dict(dropout=0.0) if tag == "adanet" else {}
        cpu_model, card_model = spec_model(tag, "cpu", **over), spec_model(tag, **over)
        cpu_model.eval(), card_model.eval()  # no dropout: the parity step
        batch = spec_batch(2, SPEC_SECONDS, "cpu")
        ref_model = copy.deepcopy(cpu_model).double()
        ref = grads_of_loss(ref_model, lambda: spec_loss(
            tag, ref_model, tuple(t.double() for t in batch)))
        cpu = grads_of_loss(cpu_model, lambda: spec_loss(tag, cpu_model, batch))
        reset_counts()
        card_batch = tuple(t.to("cuda") for t in batch)
        on_card = grads_of_loss(card_model, lambda: spec_loss(tag, card_model, card_batch))
        torch.cuda.synchronize()
        grew = all_counts()
        check_dptnet_launches(grew, spec_routes(tag, 2, SPEC_FRAMES, torch.float32, True),
                              f"{tag}: a train step")
        check_step_against_f64(tag, ref, cpu, on_card, kernels_of(grew))
        launches = add_counts(launches, grew)
        del cpu_model, card_model, ref_model
        model = spec_model(tag)
        optimizer = make_optimizer("rmsprop" if tag == "danet" else "adam", 1e-4,
                                   params=model.parameters())
        model.train(tag == "adanet")
        set_dropout_generator(model, torch.Generator(device="cuda").manual_seed(0))
        batch = spec_batch(SPEC_BATCH, SPEC_SECONDS, "cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        p50, (fwd, bwd, opt) = timed_steps(lambda: spec_loss(tag, model, batch), optimizer)
        grew = all_counts()
        check_dptnet_launches(grew, {k: 3 * v for k, v in spec_routes(
            tag, SPEC_BATCH, SPEC_FRAMES, torch.float32, True).items()}, f"{tag}: recipe steps")
        launches = add_counts(launches, grew)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        numbers[tag] = dict(p50_ms=p50, forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
                            peak_mib=peak)
        log(f"  {tag}: recipe step B={SPEC_BATCH} x {SPEC_SECONDS:g} s f32 p50 {p50:.3f} ms of "
            f"2 (forward + loss {fwd:.3f}, backward {bwd:.3f}, optimizer {opt:.3f} ms), "
            f"{SPEC_BATCH * SPEC_SECONDS / (p50 / 1e3):.1f} audio-s/s, peak {peak:.1f} MiB; "
            f"launches by route {routes_of(grew)} [{card}]")
        del model, optimizer, batch
    return numbers, launches


def danet_cli_and_eval(tmp, card):
    """cli/train_wsj0mix_spec.py --model danet at the recipe's flags (rmsprop, B = 64 x
    0.8 s) on a synthetic corpus, two epochs: every step (forward with cs, backward) and
    validation forward (KMeans) on its routes, the epoch train loss falling; then its
    checkpoint through cli/test_wsj0mix.py --spec_kind danet on the card and the CPU, each
    metric of each utterance within EVAL_TOL_DB. -> launches."""
    log("== phase 16: train DANet through cli/train_wsj0mix_spec.py (recipe flags: rmsprop "
        "lr 1e-4, B=64 x 0.8 s, f32), then --spec_kind danet evaluation, card vs CPU")
    corpus = os.path.join(tmp, "danet_corpus")
    tr_root, tr_list = write_quality_corpus(corpus, "tr", 30)
    cv_root, cv_list = write_quality_corpus(corpus, "cv", 4)
    exp = os.path.join(tmp, "exp_danet")
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        trainer = spec_train_cli.main(
            ["--train_wav_root", tr_root, "--train_list_path", tr_list, "--valid_wav_root",
             cv_root, "--valid_list_path", cv_list, *DANET_CLI, "--epochs", "2", "--exp_dir",
             exp, "--device", "cuda"])
    torch.cuda.synchronize()
    grew = all_counts()
    routes = {}
    for loader, backward in ((trainer.train_loader, True), (trainer.valid_loader, False)):
        n, size = len(loader.dataset), loader.batch_size
        last = [n % size] if n % size and not loader.drop_last else []
        for B in [size] * (n // size) + last:  # two epochs of each
            routes = add_counts(routes, {k: 2 * v for k, v in spec_routes(
                "danet", B, SPEC_FRAMES, torch.float32, backward).items()})
    check_dptnet_launches(grew, routes, "the DANet CLI run")
    losses = trainer.train_loss
    log(f"  {2 * len(trainer.train_loader)} steps, {2 * len(trainer.valid_loader)} validation "
        f"batches: train loss by epoch {[round(v, 5) for v in losses]}, valid "
        f"{[round(v, 5) for v in trainer.valid_loss]}; launches by route {routes_of(grew)}; "
        "the CLI's last lines: " + " | ".join(out.getvalue().strip().splitlines()[-2:])
        + f" [{card}]")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the DANet CLI's epoch train loss did not fall: {losses}")
    ckpt = os.path.join(exp, "model", "last.ckpt")
    root, lists = write_test_list(tmp)
    reset_counts()
    worst = 0.0
    for list_path, T in zip(lists, TEST_LENGTHS):
        before = all_counts()
        got = evaluate(root, list_path, ckpt, "cuda", SPEC_EVAL_FLAGS)
        frames = T // SPEC_STFT["hop_length"] + 1
        check_dptnet_launches(grown(before), spec_routes("danet", 1, frames, torch.float32),
                              f"DANet --spec_kind evaluation, {T} samples")
        ref = evaluate(root, list_path, ckpt, "cpu", SPEC_EVAL_FLAGS)
        diffs = {k: abs(got[k] - ref[k]) for k in TEST_METRICS}
        check(all(np.isfinite(got[k]) for k in TEST_METRICS), got)
        worst = max(worst, *diffs.values())
        log(f"  {T} samples: SI-SDRi {got['loss_improvement']:.3f} dB, SDRi "
            f"{got['sdr_improvement']:.3f}, SIRi {got['sir_improvement']:.3f}, SAR "
            f"{got['sar']:.3f}; max |card - CPU| {max(diffs.values()):.2e} dB [{card}]")
        check(max(diffs.values()) <= EVAL_TOL_DB,
              f"DANet --spec_kind: card metrics differ from the CPU's: {diffs}")
    log(f"  worst |card - CPU| over every metric {worst:.2e} dB (limit {EVAL_TOL_DB:g})")
    return add_counts(grew, all_counts())


def phase_spec(card=None, tmp=None):
    """Phase 16 (16k first) -> {"launches": the main path's counts (the served utterances,
    the train steps, the DANet CLI's steps, validation and evaluation), every LSTM launch on
    its planned route (H = 300: the cluster kernels padded to 384 for requests, the routes
    the plan's constants give training's B = 64), "kernels": 16k's timings, "numbers"}."""
    card = card or card_line()
    kernels = phase_spec_kernels(card)
    numbers = {"wavesplit": wavesplit_forwards(card)}
    wavesplit_card_vs_cpu()
    wavesplit_train_parity()
    numbers["wavesplit_step"] = wavesplit_recipe_step(card)
    with contextlib.ExitStack() as stack:
        tmp = tmp or stack.enter_context(tempfile.TemporaryDirectory())
        wavesplit_cli(tmp, card)
        numbers["spec_serve"], total = spec_forwards(card)
        numbers["spec_step"], launches = spec_steps(card)
        total = add_counts(total, launches)
        total = add_counts(total, danet_cli_and_eval(tmp, card))
    for key in {**spec_routes("danet", 1, SPEC_SERVE_FRAMES, torch.float32),
                **spec_routes("danet", SPEC_BATCH, SPEC_FRAMES, torch.float32, True)}:
        check(total.get(key, 0) > 0, f"phase 16 never launched {key}")
    log(f"  phase 16 main-path launches: {nonzero(total)}")
    return dict(launches=total, kernels=kernels, numbers=numbers)


# Phase 17: musdb18's 2-D dense / U-Net recipes (D3Net, MMDenseNet, MMDenseLSTM, HRNet,
# CUNet) at their recipe widths: cli/train_musdb18.py at the flags of the port's
# egs/musdb18/{d3net,mm-densenet,mm-dense-lstm,hrnet,cunet}/train.sh, the band-structured
# models from the repo's recipe YAMLs (egs/musdb18/*/config).
SLICE_E_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "egs", "musdb18")
SLICE_E_CLI = {
    "d3net": ["--model", "d3net", "--d3net_config",
              os.path.join(SLICE_E_DIR, "d3net", "config", "vocals.yaml"), "--n_fft", "4096",
              "--hop_length", "1024", "--batch_size", "6", "--lr", "1e-3"],
    "mm-densenet": ["--model", "mm-densenet", "--mmdense_config",
                    os.path.join(SLICE_E_DIR, "mm-densenet", "config", "paper.yaml"),
                    "--n_fft", "2048", "--hop_length", "1024", "--batch_size", "6", "--lr",
                    "1e-3"],
    "mm-dense-lstm": ["--model", "mm-dense-lstm", "--mmdense_config",
                      os.path.join(SLICE_E_DIR, "mm-dense-lstm", "config", "paper.yaml"),
                      "--n_fft", "4096", "--hop_length", "2048", "--batch_size", "6", "--lr",
                      "1e-3"],
    "hrnet": ["--model", "hrnet", "--target", "vocals", "--criterion", "mae", "--sample_rate",
              "16000", "--n_fft", "1024", "--hop_length", "512", "--batch_size", "5", "--lr",
              "1e-4"],
    "cunet": ["--model", "cunet", "--conditioning", "film", "--criterion", "l1loss", "--n_fft",
              "1024", "--hop_length", "768", "--cunet_channels", "2,16,32,64,128,256",
              "--cunet_control_channels", "4,16,64", "--batch_size", "4", "--lr", "1e-3"],
}
SLICE_E_EVALUATED = ("d3net", "mm-densenet", "mm-dense-lstm")  # JAX's CLI evaluates these
# The train step against f64 (B = 1): MMDenseLSTM's deepest recurrences need frames to
# recur over (1 s: 22 at hop 2048, 2 at 1/16); D3Net's f64 CPU step is the costly one.
SLICE_E_PARITY_SECONDS = {"d3net": 0.25, "mm-densenet": 0.5, "mm-dense-lstm": 1.0,
                          "hrnet": 0.5, "cunet": 0.5}
SLICE_E_TRACK_SECONDS = 1.0  # the evaluated synthetic track: one chunk
SLICE_E_HOST_CORES = 2  # the host's cores left to the thread driving the card in phase 17
# The train step against f64: a tensor's max|g| is taken as at least this share of the
# largest (check_step_against_f64's null_floor). A one-channel bias into a recurrence's
# bottleneck sums one number over the whole map: its terms cancel to far below the rest,
# and the CPU's own f32 step misses it by 6.6e-2 of its max|g| (PR 23's first chip run).
SLICE_E_SMALL_GRAD = 1e-2
# The train step against f64 holds the card to the f64 gradient of the same linear piece:
# every ReLU of the card's step takes the f64 step's sign pattern, and the card's own ReLU
# inputs may fall on the other side of 0 only where the f64 input lies nearer 0 than the
# card's largest deviation from f64 over the rest of that call (its rounding). MMDenseNet's
# parity batch has ReLU inputs within 1e-6 of 0 (of up to 2.64): their one-sided derivatives
# moved its f32 step 1.0e-2 from f64 while no kernel of the step is off (PERF.md, PR 26;
# scripts/probe_step_precision.py --convs --kinks).
_PLAIN_RELU = torch.nn.functional.relu
_BRANCHES = threading.local()


def _branch_relu(x, inplace=False):
    """torch.nn.functional.relu under relu_dispatch: plain, or as this thread's
    relu_branches asks."""
    state = getattr(_BRANCHES, "state", None)
    if state is None:
        return _PLAIN_RELU(x, inplace=inplace)
    record, pattern = state
    if record is not None:
        record.append(x.detach().double().cpu())
    return _PLAIN_RELU(x, inplace=inplace) if pattern is None else x * next(pattern).to(x)


@contextlib.contextmanager
def relu_dispatch():
    """Within it torch.nn.functional.relu goes through _branch_relu (each thread plain unless
    inside relu_branches)."""
    torch.nn.functional.relu = _branch_relu
    try:
        yield
    finally:
        torch.nn.functional.relu = _PLAIN_RELU


@contextlib.contextmanager
def relu_branches(record=None, masks=None):
    """Under relu_dispatch, in this thread: every ReLU's input recorded (f64, on the CPU)
    into the list `record`, and, with `masks` (one a call, in order), computed as x * mask:
    the linear piece the masks came from."""
    _BRANCHES.state = (record, None if masks is None else iter(masks))
    try:
        yield
    finally:
        _BRANCHES.state = None
# MMDenseLSTM's recurrences a stem (egs/musdb18/mm-dense-lstm/config/paper.yaml): (band,
# pooling level, bins read, H a direction). Frames at level l: the chunk's halved l times.
MMDL_RNNS = [("low", 3, 48, 64), ("low", 1, 190, 64), ("middle", 3, 81, 16),
             ("high", 2, 257, 4), ("full", 4, 129, 64), ("full", 1, 1025, 64)]
MMDL_HOP = 2048
# 17k: (label, (B, T, H), input width, dtypes, training): each H at a 10 s chunk's longest
# sequence (B = 1, 216 frames at hop 2048) and at recipe training's (B = 6 x 6 s, 130 frames).
MMDL_SHAPES = [
    ("serve", (1, 108, 64), 1025, (torch.float32, torch.bfloat16), False),
    ("serve", (1, 27, 16), 81, (torch.float32, torch.bfloat16), False),
    ("serve", (1, 54, 4), 257, (torch.float32, torch.bfloat16), False),
    ("train", (6, 65, 64), 1025, (torch.float32,), True),
    ("train", (6, 17, 16), 81, (torch.float32,), True),
    ("train", (6, 33, 4), 257, (torch.float32,), True),
]
CONV_KERNEL = re.compile(r"conv|gemm|winograd|cutlass|xmma|fprop|dgrad|wgrad", re.I)
NORM_KERNEL = re.compile(r"batch_norm|batchnorm|bn_fw|bn_bw", re.I)


def mmdl_routes(B, dtype, backward=False, stems=4):
    """One MMDenseLSTM forward's (and backward's) recurrence launches over B sequences: six
    lstm_scan_bidir a stem, each H on the route _plan (_plan_bwd) gives it."""
    routes = {}
    for *_, H in MMDL_RNNS:
        keys = [f"lstm_scan_bidir/{plan(ls, B, 2, H, dtype)[0]}"]
        if backward:
            keys.append(f"lstm_scan_bidir_bwd/{plan_bwd(ls, B, 2, H, dtype)[0]}")
        for key in keys:
            routes[key] = routes.get(key, 0) + stems
    return routes


def slice_e_routes(kind, B, dtype=torch.float32, backward=False, stems=4):
    return mmdl_routes(B, dtype, backward, stems) if kind == "mm-dense-lstm" else {}


def slice_e_args(kind, *extra):
    return musdb_train_cli.build_parser().parse_args(
        ["--musdb18_root", "", "--seed", "0", *SLICE_E_CLI[kind], *extra])


def slice_e_sources(args):
    return [args.target] if args.model == "hrnet" else args.sources.split(",")


def slice_e_model(kind, device="cuda", *extra):
    """The train CLI's own model (seed 0) and criterion for `kind` at its recipe, BatchNorm
    running statistics off their start (so eval mode does real work)."""
    args = slice_e_args(kind, *extra)
    model, criterion = musdb_train_cli.build_model_and_criterion(args, slice_e_sources(args),
                                                                 device)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in model.named_buffers():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(0.5 + rng.random(t.shape, np.float32)))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(0.1 * rng.standard_normal(t.shape).astype(np.float32)))
    return model, criterion


def slice_e_batch(kind, B, seconds, device, seed=12):
    """Four stereo stems of noise and their sum at the recipe's rate -> (mixture (B, 1, 2,
    T), the targets: HRNet's vocals alone, (B, 1, 2, T), else (B, 4, 2, T))."""
    args = slice_e_args(kind)
    rng = np.random.default_rng(seed)
    sources = 0.1 * rng.standard_normal((B, 4, 2, int(seconds * args.sample_rate)),
                                        dtype=np.float32)
    mixture = torch.from_numpy(sources.sum(axis=1, keepdims=True)).to(device)
    targets = torch.from_numpy(sources).to(device)
    return mixture, targets[:, 3:] if kind == "hrnet" else targets


def slice_e_one_stem(kind):
    """The flags of a one-stem model for the CPU comparisons (CUNet's control network
    reads the four stems' one-hot: it keeps them; HRNet has one stem)."""
    return () if kind in ("cunet", "hrnet") else ("--sources", "vocals")


def phase_slice_e_kernels(card=None):
    """Phase 17k: lstm_scan_bidir at MMDenseLSTM's H = 64, 16 and 4 (the tensor-core routes
    for 64 and 16, the FMA kernel for 4), a 10 s chunk's B = 1 sequences in f32 and bf16
    and recipe training's B = 6 with cs and the backward, on the routes _plan gives,
    against the plain versions (lstm_kernel_timing, lstm_backward_timing: the FMA kernel
    forced beside a tensor-core route, cuDNN's nn.LSTM at the layer's input width, the
    bound); the launches by route of these checks. -> {(name, label, H, dtype): timing}."""
    card = card or card_line()
    log("== phase 17k: lstm_scan_bidir at MMDenseLSTM's H = 64, 16, 4 vs plain on the card "
        f"[{card}]")
    result = {}
    reset_counts()
    for label, (B, T, H), features, dtypes, training in MMDL_SHAPES:
        for dtype in dtypes:
            timing, inputs, hs, cs = lstm_kernel_timing("MMDenseLSTM", label, B, T, H, 2, dtype,
                                                        training, features)
            if timing["path"] == "fma":  # the whole call beside the kernel alone
                timing["kernel_ms"] = timing["ms"]
                timing["ms"] = graph_ms(lambda: ls._forward_cuda(inputs, training), 1, iters=5)
                log(f"    whole call {timing['ms']:.4f} ms, kernel alone "
                    f"{timing['kernel_ms']:.4f} ms")
            result[("lstm_scan_bidir", label, H, dtype)] = timing
            if training:
                result[("lstm_scan_bidir_bwd", label, H, dtype)] = lstm_backward_timing(
                    "MMDenseLSTM", label, inputs, hs, cs, features)
            del inputs, hs, cs
    log(f"  17k's checks launched by route {routes_of(all_counts())}")
    return result


def slice_e_parity_batch(kind, device):
    """The train step's batch against f64: B = 1 x SLICE_E_PARITY_SECONDS[kind], the targets
    of a one-stem model's stem."""
    mixture, targets = slice_e_batch(kind, 1, SLICE_E_PARITY_SECONDS[kind], device)
    return mixture, targets[:, 3:] if slice_e_one_stem(kind) else targets


def slice_e_cpu_side(kind):
    """The CPU's half of a one-stem model's checks: its 1 s forward, and one train step in
    f64 (its ReLU inputs recorded) and in f32 on the f64 step's ReLU sign pattern
    (musdb_grads_of_step, relu_branches)."""
    extra = slice_e_one_stem(kind)
    model, criterion = slice_e_model(kind, "cpu", *extra)
    with torch.inference_mode():
        forward = model.eval()(slice_e_batch(kind, 1, 1.0, "cpu")[0])
    batch = slice_e_parity_batch(kind, "cpu")
    relu_inputs = []
    with relu_branches(record=relu_inputs):
        ref = musdb_grads_of_step(copy.deepcopy(model).double().train(), criterion,
                                  tuple(t.double() for t in batch))
    with relu_branches(masks=[(x > 0).double() for x in relu_inputs]):
        cpu = musdb_grads_of_step(model.train(), criterion, batch)
    return dict(forward=forward, ref=ref, cpu=cpu, relu_inputs=relu_inputs)


def slice_e_card_vs_cpu(kind, cpu_side, card):
    """A one-stem model's 1 s forward on the card (every count set to 0 just before, read
    just after, held to its routes) against the CPU's (`cpu_side`, <= 1e-3 x max|CPU|),
    f32; then the base model in bf16 on the card against the f32 card run (SNR >=
    SNR_LIMIT_DB). -> the card forwards' launches."""
    log(f"== phase 17: {kind}: card vs CPU (a one-stem model, 1 s), bf16 vs f32")
    card_model, _ = slice_e_model(kind, "cuda", *slice_e_one_stem(kind))
    stems = len(card_model.base.sources) if hasattr(card_model.base, "sources") else 1
    x = slice_e_batch(kind, 1, 1.0, "cuda")[0]
    reset_counts()
    with torch.inference_mode():
        got = card_model.eval()(x)
        torch.cuda.synchronize()
        grew = all_counts()
        amp = card_model.spectrogram(x).abs()  # (1, 1, 2, F, S)
        inputs = (amp,) if kind not in ("hrnet", "cunet") else (amp[:, 0],)
        if kind == "cunet":  # every stem's one-hot, as ConditionedSpectrogramWrapper
            n = card_model.n_sources
            inputs = (amp[:, 0].repeat(n, 1, 1, 1), torch.eye(n, device="cuda"))
        base16 = copy.deepcopy(card_model.base).to(torch.bfloat16)
        f32 = card_model.base(*inputs)
        b16 = base16(*(t.bfloat16() for t in inputs))
        torch.cuda.synchronize()
        grew16 = grown(grew)
    check_dptnet_launches(grew, slice_e_routes(kind, 1, stems=stems),
                          f"{kind}: a card forward")
    check_dptnet_launches(grew16, add_counts(
        slice_e_routes(kind, 1, stems=stems), slice_e_routes(kind, 1, torch.bfloat16,
                                                             stems=stems)),
        f"{kind}: the f32 and bf16 base forwards")
    ref = cpu_side["forward"]
    err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
    diff = (b16.float() - f32).double()
    snr = 10 * float(torch.log10(f32.double().square().sum() / diff.square().sum()))
    log(f"  {kind} ({stems} stem{'s' * (stems > 1)}) {tuple(got.shape)}: card vs CPU max abs err "
        f"{err:.3e}, max|CPU| {scale:.3e}, limit {1e-3 * scale:.3e}; bf16 vs f32 on the card "
        f"{snr:.2f} dB (limit {SNR_LIMIT_DB:g}); launches {nonzero(grew)} [{card}]")
    check(torch.isfinite(got).all() and got.shape == ref.shape and err <= 1e-3 * scale,
          f"{kind}: the card's forward disagrees with the CPU's: {err}")
    check(snr >= SNR_LIMIT_DB, f"{kind}: bf16 SNR {snr:.2f} dB < {SNR_LIMIT_DB}")
    return add_counts(grew, grew16)


def slice_e_train_parity(kind, cpu_side):
    """One train step of a one-stem model at recipe widths on the card (f32, TF32 off) on
    the f64 step's ReLU sign pattern against the f64 CPU step beside the f32 CPU step of
    `cpu_side` (hold_step_against_f64), B = 1 x SLICE_E_PARITY_SECONDS[kind]; the card's own
    ReLU inputs on the other side of 0 only within their call's rounding (relu_branches); its
    launches held to the routes. -> the card step's launches."""
    card_model, card_criterion = slice_e_model(kind, "cuda", *slice_e_one_stem(kind))
    stems = len(card_model.base.sources) if hasattr(card_model.base, "sources") else 1
    f64_inputs, card_inputs = cpu_side["relu_inputs"], []
    reset_counts()
    with relu_branches(card_inputs, [(x > 0).double() for x in f64_inputs]):
        card = musdb_grads_of_step(card_model, card_criterion,
                                   slice_e_parity_batch(kind, "cuda"))
    torch.cuda.synchronize()
    grew = all_counts()
    check(len(card_inputs) == len(f64_inputs), f"{kind}: {len(card_inputs)} ReLU calls on the "
                                               f"card, {len(f64_inputs)} in f64")
    flipped, worst = 0, 0.0
    for ours, ref in zip(card_inputs, f64_inputs):
        other = (ours > 0) != (ref > 0)
        if other.any():
            flipped += int(other.sum())
            rounding = float((ours - ref)[~other].abs().max()) if (~other).any() else 0.0
            worst = max(worst, float(ref[other].abs().max()) / max(rounding, 1e-300))
    log(f"  {kind}: {len(card_inputs)} ReLU calls, {flipped} card inputs on the other side of 0 "
        f"than in f64, the farthest {worst:.3f} x its call's largest |card - f64| elsewhere "
        f"(limit 1)")
    check(worst <= 1, f"{kind}: a card ReLU input flipped {worst} x its call's rounding from 0")
    check_dptnet_launches(grew, slice_e_routes(kind, 1, backward=True, stems=stems),
                          f"{kind}: a train step")
    hold_step_against_f64(f"{kind} (B=1 x {SLICE_E_PARITY_SECONDS[kind]:g} s, {stems} stem"
                          f"{'s' * (stems > 1)})", cpu_side["ref"], cpu_side["cpu"], card, grew)
    return grew


def hold_step_against_f64(tag, ref, cpu, card, launched):
    """check_step_against_f64 with each tensor's scale at least SLICE_E_SMALL_GRAD x the
    largest gradient. A gradient that is 0 in the f64 step (a bias into a train-mode
    BatchNorm of one channel: the batch's mean takes it out exactly) is held to
    MUSDB_NULL_GRAD x the largest on the card and the CPU, and left out of the comparison."""
    top = max(float(g.abs().max()) for g in ref[1].values())
    null = [n for n, g in ref[1].items() if not bool(g.abs().max() > 0)]
    for n in null:
        worst = max(float(cpu[1][n].abs().max()), float(card[1][n].abs().max()))
        log(f"  {tag}: {n} has a gradient of 0 in f64; card and CPU f32 at most {worst:.2e} "
            f"(limit {MUSDB_NULL_GRAD * top:.2e})")
        check(worst <= MUSDB_NULL_GRAD * top, f"{tag}: {n}'s null gradient is {worst}")
    ref, cpu, card = ((loss, {n: g for n, g in grads.items() if n not in null})
                      for loss, grads in (ref, cpu, card))
    check_step_against_f64(tag, ref, cpu, card, kernels_of(launched),
                           null_floor=SLICE_E_SMALL_GRAD)


def slice_e_recipe_step(kind, card):
    """The recipe's train step at its batch, or at the largest power-of-two batch below it
    that fits (fitting_step): p50, split, audio-s/s and peak. -> (batch, numbers)."""
    args = slice_e_args(kind)
    model, criterion = slice_e_model(kind)
    optimizer = make_optimizer("adam", args.lr, args.max_norm, params=model.parameters())
    model.train()
    B, p50, (fwd, bwd, opt), peak = fitting_step(
        kind, optimizer, lambda B: slice_e_batch(kind, B, args.duration, "cuda"),
        lambda batch: criterion(model(batch[0]), batch[1]), args.batch_size, args.duration,
        iters=1)
    log(f"  {kind}: recipe step at B={B} x {args.duration:g} s (recipe B={args.batch_size}): "
        f"{p50:.3f} ms, one after a warm-up (forward + loss {fwd:.3f}, backward {bwd:.3f}, optimizer "
        f"{opt:.3f} ms, CUDA events), {B * args.duration / (p50 / 1e3):.2f} audio-s/s, peak "
        f"{peak:.1f} MiB [{card}]")
    del model, optimizer
    torch.cuda.empty_cache()
    return B, dict(p50_ms=p50, forward_ms=fwd, backward_ms=bwd, optimizer_ms=opt,
                   peak_mib=peak, batch=B)


def slice_e_cli(kind, root, batch, tmp, card):
    """cli/train_musdb18.py at the recipe's flags and `batch` on the synthetic corpus, two
    epochs of one step: the steps (B = batch) and validation forwards (B = 1 x 10 s)
    counted apart and held to their routes, the epoch train loss falling, the peak
    allocation; the last checkpoint reopened by load_model computes the trained model's
    function. -> (launches, the checkpoint's path, the run's peak allocation in MiB)."""
    log(f"== phase 17: train {kind} through cli/train_musdb18.py (recipe flags, B={batch})")
    exp = os.path.join(tmp, f"exp_{kind}")
    argv = ["--musdb18_root", root, "--seed", "0", *SLICE_E_CLI[kind], "--batch_size",
            str(batch), "--epochs", "2", "--samples_per_epoch", str(batch),
            "--valid_duration", str(WAVE_SECONDS), "--cache_in_memory", "1", "--exp_dir", exp,
            "--device", "cuda"]
    musdb_train_cli.Trainer = CountedValidationTrainer
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            trainer = musdb_train_cli.main(argv)
    finally:
        musdb_train_cli.Trainer = Trainer
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    grew, peak = all_counts(), torch.cuda.max_memory_allocated() / 2 ** 20
    validated = trainer.validated
    stepped = {k: v - validated[k] for k, v in grew.items()}
    steps, evals = 2 * len(trainer.train_loader), 2 * len(trainer.valid_loader)
    stems = 1 if kind == "hrnet" else 4
    check_dptnet_launches(stepped, {k: steps * v for k, v in slice_e_routes(
        kind, batch, backward=True, stems=stems).items()}, f"the {kind} CLI's steps")
    check_dptnet_launches(validated, {k: evals * v for k, v in slice_e_routes(
        kind, 1, stems=stems).items()}, f"the {kind} CLI's validation")
    losses = trainer.train_loss
    log(f"  {steps} steps of B={batch}, {evals} validation forwards in {seconds:.1f} s, peak "
        f"{peak:.1f} MiB: "
        f"train loss by epoch {[round(v, 6) for v in losses]}, valid "
        f"{[round(v, 6) for v in trainer.valid_loss]}; launches {nonzero(grew)}; the CLI's "
        "last lines: " + " | ".join(out.getvalue().strip().splitlines()[-2:]) + f" [{card}]")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"the {kind} CLI's epoch train loss did not fall: {losses}")
    ckpt = os.path.join(exp, "model", "last.ckpt")
    model = load_model(ckpt, device="cuda")
    x = slice_e_batch(kind, 1, 1.0, "cuda")[0]
    reset_counts()
    with torch.inference_mode():
        got, want = model(x), trainer.model.eval()(x)
    served = all_counts()
    check_dptnet_launches(served, {k: 2 * v for k, v in slice_e_routes(kind, 1, stems=stems)
                                   .items()}, f"{kind}: the reopened checkpoint")
    err = float((got - want).abs().max())
    check(err <= 1e-6 * float(want.abs().max()),
          f"{kind}: the reopened checkpoint computes another function: {err}")
    del model, trainer
    torch.cuda.empty_cache()
    return add_counts(grew, served), ckpt, peak


def slice_e_evaluate(kind, root, ckpt, cpu_run, card):
    """The trained checkpoint through cli/test_musdb18.py on the card (every count set to 0
    just before, read just after) against the same CLI on the CPU (`cpu_run`, a future):
    the stems within 1e-3 x max|CPU|, every median within MUSDB_DB_TOL dB. -> launches."""
    log(f"== phase 17: {kind}: cli/test_musdb18.py --device cuda vs --device cpu on a "
        f"{SLICE_E_TRACK_SECONDS:g} s synthetic track")
    reset_counts()
    table, stats, stems = run_slice_e_cli(root, ckpt, "cuda")
    launches = all_counts()
    chunks = sum(st["chunks"] for st in stats)
    check_dptnet_launches(launches, {k: chunks * v for k, v in slice_e_routes(kind, 1)
                                     .items()}, f"{kind}: the evaluation")
    cpu_table, _, cpu_stems = cpu_run.result()
    for got, ref in zip(stems, cpu_stems):
        err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
        log(f"  stems {got.shape} card vs CPU max abs err {err:.3e}, max|CPU| {scale:.3e}, "
            f"limit {1e-3 * scale:.3e}")
        check(np.isfinite(got).all() and err <= 1e-3 * scale,
              f"{kind}: the card's stems disagree with the CPU's: {err} > 1e-3 x {scale}")
    check(len(stems) == len(cpu_stems) == 1, "tracks evaluated")
    worst = max(abs(table[s][m] - cpu_table[s][m]) for s in table for m in Evaluater.METRICS)
    log(f"  {kind} medians card vs CPU: worst {worst:.4f} dB (limit {MUSDB_DB_TOL}); SDR "
        + ", ".join(f"{s} {table[s]['SDR']:.3f}" for s in table) + f" [{card}]")
    check(worst <= MUSDB_DB_TOL, f"{kind}: a median differs from the CPU's by {worst:.4f} dB")
    return launches


def run_slice_e_cli(root, ckpt, device):
    """cli/test_musdb18.py on `device`, one chunk a track -> (medians, stats, float stems)."""
    table, stats = musdb_cli.run([
        "--musdb18_root", root, "--model_path", ckpt, "--device", device, "--sample_rate",
        str(MUSDB_SAMPLE_RATE), "--duration", str(SLICE_E_TRACK_SECONDS), "--filt_len",
        str(MUSDB_FILT_LEN)])
    return table, stats, RecordingEvaluater.stems.pop(threading.get_ident())


def slice_e_forward_profile(kind, ckpt, card):
    """The trained checkpoint's B = 1 x 10 s forward (four stems, f32): ms (median of 3 after
    one warm-up), then one profiled forward: device busy, idle share, device time by kind
    (convs and GEMMs, BatchNorm, the recurrence kernels, elementwise and the rest). ->
    (numbers, launches)."""
    from torch.profiler import ProfilerActivity, profile

    model = load_model(ckpt, device="cuda")
    x = slice_e_batch(kind, 1, WAVE_SECONDS, "cuda")[0]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = median_ms(lambda: model(x), warmup=1, iters=3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3
    launches = all_counts()
    check_dptnet_launches(launches, {k: 5 * v for k, v in slice_e_routes(kind, 1).items()},
                          f"{kind}: the B=1 x 10 s forwards")
    device = device_times(prof)
    busy = sum(device.values())
    split = {"convs and GEMMs": 0.0, "BatchNorm": 0.0, "recurrences": 0.0,
             "elementwise and other": 0.0}
    for name, t in device.items():
        if any(n in name for n in FORWARD_KERNELS):
            split["recurrences"] += t
        elif NORM_KERNEL.search(name):
            split["BatchNorm"] += t
        elif CONV_KERNEL.search(name):
            split["convs and GEMMs"] += t
        else:
            split["elementwise and other"] += t
    idle = max(0.0, 1 - busy / wall)
    log(f"  {kind} B=1 x {WAVE_SECONDS:g} s forward (four stems, f32): {ms:.3f} ms (median "
        f"of 3), {WAVE_SECONDS / (ms / 1e3):.1f} audio-s/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB; profiled: wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share {idle:.1%}; "
        + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in split.items()) + f" [{card}]")
    top = sorted(device.items(), key=lambda kv: -kv[1])[:5]
    log("    top device time: " + ", ".join(f"{k[:48]} {t:.3f} ms" for k, t in top))
    del model
    return dict(ms=ms, wall_ms=wall, busy_ms=busy, idle_share=idle, **split), launches


def phase_slice_e(card=None, tmp=None):
    """Phase 17 (17k first) -> {"launches": the main path's counts (the card forwards, the
    train steps, the CLIs' steps, validation and reopened checkpoints, the evaluations, the
    profiled forwards), "kernels": 17k's timings, "numbers"}."""
    card = card or card_line()
    numbers, total = {}, {}
    musdb_cli.Evaluater = RecordingEvaluater
    with contextlib.ExitStack() as stack:
        kernels = phase_slice_e_kernels(card)
        # The CPU's halves of the checks and the CPU evaluations run in a thread beside the
        # card's work from here on, one task at a time, on all but SLICE_E_HOST_CORES of the
        # host's cores: the thread driving the card keeps those (the card's host-bound steps
        # ran up to 2.3x slower beside a thread on every core).
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads - SLICE_E_HOST_CORES))
        stack.callback(torch.set_num_threads, threads)
        stack.enter_context(relu_dispatch())  # the parity steps' ReLU branches
        pool = stack.enter_context(ThreadPoolExecutor(1))
        cpu_sides = {kind: pool.submit(slice_e_cpu_side, kind) for kind in SLICE_E_CLI}
        tmp = tmp or stack.enter_context(tempfile.TemporaryDirectory())
        roots = {}
        for rate in (MUSDB_SAMPLE_RATE, 16000):
            roots[rate] = os.path.join(tmp, f"musdb18_{rate}")
            with contextlib.redirect_stdout(io.StringIO()):
                write_musdb_quality_corpus(roots[rate], n_train=2, n_valid=1, n_test=1,
                                           track_sec=WAVE_SECONDS, sample_rate=rate)
        eval_root = os.path.join(tmp, "musdb18_eval")
        with contextlib.redirect_stdout(io.StringIO()):
            write_musdb_quality_corpus(eval_root, n_train=0, n_valid=0, n_test=1,
                                       track_sec=SLICE_E_TRACK_SECONDS,
                                       sample_rate=MUSDB_SAMPLE_RATE)
        evaluations = []
        for kind in SLICE_E_CLI:
            log(f"== phase 17: {kind}: the recipe step at its batch or the largest that fits")
            batch, numbers[kind] = slice_e_recipe_step(kind, card)
            root = roots[slice_e_args(kind).sample_rate]
            launches, ckpt, numbers[kind]["cli_peak_mib"] = slice_e_cli(kind, root, batch, tmp,
                                                                        card)
            total = add_counts(total, launches)
            if kind in SLICE_E_EVALUATED:
                evaluations.append((kind, ckpt, pool.submit(run_slice_e_cli, eval_root, ckpt,
                                                            "cpu")))
                numbers[kind]["forward"], launches = slice_e_forward_profile(kind, ckpt, card)
                total = add_counts(total, launches)
        for kind in SLICE_E_CLI:
            cpu_side = cpu_sides[kind].result()
            total = add_counts(total, slice_e_card_vs_cpu(kind, cpu_side, card))
            total = add_counts(total, slice_e_train_parity(kind, cpu_side))
        for kind, ckpt, cpu_run in evaluations:
            total = add_counts(total, slice_e_evaluate(kind, eval_root, ckpt, cpu_run, card))
    musdb_cli.Evaluater = Evaluater
    for key in ("lstm_scan_bidir/tf32x3", "lstm_scan_bidir/fma", "lstm_scan_bidir_bwd/tf32x3",
                "lstm_scan_bidir_bwd/fma", "lstm_scan_bidir/mma"):
        check(total.get(key, 0) > 0, f"phase 17 never launched {key}")
    log(f"  phase 17 main-path launches: {nonzero(total)}")
    return dict(launches=total, kernels=kernels, numbers=numbers)


# Phase 18: slice G's wsj0-mix half at the recipe's width: ORPIT Conv-TasNet over 2+3
# speakers (the port's egs/wsj0-mix/orpit_conv-tasnet/{train,test}.sh), the other PITs, the
# oracle masks (egs/wsj0-mix/frequency-mask/test.sh), and the library's phase retrieval,
# NMF and MixIT, card against CPU.
ORPIT_CLI = ["--model", "conv-tasnet", "--criterion", "orpit", "-N", "512", "-L", "16",
             "-H", "512", "-B", "128", "-Sc", "128", "-P", "3", "-R", "3", "-X", "8",
             "--enc_nonlinear", "relu", "--batch_size", "4", "--lr", "1e-3", "--n_sources", "3"]
ORPIT_UTTS = 4  # train utterances of each speaker count (about 3 steps of B = 4 x 4 s)
ORPIT_PARITY_SECONDS = 0.125  # the f64 step: one 2- and one 3-speaker window
ORPIT_FIXED_STEPS = 6  # a fixed batch's loss must fall over these (timed: the step's p50)
ORPIT_VALID_SHAPE = dict(B=4, S=2, T=3999, N=512, CL=16)  # a validation batch, 4 x 4 s
PIT_SECONDS = 0.5  # the other PITs' utterances: one step of B = 4 a CLI run, one validation
PIT_CLI = ["--model", "conv-tasnet", "--batch_size", "4", "--n_sources", "3",
           "--duration", str(PIT_SECONDS), "--valid_duration", str(PIT_SECONDS)]  # paper width
PITS = ("hungarian", "prob", "sink")
PIT_TIMED = 20  # criterion calls a median of the Hungarian host time
ORACLE_UTTS = 3
ORACLE_TOL_DB = 1e-3  # card vs CPU, each mask's mean SI-SDRi
LIB_STFT = dict(n_fft=256, hop_length=64)
LIB_SECONDS = 4.0
LIB_ITERATIONS = 5  # Griffin-Lim, fast Griffin-Lim and MISI
NMF_BASIS, NMF_ITERATIONS = 16, 50
LIB_TOL = 1e-3  # card vs the CPU's f64 run, relative to its max (or 10x the CPU's f32 error)
MIXIT_BATCH, MIXIT_EST = 8, 4


class RecordedCriterion:
    """A PIT-protocol criterion that keeps its last (loss, indices) output."""

    def __init__(self, criterion):
        self.criterion, self.out = criterion, None

    def __call__(self, *args, **kwargs):
        self.out = self.criterion(*args, **kwargs)
        return self.out


@contextlib.contextmanager
def held_to_plain(module, plain, limit_of):
    """Every launch that the wrappers `module.<name>` (a name a key of `plain`) make on the
    card in the block, held to `plain[name]` of the same inputs: each output within
    tol x scale, (scale, tol) = limit_of(the wrapper's first input, output, plain output)
    -> {"n": launches held, "worst": the largest error over its scale}."""
    held = {"n": 0, "worst": 0.0}
    launch = {name: getattr(module, name) for name in plain}

    def held_version(name):
        def checked(*args, **kwargs):
            out = launch[name](*args, **kwargs)
            if args[0].is_cuda:
                ref = plain[name](*args, **kwargs)
                for o, r in zip(out, ref) if isinstance(out, tuple) else [(out, ref)]:
                    scale, tol = limit_of(args[0], o, r)
                    err = float((o.float() - r.float()).abs().max()) / scale
                    check(err <= tol, f"a {name} launch disagrees with the plain version: "
                                      f"{err:.2e} x its scale > {tol:g}")
                    held["worst"] = max(held["worst"], err)
                held["n"] += 1
            return out
        return checked

    for name in plain:
        setattr(module, name, held_version(name))
    try:
        yield held
    finally:
        for name, fn in launch.items():
            setattr(module, name, fn)


def decodes_held_to_plain():
    """held_to_plain over every fused_mask_decode the port's decoder launches, each within
    TOL x max|plain|."""
    return held_to_plain(
        filterbank,
        {"fused_mask_decode": lambda w, mask, kernel, *_, **__:
            md.fused_mask_decode_reference(w, mask, kernel)},
        lambda w, out, ref: (float(ref.abs().max()) or 1.0, TOL[w.dtype]))


def write_orpit_corpus(tmp, split, n_utts):
    """A 2+3-speaker split: write_quality_corpus's two- and three-speaker utterances of
    `split` moved into one root and one list, each ID prefixed with its count (a
    two-speaker utterance has no s3/ file) -> (wav_root, list_path)."""
    root = os.path.join(tmp, "orpit", split)
    utts = []
    for n in (2, 3):
        with contextlib.redirect_stdout(io.StringIO()):
            src_root, src_list = write_quality_corpus(os.path.join(tmp, f"orpit_{n}spk"),
                                                      split, n_utts, n_sources=n)
        with open(src_list) as f:
            ids = f.read().split()
        for sub in ["mix"] + [f"s{k + 1}" for k in range(n)]:
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            for utt in ids:
                os.replace(os.path.join(src_root, sub, f"{utt}.wav"),
                           os.path.join(root, sub, f"{n}spk_{utt}.wav"))
        utts += [f"{n}spk_{utt}" for utt in ids]
    with open(root + ".lst", "w") as f:
        f.write("\n".join(utts))
    return root, root + ".lst"


def orpit_grads_of_step(model, batch):
    """One ORPIT make_train_step (SGD at lr 0) -> (loss, gradients, the chosen "one")."""
    criterion = RecordedCriterion(ORPIT(NegSISDR()))
    step = make_train_step(model, criterion, make_optimizer("sgd", 0.0,
                                                           params=model.parameters()))
    loss = float(step(*batch))
    grads = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    return loss, grads, criterion.out[1].cpu()


def orpit_parity_model(device):
    return scramble_norms(ConvTasNet(**PAPER, generator=torch.Generator().manual_seed(0),
                                     device=device))


def orpit_parity_batch(tr_root, tr_list):
    """The first two- and three-speaker windows of ORPIT_PARITY_SECONDS, as one batch."""
    data = wsj0mix_data.WaveTrainVariableSourcesDataset(
        tr_root, tr_list, samples=int(ORPIT_PARITY_SECONDS * SAMPLE_RATE), max_sources=3)
    first = {}
    for i in range(len(data)):
        first.setdefault(int(data[i][2]), i)
        if len(first) == 2:
            break
    return tuple(torch.from_numpy(np.stack(f)) for f in zip(*(data[first[n]] for n in (2, 3))))


def orpit_parity_cpu(batch):
    """The CPU's halves of the parity step: the f64 step and the f32 one."""
    cpu_model = orpit_parity_model("cpu")
    ref = orpit_grads_of_step(copy.deepcopy(cpu_model).double(),
                              (batch[0].double(), batch[1].double(), batch[2]))
    return ref, orpit_grads_of_step(cpu_model, batch)


def orpit_train_parity(batch, cpu_side):
    """One ORPIT train step of paper-config Conv-TasNet on the card against an f64 CPU
    step (and the CPU's f32 one; `cpu_side` their future), as phase 7: a two- and a
    three-speaker window."""
    log(f"== phase 18a: one ORPIT train step, card vs CPU (f32, TF32 off, B=2 x "
        f"{ORPIT_PARITY_SECONDS} s, counts [2, 3]; f64 CPU reference)")
    before = all_counts()
    card = orpit_grads_of_step(orpit_parity_model("cuda"), tuple(t.cuda() for t in batch))
    torch.cuda.synchronize()
    launched = kernels_of(grown(before))
    check(launched == expected(), f"an ORPIT train step launched {launched}: training "
                                  f"decodes with the plain version")
    ref, cpu = cpu_side.result()
    check_step_against_f64("orpit_conv_tasnet", ref[:2], cpu[:2], card[:2], launched)
    check(torch.equal(card[2], ref[2]) and torch.equal(cpu[2], ref[2]),
          f"the chosen one differs: card {card[2].tolist()}, CPU f32 {cpu[2].tolist()}, "
          f"f64 {ref[2].tolist()}")
    log(f"  the chosen one: card {card[2].tolist()} = CPU f32 = f64")


def orpit_train_cli(corpus, card):
    """The ORPIT recipe through cli/train_wsj0mix.py at its width, two epochs; a fixed
    batch's loss over ORPIT_FIXED_STEPS more steps, timed -> (launches, checkpoint)."""
    (tr_root, tr_list), (cv_root, cv_list), tmp = corpus
    log("== phase 18a: ORPIT Conv-TasNet through cli/train_wsj0mix.py --criterion orpit "
        "--n_sources 3 (the recipe's width, B = 4 x 4 s, two epochs)")
    exp = os.path.join(tmp, "exp_orpit")
    torch.cuda.reset_peak_memory_stats()
    before = all_counts()
    trainer = train_cli.main(["--train_wav_root", tr_root, "--train_list_path", tr_list,
                              "--valid_wav_root", cv_root, "--valid_list_path", cv_list,
                              "--duration", "4", "--valid_duration", "4", *ORPIT_CLI,
                              "--epochs", "2", "--exp_dir", exp, "--device", "cuda"])
    torch.cuda.synchronize()
    grew = grown(before)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    check(type(trainer).__name__ == "ORPITTrainer", type(trainer))
    losses = trainer.train_loss + trainer.valid_loss
    check(len(trainer.train_loss) == 2 and all(np.isfinite(losses)), losses)
    evals = 2 * len(trainer.valid_loader)
    check(kernels_of(grew) == expected(fused_mask_decode=evals),
          f"the ORPIT CLI launched {kernels_of(grew)}, expected {evals} decodes (one a "
          f"validation batch; the steps decode with the plain version)")
    check_paths(grew, {}, "the ORPIT CLI", "generic")
    data = trainer.train_loader.dataset
    counts_seen = sorted({int(data[i][2]) for i in range(len(data))})
    check(counts_seen == [2, 3], f"the train windows' counts {counts_seen}")
    # A fixed batch of both counts: the loss must fall; the steps timed on the host clock,
    # each ended by a synchronize.
    order = sorted(range(len(data)), key=lambda i: int(data[i][2]))
    picks = [order[0], order[1], order[-2], order[-1]]
    batch = tuple(torch.from_numpy(np.stack(f)).cuda() for f in zip(*(data[i] for i in picks)))
    losses, times = [], []
    for _ in range(ORPIT_FIXED_STEPS):
        start = time.perf_counter()
        losses.append(float(trainer.train_step(*batch)))
        times.append((time.perf_counter() - start) * 1e3)
    p50 = float(np.median(times[1:]))
    log(f"  epochs: train loss {[round(v, 4) for v in trainer.train_loss]}, valid loss "
        f"{[round(v, 4) for v in trainer.valid_loss]}; {len(trainer.train_loader)} steps and "
        f"{len(trainer.valid_loader)} validation batches an epoch; CLI p50 "
        f"{trainer.last_epoch_stats['iter_p50_ms']:.1f} ms; a fixed batch (counts "
        f"{batch[2].tolist()}) over {ORPIT_FIXED_STEPS} steps: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, step p50 {p50:.1f} ms (host clock, synchronised); peak "
        f"allocation {peak_mib:.1f} MiB; launches {nonzero(kernels_of(grew))} [{card}]")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"ORPIT: {ORPIT_FIXED_STEPS} steps on one batch did not lower its loss: {losses}")
    return grew, os.path.join(exp, "model", "last.ckpt"), dict(step_p50_ms=p50,
                                                               peak_mib=peak_mib)


def orpit_eval_flags(ckpt):
    """The port's orpit_conv-tasnet/test.sh flags beyond the data, model and device."""
    return ["--out_dir", os.path.join(os.path.dirname(os.path.dirname(ckpt)), "test")]


def orpit_evaluate(test_set, ckpt, cpu_runs, card):
    """The ORPIT checkpoint (the (one, rest) pair) through cli/test_wsj0mix.py at the port's
    orpit_conv-tasnet/test.sh flags, card vs CPU (`cpu_runs` the CPU's futures), one
    utterance a call."""
    log("== phase 18b: the ORPIT checkpoint through cli/test_wsj0mix.py (test.sh's flags), "
        "card vs CPU")
    root, lists = test_set
    total = dict.fromkeys(all_counts(), 0)
    for list_path, T, cpu_run in zip(lists, TEST_LENGTHS, cpu_runs):
        before = all_counts()
        got = evaluate(root, list_path, ckpt, "cuda", orpit_eval_flags(ckpt))
        grew = grown(before)
        check(kernels_of(grew) == expected(fused_mask_decode=1),
              f"an ORPIT evaluation launched {kernels_of(grew)}")
        check_paths(grew, {}, "an ORPIT evaluation", "generic")
        total = add_counts(total, grew)
        ref = cpu_run.result()
        diffs = {k: abs(got[k] - ref[k]) for k in TEST_METRICS}
        check(all(np.isfinite(got[k]) for k in TEST_METRICS), got)
        log(f"  {T} samples: SI-SDRi {got['loss_improvement']:.3f} dB (CPU "
            f"{ref['loss_improvement']:.3f}), max |card - CPU| {max(diffs.values()):.2e} dB; "
            f"forward {got['forward_ms']:.1f} ms [{card}]")
        check(max(diffs.values()) <= EVAL_TOL_DB, f"ORPIT: card metrics differ: {diffs}")
    return total


def write_pit_corpus(tmp):
    """Four three-speaker utterances of exactly PIT_SECONDS (one window each), the first one
    alone the validation list -> the CLI's data flags."""
    root = os.path.join(tmp, "pit", "tr")
    for sub in ("mix", "s1", "s2", "s3"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    speakers = _speaker_bank(12, seed=21)
    rng = np.random.default_rng(22)
    T = int(PIT_SECONDS * SAMPLE_RATE)
    for i in range(4):
        srcs = [synth_pseudo_speech(speakers[3 * i + k], rng, T, SAMPLE_RATE)
                for k in range(3)]
        scale = 0.9 / max(float(np.abs(sum(srcs)).max()), 1e-9)
        for sub, sig in (*((f"s{k + 1}", s) for k, s in enumerate(srcs)), ("mix", sum(srcs))):
            write_wav(os.path.join(root, sub, f"pit{i}.wav"), sig * scale, SAMPLE_RATE)
    with open(root + ".lst", "w") as f:
        f.write("\n".join(f"pit{i}" for i in range(4)))
    with open(root + "_valid.lst", "w") as f:
        f.write("pit0")
    return ["--train_wav_root", root, "--train_list_path", root + ".lst",
            "--valid_wav_root", root, "--valid_list_path", root + "_valid.lst", *PIT_CLI]


def pit_run(data, pit, tmp, device):
    """One epoch (one step) of cli/train_wsj0mix.py --pit `pit` on `device`."""
    return train_cli.main([*data, "--pit", pit, "--epochs", "1", "--exp_dir",
                           os.path.join(tmp, f"exp_{pit}_{device}"), "--device", device])


def other_pits(data, cpu_runs, tmp, card):
    """--pit hungarian | prob | sink: one CLI step each at the paper width (3 sources,
    B = 4 x PIT_SECONDS), card vs CPU (`cpu_runs` the CPU's futures by PIT); Hungarian's pattern
    against exhaustive PIT's and the host time its solve adds to a step."""
    log(f"== phase 18c: --pit hungarian | prob | sink, one step each through "
        f"cli/train_wsj0mix.py (paper width, 3 sources, B = 4 x {PIT_SECONDS:g} s), card vs "
        f"CPU")
    total = dict.fromkeys(all_counts(), 0)
    for pit in PITS:
        before = all_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = pit_run(data, pit, tmp, "cuda")
        grew = grown(before)
        check(len(trainer.train_loader) == 1 and len(trainer.valid_loader) == 1,
              (len(trainer.train_loader), len(trainer.valid_loader)))
        check(kernels_of(grew) == expected(fused_mask_decode=1),
              f"--pit {pit} launched {kernels_of(grew)}: one validation decode expected")
        check_paths(grew, {}, f"--pit {pit}", "generic")
        total = add_counts(total, grew)
        cpu = cpu_runs[pit].result()
        losses = {"cuda": (trainer.train_loss[0], trainer.valid_loss[0]),
                  "cpu": (cpu.train_loss[0], cpu.valid_loss[0])}
        err = abs(losses["cuda"][0] - losses["cpu"][0]) / abs(losses["cpu"][0])
        log(f"  --pit {pit}: step loss card {losses['cuda'][0]:.6f}, CPU "
            f"{losses['cpu'][0]:.6f} (relative err {err:.2e}, limit {LOSS_TOL:g}); valid loss "
            f"after the step {losses['cuda'][1]:.6f} / {losses['cpu'][1]:.6f}")
        check(np.isfinite(losses["cuda"]).all() and err <= LOSS_TOL,
              f"--pit {pit}: the card's step loss {losses['cuda'][0]} differs from the CPU's "
              f"{losses['cpu'][0]}")
    # Hungarian against exhaustive PIT on the trained model's estimates of the step's batch,
    # and the host time the assignment adds (its device-to-host copy waits for the forward).
    items = [trainer.train_loader.dataset[i] for i in range(4)]
    mixture, sources = (torch.from_numpy(np.stack(f)).cuda() for f in zip(*items))
    before = all_counts()
    with torch.no_grad():
        estimates = trainer.model.eval()(mixture)
    grew = grown(before)
    check(kernels_of(grew) == expected(fused_mask_decode=1), f"a forward launched {grew}")
    total = add_counts(total, grew)
    hungarian, exhaustive = HungarianLoss(NegSISDR()), PIT1d(NegSISDR(), n_sources=3)
    h_loss, h_pattern = hungarian(estimates, sources)
    e_loss, e_pattern = exhaustive(estimates, sources)
    check(torch.equal(h_pattern, e_pattern) and abs(float(h_loss) - float(e_loss))
          <= 1e-5 * abs(float(e_loss)), f"Hungarian {h_pattern.tolist()} {float(h_loss)} vs "
                                         f"exhaustive {e_pattern.tolist()} {float(e_loss)}")

    def host_ms(criterion):
        ms = []
        for _ in range(PIT_TIMED):
            torch.cuda.synchronize()
            start = time.perf_counter()
            float(criterion(estimates, sources)[0])
            ms.append((time.perf_counter() - start) * 1e3)
        return float(np.median(ms))

    h_ms, e_ms = host_ms(hungarian), host_ms(exhaustive)
    log(f"  Hungarian pattern = exhaustive PIT's {h_pattern.tolist()}; a criterion call "
        f"(B = 4, n = 3, {PIT_SECONDS:g} s) ended by its loss on the host: Hungarian "
        f"{h_ms:.3f} ms, exhaustive {e_ms:.3f} ms: the solve adds {h_ms - e_ms:.3f} ms a step "
        f"(medians of "
        f"{PIT_TIMED}, host clock) [{card}]")
    return total, dict(hungarian_ms=h_ms, exhaustive_ms=e_ms)


def oracle_argv(test_set, mask):
    root, lst = test_set
    return ["--test_wav_root", root, "--test_list_path", lst, "--mask", mask, "--n_fft", "256",
            "--hop_length", "64"]


def oracle_masks(test_set, cpu_means, card):
    """cli/test_oracle_masks.py with each mask on the card against the CPU (`cpu_means` the
    CPU runs' futures by mask), the card's time an utterance."""
    log("== phase 18d: cli/test_oracle_masks.py (ibm, irm, wfm, psm; n_fft 256, hop 64), "
        "card vs CPU")
    numbers = {}
    for mask in oracle_cli.MASKS:
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            mean = oracle_cli.main([*oracle_argv(test_set, mask), "--device", "cuda"])
        numbers[mask] = (time.perf_counter() - start) * 1e3 / ORACLE_UTTS
        cpu = cpu_means[mask].result()
        diff = abs(mean - cpu)
        log(f"  {mask}: mean SI-SDRi card {mean:.4f} dB, CPU {cpu:.4f} (|diff| {diff:.2e}, "
            f"limit {ORACLE_TOL_DB:g}); {numbers[mask]:.1f} ms an utterance on the card (host "
            f"clock, WAV reads included) [{card}]")
        check(np.isfinite(mean) and diff <= ORACLE_TOL_DB,
              f"oracle {mask}: card {mean} vs CPU {cpu}")
    return numbers


def library_cases():
    """Griffin-Lim, fast Griffin-Lim, MISI and NMF on a 4 s spectrogram, MixIT on a
    B = 8 x 4 s batch: {name: run(device, dtype) -> a tensor, or MixIT's (loss,
    assignment)}, and MixIT's true routing."""
    T = int(LIB_SECONDS * SAMPLE_RATE)
    speakers = _speaker_bank(2, seed=31)
    rng = np.random.default_rng(32)
    sources = torch.from_numpy(np.stack([synth_pseudo_speech(s, rng, T, SAMPLE_RATE)
                                         for s in speakers]).astype(np.float32))
    n_fft, hop = LIB_STFT["n_fft"], LIB_STFT["hop_length"]
    window = build_window(n_fft, "hann")
    amplitude = stft(sources, n_fft, hop, window=window).abs()  # (2, 129, 501)
    power = amplitude[0] ** 2
    nmf_init = NMF(NMF_BASIS, "KL", NMF_ITERATIONS, seed=0)._init(power)
    estimates = torch.from_numpy(rng.standard_normal((MIXIT_BATCH, MIXIT_EST, T),
                                                     dtype=np.float32))
    route = torch.from_numpy(rng.integers(0, 2, (MIXIT_BATCH, MIXIT_EST)))
    onehot = torch.nn.functional.one_hot(route, 2).float()  # (B, n_est, 2)
    mixtures = torch.einsum("bnm,bnt->bmt", onehot, estimates) + 0.1 * torch.from_numpy(
        rng.standard_normal((MIXIT_BATCH, 2, T), dtype=np.float32))
    cases = {
        "griffin_lim": lambda d, t: griffin_lim(amplitude.to(d, t), n_fft, hop,
                                                window=window.to(d, t),
                                                iteration=LIB_ITERATIONS, length=T),
        "fast_griffin_lim": lambda d, t: fast_griffin_lim(
            amplitude.to(d, t), n_fft, hop, window=window.to(d, t), iteration=LIB_ITERATIONS,
            length=T),
        "misi": lambda d, t: misi(amplitude.to(d, t), sources.sum(0).to(d, t), n_fft, hop,
                                  window=window.to(d, t), iteration=LIB_ITERATIONS),
        "nmf_kl": lambda d, t: torch.cat([f.flatten() for f in NMF(
            NMF_BASIS, "KL", NMF_ITERATIONS)(power.to(d, t),
                                             init=[x.to(d, t) for x in nmf_init])]),
        "mixit": lambda d, t: MixIT(NegThresholdedSNR(), MIXIT_EST)(
            estimates.to(d, t), mixtures.to(d, t), batch_mean=False),
    }
    return cases, route


def library_cpu():
    """Each library case on the CPU in f64 and in f32."""
    cases, route = library_cases()
    return {name: (run("cpu", torch.float64), run("cpu", torch.float32))
            for name, run in cases.items()}, route


def library_card_vs_cpu(cpu_side, card):
    """The library cases on the card against the CPU (`cpu_side` its future), each timed."""
    log(f"== phase 18e: the library on the card vs the CPU: phase retrieval ({LIB_ITERATIONS} "
        f"iterations) and NMF ({NMF_BASIS} bases, {NMF_ITERATIONS} updates) on a "
        f"{LIB_SECONDS:g} s spectrogram (n_fft 256, hop 64), MixIT on B = {MIXIT_BATCH} x "
        f"{LIB_SECONDS:g} s")
    cases, _ = library_cases()
    refs, route = cpu_side.result()
    numbers = {}
    for name, run in cases.items():
        got, (ref, cpu) = run("cuda", torch.float32), refs[name]
        torch.cuda.synchronize()
        if name == "mixit":
            check(all(torch.equal(a[1].cpu(), route) for a in (got, ref, cpu)),
                  f"MixIT's assignment: card {got[1].tolist()}, CPU f64 {ref[1].tolist()}, "
                  f"f32 {cpu[1].tolist()}, routed {route.tolist()}")
            got, ref, cpu = got[0], ref[0], cpu[0]
        scale = float(ref.abs().max())
        err = float((got.cpu().double() - ref).abs().max()) / scale
        cpu_err = float((cpu.double() - ref).abs().max()) / scale
        limit = max(LIB_TOL, 10 * cpu_err)  # iterated phase retrieval magnifies rounding
        numbers[name] = median_ms(lambda: run("cuda", torch.float32), warmup=1, iters=5)
        log(f"  {name}: max|card - f64| / max|f64| {err:.2e}, CPU f32 {cpu_err:.2e} (limit "
            f"{limit:.2e}); {numbers[name]:.3f} ms on the card (median of 5, CUDA events) "
            f"[{card}]")
        check(err <= limit, f"{name}: the card differs from the CPU's f64 run by {err:.2e}")
    return numbers


def phase_slice_g(card=None, tmp=None):
    """Phase 18 -> {"launches": the main path's counts (the ORPIT CLI's validation forwards,
    the evaluations, the other PITs' validation forwards; every decode held to the plain
    one), "decode": fused_mask_decode timed at the ORPIT validation shape, "numbers"}.

    The CPU's halves of the checks run in a thread beside the card's work, one task at a
    time, on all but SLICE_E_HOST_CORES of the host's cores (as phase 17's)."""
    card = card or card_line()
    numbers = {}
    with contextlib.ExitStack() as stack:
        tmp = tmp or stack.enter_context(tempfile.TemporaryDirectory())
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads - SLICE_E_HOST_CORES))
        stack.callback(torch.set_num_threads, threads)
        pool = stack.enter_context(ThreadPoolExecutor(1))
        corpus = (write_orpit_corpus(tmp, "tr", ORPIT_UTTS), write_orpit_corpus(tmp, "cv", 1),
                  tmp)
        pit_data = write_pit_corpus(tmp)
        with contextlib.redirect_stdout(io.StringIO()):
            oracle_set = write_quality_corpus(os.path.join(tmp, "oracle"), "tt", ORACLE_UTTS)
        test_set = write_test_list(tmp)
        batch = orpit_parity_batch(*corpus[0])
        parity_cpu = pool.submit(orpit_parity_cpu, batch)
        pit_cpu = {pit: pool.submit(pit_run, pit_data, pit, tmp, "cpu") for pit in PITS}
        oracle_cpu = {mask: pool.submit(oracle_cli.main, [*oracle_argv(oracle_set, mask),
                                                          "--device", "cpu"])
                      for mask in oracle_cli.MASKS}
        library = pool.submit(library_cpu)
        held = stack.enter_context(decodes_held_to_plain())
        orpit_train_parity(batch, parity_cpu)
        total, ckpt, numbers["orpit"] = orpit_train_cli(corpus, card)
        # cli/test_wsj0mix.main itself: its CSV lines go to the log (`evaluate` would take
        # the process's stdout from the card's thread while it runs)
        eval_cpu = [pool.submit(test_cli.main, ["--test_wav_root", test_set[0],
                                                "--test_list_path", list_path, "--model_path",
                                                ckpt, "--device", "cpu",
                                                *orpit_eval_flags(ckpt)])
                    for list_path in test_set[1]]
        launches, numbers["pit"] = other_pits(pit_data, pit_cpu, tmp, card)
        total = add_counts(total, launches)
        numbers["oracle"] = oracle_masks(oracle_set, oracle_cpu, card)
        numbers["library"] = library_card_vs_cpu(library, card)
        total = add_counts(total, orpit_evaluate(test_set, ckpt, eval_cpu, card))
        check(held["n"] == total["fused_mask_decode"] > 0,
              f"{held['n']} decodes held to plain, {total['fused_mask_decode']} launched")
        log(f"  every one of phase 18's {held['n']} fused_mask_decode launches held to the "
            f"plain decode: worst {held['worst']:.2e} x max|plain| (limit {TOL[torch.float32]:g})")
    log("== phase 18: fused_mask_decode at the ORPIT validation shape (B = 4 x 4 s)")
    decode = decode_case(ORPIT_VALID_SHAPE, True, torch.float32, "ORPIT validation shape")
    log(f"  phase 18 main-path launches: {nonzero(total)}")
    return dict(launches=total, decode=decode, numbers=numbers)

HUB_SERVE = (8, 4.0)  # phase 19a's served forward: B x seconds of 8 kHz audio
HUB_CHOICE = {"conv-tasnet": "best", "dprnn-tasnet": "dprnn-tasnet"}  # <choice>.pth at 2 sources
# egs/musdb18/cunet/train.sh (the TDC U-Net's widths: its CUNet recipe's): FiLM, n_fft 1024,
# hop 768, B = 4 x 6 s of 44.1 kHz stereo maps.
TDC_UNET = dict(channels=(2, 16, 32, 64, 128, 256), control_channels=(4, 16, 64),
                conditioning="film", masking=True)
TDC_STFT = dict(n_fft=1024, hop_length=768)
TDC_BATCH = (4, 6.0)
TDC_PARITY_SECONDS = 1.0  # the train step against f64: B = 1
SLICE_E_REST_TOL = 1e-3  # card vs CPU, relative to max|CPU|


def write_reference_checkpoint(path, model):
    """`model` in the reference's .pth layout: its config keys and state_dict (on the CPU),
    no model_class."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({**model.get_config(),
                "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               path)


def recurrences_held_to_plain():
    """held_to_plain over every lstm_scan_bidir / lstm_scan the port's LSTM layers launch,
    each output within LSTM_TOL x max(1, max|plain|)."""
    return held_to_plain(
        rnn_ops, {"lstm_scan_bidir": ls.lstm_scan_bidir_reference,
                  "lstm_scan": ls.lstm_scan_reference},
        lambda xw, out, ref: (max(1.0, float(ref.float().abs().max())), LSTM_TOL[out.dtype]))


def hub_models(device="cpu"):
    """Paper-config Conv-TasNet and recipe-config DPRNN-TasNet (non-causal, as the recipe
    trains it), seed-0 weights (norm affines off their start), as the reference's
    checkpoints would hold them."""
    conv = scramble_norms(ConvTasNet(**PAPER, generator=torch.Generator().manual_seed(0),
                                     device=device))
    dprnn = scramble_norms(DPRNNTasNet(**DPRNN, causal=False, device=device,
                                       generator=torch.Generator().manual_seed(0)))
    return {"conv-tasnet": conv, "dprnn-tasnet": dprnn}


def hub_cpu_side(paths):
    """The CPU's half of 19a: each blob opened on the CPU, the 4 s utterance separated."""
    with torch.inference_mode():
        return {kind: build_from_torch_checkpoint(path, device="cpu")(hub_utterance())
                for kind, path in paths.items()}


def write_hub_blobs(tmp):
    """19a's reference-format blobs under `<tmp>/pretrained`: paper-config Conv-TasNet as
    `wsj0-mix/sr8000/2speakers/best.pth`, recipe-config DPRNN-TasNet beside it. -> (the
    root, {kind: path}, {kind: the written state_dict})."""
    root = os.path.join(tmp, "pretrained")
    paths, written = {}, {}
    for kind, model in hub_models().items():
        paths[kind] = os.path.join(root, "wsj0-mix", f"sr{SAMPLE_RATE}", "2speakers",
                                   f"{HUB_CHOICE[kind]}.pth")
        write_reference_checkpoint(paths[kind], model)
        written[kind] = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return root, paths, written


def hub_utterance():
    return torch.from_numpy(np.random.default_rng(20).standard_normal(
        (1, 1, 4 * SAMPLE_RATE), dtype=np.float32))


def hub_serve(kind, model, written, cpu_out, card):
    """19a: a model opened from its reference blob: its class and state against the written
    ones; a B = 8 x 4 s forward and a 4 s utterance (every count set to 0 just before, read
    just after), each launch on its planned route and held to the plain version; the
    utterance against the blob opened on the CPU (`cpu_out`), <= 1e-3 x max|CPU|; the
    forward's ms and peak. -> the two forwards' launches."""
    cls = {"conv-tasnet": "ConvTasNet", "dprnn-tasnet": "DPRNNTasNet"}[kind]
    check(type(model).__name__ == cls and not model.training,
          f"{kind}: the reference blob opened as {type(model).__name__}, expected {cls}")
    state = model.state_dict()
    check(state.keys() == written.keys() and all(
        torch.equal(state[k].cpu(), v) for k, v in written.items()),
        f"{kind}: the loaded state_dict differs from the written one")
    B, seconds = HUB_SERVE
    x = torch.from_numpy(np.random.default_rng(19).standard_normal(
        (B, 1, int(seconds * SAMPLE_RATE)), dtype=np.float32)).cuda()
    with contextlib.ExitStack() as stack:
        decodes = stack.enter_context(decodes_held_to_plain())
        recurrences = stack.enter_context(recurrences_held_to_plain())
        stack.enter_context(torch.inference_mode())
        reset_counts()
        y = model(x)
        got = model(hub_utterance().cuda())
        torch.cuda.synchronize()
        grew = all_counts()
    layers = 2 * DPRNN["sep_num_blocks"] if kind == "dprnn-tasnet" else 0
    check({k: grew[k] for k in counts()} == expected(fused_mask_decode=2,
                                                      lstm_scan_bidir=2 * layers),
          f"{kind}: two forwards launched {nonzero(grew)}")
    check_paths(grew, {}, f"{kind} from its reference blob",
                decode=decode_path(kind.split("-")[0], torch.float32))
    check(decodes["n"] == 2 and recurrences["n"] == 2 * layers,
          f"{kind}: {decodes['n']} decodes and {recurrences['n']} recurrences held to plain")
    check(torch.isfinite(y).all() and y.shape == (B, 2, x.shape[-1]),
          f"{kind}: output {tuple(y.shape)}")
    ref = cpu_out.result()[kind]
    err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
    check(torch.isfinite(got).all() and got.shape == ref.shape and err <= 1e-3 * scale,
          f"{kind}: the card's forward disagrees with the CPU's: {err}")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        ms = budget_ms(lambda: model(x), iters=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"  {kind} ({cls}) from its reference blob: state bit for bit; B={B} x {seconds:g} s "
        f"f32 forward {ms:.3f} ms, peak {peak:.1f} MiB; launches {nonzero(grew)} (with the "
        f"4 s utterance), each held to plain: decodes worst {decodes['worst']:.2e} x "
        f"max|plain|, {recurrences['n']} recurrences worst {recurrences['worst']:.2e} x "
        f"max(1, max|plain|); the 4 s utterance card vs CPU max abs err {err:.3e}, max|CPU| "
        f"{scale:.3e}, limit {1e-3 * scale:.3e} [{card}]")
    return grew


def phase_hub(card, root, paths, written, cpu_out):
    """19a: the blobs opened on the card by build_from_pretrained (with and without a
    fetcher) and build_from_torch_checkpoint, served (hub_serve); a missing file refused.
    -> the served forwards' launches."""
    log("== phase 19a: reference-format checkpoints opened through the hub and served")
    fetched = []

    def fetcher(**request):
        fetched.append(request)
        return paths["conv-tasnet"]

    opened = {"conv-tasnet": build_from_pretrained(root=root),
              "dprnn-tasnet": build_from_torch_checkpoint(paths["dprnn-tasnet"])}
    by_fetcher = build_from_pretrained(fetcher=fetcher)
    check(fetched == [dict(task="wsj0-mix", sample_rate=SAMPLE_RATE, n_sources=2,
                           model_choice="best")], f"the fetcher was asked {fetched}")
    check(all(torch.equal(a, b) for a, b in zip(by_fetcher.state_dict().values(),
                                                 opened["conv-tasnet"].state_dict().values())),
          "the fetched blob opened with other weights")
    for model in (*opened.values(), by_fetcher):
        check(next(model.parameters()).is_cuda, "a hub model is not on the card")
    try:
        build_from_pretrained(root=root, model_choice="missing")
    except FileNotFoundError as err:
        log(f"  a missing checkpoint: FileNotFoundError ({str(err)[:70]}...)")
    else:
        raise AssertionError("build_from_pretrained opened a missing checkpoint")
    total = {}
    for kind, model in opened.items():
        total = add_counts(total, hub_serve(kind, model, written[kind], cpu_out, card))
    return total


def tdc_unet_batch(B, seconds, device, seed=19):
    """(magnitudes (B, 2, 513, frames) of a stereo 44.1 kHz excerpt's STFT shape, one-hot
    conditions cycling over the four stems, a target of the same shape)."""
    frames = int(seconds * MUSDB_SAMPLE_RATE) // TDC_STFT["hop_length"] + 1
    rng = np.random.default_rng(seed)
    shape = (B, 2, TDC_STFT["n_fft"] // 2 + 1, frames)
    x, target = (torch.from_numpy(np.abs(rng.standard_normal(shape, dtype=np.float32)))
                 .to(device) for _ in range(2))
    latent = torch.eye(4, device=device)[torch.arange(B) % 4]
    return x, latent, target


def tdc_unet_model(device="cpu"):
    """TDCUNet2d at the CUNet recipe's widths, seed-0 weights, BatchNorm statistics off
    their start."""
    model = TDCUNet2d(**TDC_UNET, generator=torch.Generator().manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in model.named_buffers():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(0.5 + rng.random(t.shape, np.float32)))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(0.1 * rng.standard_normal(t.shape).astype(np.float32)))
    return model


def tdc_unet_loss(model, batch):
    x, latent, target = batch
    return (model(x, latent) - target).square().mean()


def tdc_unet_grads(model, batch):
    """One train-mode step's (loss, {name: gradient}) of tdc_unet_loss."""
    model.train().zero_grad()
    loss = tdc_unet_loss(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.named_parameters()}


def slice_e_rest_cases():
    """19b's other modules at their tests' shapes widened to 64-256 channels: name ->
    (a function making the module on a device, its inputs as numpy arrays)."""
    rng = np.random.default_rng(21)
    img = rng.standard_normal((2, 3, 64, 64), dtype=np.float32)
    spec_map = np.abs(rng.standard_normal((2, 64, 128, 64), dtype=np.float32))
    seq = rng.standard_normal((2, 256, 64), dtype=np.float32)
    z = (rng.standard_normal((2, 256, 64)) + 1j * rng.standard_normal((2, 256, 64))
         ).astype(np.complex64)
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    return {
        "DenseNet": (lambda d: DenseNet(2, 64, 32, (3, 3), num_layers=(2, 3, 4),
                                        generator=g(), device=d),
                     (np.abs(rng.standard_normal((2, 2, 64, 64), dtype=np.float32)),)),
        "TFCLaSAFT": (lambda d: lasaft.TFCLaSAFT(64, 64, 64, 128, 32, 4, num_heads=4,
                                                 generator=g(), device=d),
                      (spec_map, np.eye(4, dtype=np.float32)[:2])),
        "MLPMixer": (lambda d: vision.MLPMixer(3, (64, 64), (8, 8), dim=128, depth=4,
                                               tokens_hidden=64, channels_hidden=256,
                                               generator=g(), device=d), (img,)),
        "PoolFormer": (lambda d: vision.PoolFormer(3, (4, 4), mlp_hidden=256,
                                                   stage_dims=(64, 128, 256),
                                                   stage_depths=(2, 2, 2), generator=g(),
                                                   device=d), (img,)),
        "ViT": (lambda d: vision.ViT(3, (8, 8), dim=128, depth=4, num_heads=4, mlp_hidden=256,
                                     generator=g(), device=d), (img,)),
        "MultiDilatedConv2d": (lambda d: multidilated.MultiDilatedConv2d(
            64, 64, (3, 3), groups=4, generator=g(), device=d), (spec_map,)),
        "ComplexConv1d": (lambda d: complex_conv.ComplexConv1d(64, 128, 3, generator=g(),
                                                               device=d), (z,)),
        "ComplexDense + ModReLU": (lambda d: torch.nn.Sequential(
            complex_conv.ComplexDense(64, 128, generator=g(), device=d),
            activation.ModReLU(128, device=d)), (z,)),
        "complex_relu, zrelu, concat_relu": (lambda d: lambda z: torch.cat([
            torch.view_as_real(activation.complex_relu(z)), torch.view_as_real(
                activation.zrelu(z)), activation.concat_relu(torch.view_as_real(z))], -1),
            (z,)),
        "pools (median, GeM, global)": (lambda d: lambda x: torch.cat([
            pool_ops.median_pool1d(x, 4), pool_ops.GeneralizedMeanPool(device=d)(x)[:, None],
            pool_ops.global_avg_pool(x)[:, None], pool_ops.global_max_pool(x)[:, None]], 1),
            (seq,)),
    }


def slice_e_rest_cpu():
    """The CPU's half of 19b: TDCUNet2d's B = 4 x 6 s forward and its train step in f64 and
    f32 (B = 1), and the other modules' forwards."""
    model = tdc_unet_model()
    x, latent, _ = tdc_unet_batch(*TDC_BATCH, "cpu")
    with torch.inference_mode():
        forward = model.eval()(x, latent)
    batch = tdc_unet_batch(1, TDC_PARITY_SECONDS, "cpu")
    ref = tdc_unet_grads(copy.deepcopy(model).double(), tuple(t.double() for t in batch))
    cpu = tdc_unet_grads(model, batch)
    others = {}
    with torch.inference_mode():
        for name, (build, inputs) in slice_e_rest_cases().items():
            module = build("cpu")
            others[name] = (module.eval() if isinstance(module, torch.nn.Module) else module)(
                *map(torch.from_numpy, inputs))
    return dict(forward=forward, ref=ref, cpu=cpu, others=others)


def phase_slice_e_rest(card, cpu_side):
    """19b: TDCUNet2d at the CUNet recipe's widths (B = 4 x 6 s maps) card vs CPU, its
    forward ms and peak, one f32 train step (B = 1) against the f64 CPU step (a gradient 0
    in f64 held as phase 17 holds it), the recipe step's p50 and peak; then DenseNet,
    TFCLaSAFT, the vision models, MultiDilatedConv2d, the complex layers, the activations
    and the pools card vs CPU, f32. None launches a kernel of the port (their convs are
    cuDNN's, as JAX's are XLA's): every count 0. -> the card runs' launches."""
    log("== phase 19b: slice E's other half: TDCUNet2d at the CUNet recipe's widths, the "
        "other models and ops, card vs CPU (f32, TF32 off)")
    model = tdc_unet_model("cuda")
    x, latent, target = tdc_unet_batch(*TDC_BATCH, "cuda")
    reset_counts()
    with torch.inference_mode():
        got = model.eval()(x, latent)
        torch.cuda.reset_peak_memory_stats()
        ms = budget_ms(lambda: model(x, latent), iters=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    side = cpu_side.result()
    ref = side["forward"]
    err, scale = float((got.cpu() - ref).abs().max()), float(ref.abs().max())
    log(f"  TDCUNet2d B={TDC_BATCH[0]} x {TDC_BATCH[1]:g} s {tuple(x.shape)}: card vs CPU max "
        f"abs err {err:.3e}, max|CPU| {scale:.3e}, limit {1e-3 * scale:.3e}; forward "
        f"{ms:.3f} ms, peak {peak:.1f} MiB [{card}]")
    check(torch.isfinite(got).all() and got.shape == ref.shape and err <= 1e-3 * scale,
          f"TDCUNet2d: the card's forward disagrees with the CPU's: {err}")
    batch = tdc_unet_batch(1, TDC_PARITY_SECONDS, "cuda")
    step = tdc_unet_grads(model, batch)
    hold_step_against_f64(f"TDCUNet2d (B=1 x {TDC_PARITY_SECONDS:g} s)", side["ref"],
                          side["cpu"], step, all_counts())
    optimizer = make_optimizer("adam", 1e-3, params=model.parameters())
    B, p50, split, step_peak = fitting_step(
        "TDCUNet2d", optimizer, lambda b: tdc_unet_batch(b, TDC_BATCH[1], "cuda"),
        lambda b: tdc_unet_loss(model, b), TDC_BATCH[0], TDC_BATCH[1], iters=3)
    log(f"  TDCUNet2d recipe step B={B} x {TDC_BATCH[1]:g} s: p50 {p50:.3f} ms (forward "
        f"{split[0]:.3f}, backward {split[1]:.3f}, optimizer {split[2]:.3f} ms), peak "
        f"{step_peak:.1f} MiB")
    with torch.inference_mode():
        for name, (build, inputs) in slice_e_rest_cases().items():
            module = build("cuda")
            got = (module.eval() if isinstance(module, torch.nn.Module) else module)(
                *(torch.from_numpy(a).cuda() for a in inputs)).cpu()
            ref = side["others"][name]
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            log(f"  {name} {tuple(got.shape)}: card vs CPU max abs err {err:.3e} (limit "
                f"{SLICE_E_REST_TOL * scale:.3e})")
            check(torch.isfinite(torch.view_as_real(got) if got.is_complex() else got).all()
                  and got.shape == ref.shape and err <= SLICE_E_REST_TOL * scale,
                  f"{name}: the card's forward disagrees with the CPU's: {err}")
    torch.cuda.synchronize()
    grew = all_counts()
    check(not any(grew.values()), f"slice E's other half launched {nonzero(grew)}")
    return grew


def phase_hub_and_slice_e_rest(card=None, tmp=None):
    """Phase 19 (19a then 19b) -> {"launches": 19a's served forwards' counts}. The CPU's
    halves run in a thread beside the card's work, one task at a time, on all but
    SLICE_E_HOST_CORES of the host's cores (as phase 17's)."""
    card = card or card_line()
    with contextlib.ExitStack() as stack:
        tmp = tmp or stack.enter_context(tempfile.TemporaryDirectory())
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads - SLICE_E_HOST_CORES))
        stack.callback(torch.set_num_threads, threads)
        pool = stack.enter_context(ThreadPoolExecutor(1))
        root, paths, written = write_hub_blobs(tmp)
        hub_cpu = pool.submit(hub_cpu_side, paths)
        rest_cpu = pool.submit(slice_e_rest_cpu)
        launches = phase_hub(card, root, paths, written, hub_cpu)
        phase_slice_e_rest(card, rest_cpu)
    log(f"  phase 19 main-path launches: {nonzero(launches)}")
    return dict(launches=launches)


def kernel_entry(name, source, replaces, launches, timing, bound_of, library_ms=None,
                 dtype=torch.float32, fma_bound=None):
    """One kernel of the `kernels` line; `dtype` is that of the inputs timed. A timing
    with the FMA kernel's time of the same run (a tensor-core row) adds it as fma_ms, and
    `fma_bound` (a bound() of the FMA kernel's work) as fma_bound_ms."""
    extra = {"fma_ms": timing["fma_ms"]} if "fma_ms" in timing else {}
    if fma_bound is not None:
        extra["fma_bound_ms"] = fma_bound["bound_ms"]
    return {"name": name, "route": "cuda", "source": f"dnn_based_source_separation_torch/{source}",
            "replaces": f"dnn_based_source_separation_tpu/{replaces}", "launches": launches,
            "dtype": str(dtype)[6:], "max_abs_err": timing["max_abs_err"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], **bound_of, "library_ms": library_ms, **extra}


def recurrence_bound(B, T, H, gates, chains, backward=False, cell_state=False, bias=False,
                     dtype=torch.float32, tf32=0):
    """The least time of a recurrence's work at (B, T, H) in `dtype`.

    Forward: 2 x B x T x gates x H^2 FLOPs per chain (the recurrent product;
    the gate nonlinearities are a few operations per unit and are left out),
    over the dtype's peak (bf16: the tensor cores; f32: FMA outside them, or,
    with `tf32` = 3, three TF32 products at the tensor cores' TF32 peak), and
    xw read, hs written, at the dtype's size. Backward, as timed (the gate
    recompute, the kernel and the weight gradient): three products of that
    size, xw, hs, the cotangent (and the LSTM's cs) read, d_xw and the
    parameter gradients written. The backward computes in f32 in both dtypes:
    the FMA route runs all three products at the f32 FMA peak, the
    tensor-core route (`tf32` = 3 in f32 or 2 in bf16) the recurrent product
    as `tf32` TF32 products and the two cuBLAS products around it at the f32
    FMA peak.
    """
    G = gates * H
    product = chains * 2.0 * B * T * G * H
    seq = B * T * (G + H)  # xw and hs
    if backward:
        seq += B * T * (H + G + (H if cell_state else 0))  # g_hs, d_xw, cs
    elif cell_state:
        seq += B * T * H  # the training forward also writes cs
    params = G * H * (2 if backward else 1) + (G * (2 if backward else 1) if bias else 0)
    nbytes = torch.tensor([], dtype=dtype).element_size() * chains * (seq + params)
    if not backward:
        return bound(tf32 * product, nbytes, "tf32") if tf32 else bound(product, nbytes, dtype)
    if tf32:
        return bound_of_ops({"tf32": tf32 * product, torch.float32: 2 * product}, nbytes)
    return bound(3 * product, nbytes, torch.float32)


def backward_kernel_bound(B, T, H, gates, chains, dtype, tf32, peak="tf32"):
    """The least time of the backward kernel alone: its recurrent product as `tf32`
    products at `peak` (the tensor cores' TF32; the FMA kernel: one at the f32 peak),
    and its arrays read and written once. LSTM: gates and das in
    f32 (4H), cs and g_hs in the dtype, d_xw in bf16 only (in f32 das is d_xw). GRU: xw,
    hs, g_hs and d_xw in the dtype, hw and d_hw in f32 (3H each). W_hh in the dtype."""
    G = gates * H
    size = torch.tensor([], dtype=dtype).element_size()
    if gates == 4:
        row = 4 * 2 * G + size * (2 * H + (G if dtype == torch.bfloat16 else 0))
    else:
        row = 4 * 2 * G + size * (2 * G + 2 * H)
    nbytes = chains * (B * T * row + size * G * H)
    return bound(tf32 * chains * 2.0 * B * T * G * H, nbytes, peak)


BUILDS = {"mask_decode": md.build, "lstm_scan": ls.build, "lstm_scan_bwd": ls.build_backward,
          "gru_scan": gs.build, "gru_scan_bwd": gs.build_backward, "quantize": q8.build}


def phase_build():
    log("== phase 2: build")
    start = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as pool:  # one nvcc per source, all at once
        for build in [pool.submit(b) for b in BUILDS.values()]:
            build.result()
    log(f"  {', '.join(BUILDS)} built/loaded in {time.perf_counter() - start:.2f} s")
    for name in BUILDS:
        info = _build.BUILD_INFO[name]
        log(f"  {name} ({info['seconds']:.2f} s):")
        log("  " + info["log"].strip().replace("\n", "\n  "))
        if info["log"] == "cached":
            continue
        stacks = [int(n) for n in re.findall(r"(\d+) bytes stack frame", info["log"])]
        check(stacks and not any(stacks), f"{name}: a kernel uses stack: {stacks}")
    log("  every kernel built with 0 bytes of stack")


ONLY_PHASES = {"3": phase_kernel, "3b": phase_lstm, "3c": phase_gru, "3d": phase_lstm_bwd,
               "3e": phase_gru_bwd, "3f": phase_quantize, "3g": phase_library,
               "3h": phase_cluster, "3i": phase_wide, "3j": phase_wide_bwd,
               "6s": phase_stream_hops, "11": phase_musdb, "12": phase_musdb_train,
               "13": phase_dptnet, "13k": phase_dptnet_kernels, "14": phase_slice_d,
               "14k": phase_slice_d_kernels, "15": phase_rest, "15k": phase_rest_kernels,
               "16": phase_spec, "16k": phase_spec_kernels, "17": phase_slice_e,
               "17k": phase_slice_e_kernels, "18": phase_slice_g,
               "19": phase_hub_and_slice_e_rest}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("chip_smoke")
    parser.add_argument("--only", type=str, default=None,
                        help="comma-separated kernel phases (3, 3b-3j), 6s (streaming ms "
                             "per hop), 11 (musdb18 serving), 12 (musdb18 training), 13 "
                             "(DPTNet), 13k (DPTNet's kernels alone), 14 (LSTM-TasNet, "
                             "SepFormer, GALRNet), 14k (their kernels alone), 15 (the RNN and "
                             "SRU DPRNN-TasNets, FurcaNet, musdb18's waveform models, WaveNet), "
                             "15k (their kernels alone), 16 (Wavesplit, DANet, ADANet, deep "
                             "clustering; 16k first), 16k (H = 300 alone), 17 (D3Net, "
                             "MMDenseNet, MMDenseLSTM, HRNet, CUNet; 17k first), 17k "
                             "(MMDenseLSTM's H = 64, 16, 4 alone), 18 (ORPIT Conv-TasNet, "
                             "the other PITs, the oracle masks, the library) or 19 (reference "
                             "checkpoints through the hub, slice E's other half) to run after "
                             "phases 1 and 2, and nothing else; no result line is printed")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    log("== phase 1: device")
    card = card_line()
    log(f"  {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    resolve_device("cuda", stream=None)  # TF32 off, as every CLI sets it
    phase_build()
    if args.only:
        for phase in args.only.split(","):
            ONLY_PHASES[phase.strip()]()
        log(card)
        return 0

    timings = phase_kernel()
    lstm_timings = phase_lstm()
    gru_timings = phase_gru()
    bwd_timings = phase_lstm_bwd()
    gru_bwd_timings = phase_gru_bwd()
    quant_timing = phase_quantize()
    library = phase_library()
    cluster_timings = phase_cluster(card)
    wide_timings = phase_wide(card)
    wide_bwd_timings = phase_wide_bwd(card)
    blocks = DPRNN["sep_num_blocks"]
    stream_flags = ["--streaming_hop", str(STREAMING_HOP)]
    with tempfile.TemporaryDirectory() as tmp:
        wavs = write_mixtures(tmp)
        log("== phase 4: serve paper-config Conv-TasNet through cli/separate.py")
        conv_ckpt = os.path.join(tmp, "conv_tasnet.pth")
        make_checkpoint(conv_ckpt, ConvTasNet(**PAPER, generator=torch.Generator().manual_seed(0),
                                              device="cuda"))
        conv_out, total = serve("conv_tasnet", conv_ckpt, wavs, expected(fused_mask_decode=1))
        dprnn, streamed = {}, {}
        for rnn, phase in (("lstm", "4b"), ("gru", "4c")):
            for causal in (False, True):
                tag = f"dprnn_tasnet_{rnn}" + ("_causal" if causal else "")
                log(f"== phase {phase}: serve recipe-config DPRNN-TasNet, rnn_type={rnn}, "
                    f"causal={causal}, through cli/separate.py")
                ckpt = os.path.join(tmp, f"{tag}.pth")
                make_checkpoint(ckpt, DPRNNTasNet(**dict(DPRNN, rnn_type=rnn), causal=causal,
                                                  device="cuda",
                                                  generator=torch.Generator().manual_seed(0)))
                # Intra-chunk: one bidirectional layer per block; inter-chunk: one
                # more (non-causal) or one unidirectional layer (causal).
                outputs, path = serve(tag, ckpt, wavs, expected(**{
                    "fused_mask_decode": 1, f"{rnn}_scan_bidir": blocks * (2 - causal),
                    f"{rnn}_scan": blocks * causal}))
                dprnn[tag] = (ckpt, outputs)
                total = {k: v + path[k] for k, v in total.items()}
        for rnn in ("lstm", "gru"):
            tag = f"dprnn_tasnet_{rnn}_stream"
            log(f"== phase 4d: stream the stream-safe causal DPRNN-TasNet, rnn_type={rnn}, "
                f"through cli/separate.py --streaming_hop {STREAMING_HOP}")
            ckpt = os.path.join(tmp, f"{tag}.pth")
            make_checkpoint(ckpt, DPRNNTasNet(**dict(DPRNN, rnn_type=rnn), causal=True,
                                              stream_safe=True, device="cuda",
                                              generator=torch.Generator().manual_seed(0)))
            outputs, path = serve(tag, ckpt, wavs,
                                  lambda n, rnn=rnn: stream_launches(n, f"{rnn}_scan_bidir"),
                                  flags=stream_flags)
            streamed[tag] = (ckpt, outputs)
            total = {k: v + path[k] for k, v in total.items()}
            phase_stream_offline(tag, ckpt, wavs, outputs)
        tag = "conv_tasnet_causal_stream"
        log(f"== phase 4f: stream causal paper-config Conv-TasNet through cli/separate.py "
            f"--streaming_hop {STREAMING_HOP}")
        ckpt = os.path.join(tmp, f"{tag}.pth")
        make_checkpoint(ckpt, ConvTasNet(**dict(PAPER, causal=True), device="cuda",
                                         generator=torch.Generator().manual_seed(0)))
        outputs, path = serve(tag, ckpt, wavs, conv_stream_launches, flags=stream_flags)
        # The hops' decodes by dtype, as this run counted them: the kernels line's
        # streamed-hop rows.
        hop_launches = {dtype: path[width_key(decode_path(tag, dtype), str(dtype)[6:],
                                              PAPER["n_basis"], PAPER["kernel_size"])]
                        for dtype in (torch.float32, torch.bfloat16)}
        streamed[tag] = (ckpt, outputs)
        total = {k: v + path[k] for k, v in total.items()}
        phase_stream_offline(tag, ckpt, wavs, outputs, phase="4f")
        long_wav = write_long_mixture(tmp)
        long_out, path = phase_longform(conv_ckpt, long_wav)
        total = {k: v + path[k] for k, v in total.items()}
        path = phase_quantized_serve(conv_ckpt, wavs, conv_out)
        total = {k: v + path[k] for k, v in total.items()}
        phase_parity("Conv-TasNet", conv_ckpt, wavs, conv_out)
        for tag, (ckpt, outputs) in dprnn.items():
            phase_parity(tag, ckpt, wavs, outputs)
        for tag, (ckpt, outputs) in streamed.items():
            phase_parity(tag, ckpt, wavs, outputs, flags=stream_flags)
        phase_parity("Conv-TasNet long-form", conv_ckpt, [long_wav], long_out,
                     flags=["--chunk_duration", str(CHUNK_DURATION)])
        phase_throughput(conv_ckpt, wavs, card)
        for tag, (ckpt, _) in dprnn.items():
            phase_throughput_dprnn(tag, ckpt, wavs, card)
        for tag, (ckpt, _) in streamed.items():
            phase_throughput_stream(tag, ckpt, wavs, card)
        phase_throughput_longform(conv_ckpt, long_wav, card)
        phase_bench()
        phase_train_parity()
        trained, checkpoints = phase_train_cli(tmp, card)
        evaluated = phase_evaluate(tmp, checkpoints, card)
    phase_train_throughput(card)
    musdb = phase_musdb(card)
    musdb_train = phase_musdb_train(card)
    dptnet = phase_dptnet(card)
    slice_d = phase_slice_d(card)
    rest = phase_rest(card)
    spec = phase_spec(card)
    slice_e = phase_slice_e(card)
    slice_g = phase_slice_g(card)
    hub = phase_hub_and_slice_e_rest(card)
    for name in ("lstm_scan_bidir_bwd", "lstm_scan_bwd", "gru_scan_bidir_bwd", "gru_scan_bwd"):
        check(trained[name] >= 1, f"the training path never launched {name}")
    total = {k: v + trained[k] + evaluated[k] for k, v in total.items()}
    # musdb18's B = 1 10 s forwards: phase 11's served tracks and causal chunk, phase 12's
    # validation and trained checkpoints; phase 12's train steps apart (B = 16, with cs).
    umx_served = dict.fromkeys(total, 0)
    for run in [*(served["launches"] for served in musdb["served"].values()),
                musdb["causal_launches"], musdb_train["serve"]]:
        umx_served = {k: v + run[k] for k, v in umx_served.items()}
    total = {k: v + umx_served[k] + musdb_train["train"][k] for k, v in total.items()}
    # DPTNet (phase 13, H = 256 at B = 1-5112) runs the wide and cluster forwards and
    # backwards where _plan and _plan_bwd put each of its shapes; phase 13 held every launch
    # to its route. Its decodes join the served widths' rows.
    dpt_launches = dptnet["launches"]
    total = {k: v + dpt_launches.get(k, 0) for k, v in total.items()}
    # Phase 14 (LSTM-TasNet, SepFormer, GALRNet) held every launch to its route too.
    slice_launches = slice_d["launches"]
    total = {k: v + slice_launches.get(k, 0) for k, v in total.items()}
    # Phase 15 (FurcaNet, DPRNN-TasNet with RNN / SRU, musdb18's waveform models) too.
    rest_launches = rest["launches"]
    total = {k: v + rest_launches.get(k, 0) for k, v in total.items()}
    # Phase 18 (ORPIT Conv-TasNet, the other PITs): its validation and evaluation decodes,
    # each held to the plain decode.
    slice_g_launches = slice_g["launches"]
    total = {k: v + slice_g_launches.get(k, 0) for k, v in total.items()}
    # Phase 19 (paper-config Conv-TasNet and recipe-config DPRNN-TasNet opened from reference
    # blobs through the hub): their decodes and recurrences, each held to the plain version,
    # join the served widths' rows and the f32 recurrence rows.
    total = {k: v + hub["launches"].get(k, 0) for k, v in total.items()}
    # Phase 16 (DANet, ADANet, deep clustering: H = 300) runs the cluster kernels padded to
    # 384 for requests and the wide ones at 384 for training; phase 16 held every launch to
    # its route.
    spec_launches = spec["launches"]
    total = {k: v + spec_launches.get(k, 0) for k, v in total.items()}
    # The wsj0 models have H = 128 (tensor cores), musdb18's UMX B = 1 at H = 256 and 512
    # and B = 16 at H = 256 (the cluster kernels), DPTNet H = 256 (the wide and cluster
    # kernels), GALRNet H = 128, LSTM-TasNet H = 500 (the cluster kernels at 512), DANet,
    # ADANet and deep clustering H = 300 (the cluster and wide kernels at 384): no FMA
    # kernel. Causal LSTM-TasNet's train steps run the one-chain cluster backward.
    for name, n in total.items():
        if name.endswith("/fma"):
            check(n == 0, f"the main path launched the FMA kernel: {name} {n} times")
    # Phase 17 (MMDenseLSTM's H = 4 recurrences: the FMA kernels; H = 64 and 16 the tensor
    # cores) held every launch to its route too.
    slice_e_launches = slice_e["launches"]
    total = {k: v + slice_e_launches.get(k, 0) for k, v in total.items()}
    for name, n in total.items():
        if not name.endswith("/fma") and n < 1:
            raise AssertionError(f"the serving, training and evaluation paths never launched "
                                 f"{name}")
    check("jax" not in sys.modules and "flax" not in sys.modules, "jax was imported")
    check(not any(m.split(".")[0] == "dnn_based_source_separation_tpu" for m in sys.modules),
          "the JAX package was imported")

    f32, bf16 = torch.float32, torch.bfloat16
    H = DPRNN["sep_hidden_channels"]
    n_big = QUANT_BIG[0] * QUANT_BIG[1]
    # The recurrence forwards twice: the 3xTF32 kernel in f32 (its main-path
    # launches: the f32 forwards) and the tensor-core kernel in bf16 (the bf16
    # forwards), each beside the FMA kernel's time in the same run and cuDNN's
    # nn.LSTM / nn.GRU in the same dtype (it also does the input projection
    # the kernels take as given). einsum is fused_mask_decode's library call
    # in f32.
    forwards = [  # name, replaces, timings, timed shape, (B, T, chains), gates
        ("lstm_scan_bidir", "ops/pallas_lstm.py:323", lstm_timings, "intra", (2040, 250, 2), 4),
        ("lstm_scan", "ops/pallas_lstm.py:166", lstm_timings, "inter", (2000, 255, 1), 4),
        ("gru_scan_bidir", "ops/pallas_lstm.py:422", gru_timings, "intra", (2040, 250, 2), 3),
        # The one-chain instance of the same kernel: the JAX package runs the
        # unidirectional GRU in lax.scan, so it has no Pallas kernel of its own.
        ("gru_scan", "ops/pallas_lstm.py:422", gru_timings, "inter", (2000, 255, 1), 3),
    ]
    # fused_mask_decode once per served decoder width and dtype, on the path its
    # decodes take, with the launches of that width and dtype: `ms` one whole
    # wrapper call, `kernel_ms` the kernel alone; a "rows" or "mma" row also
    # carries the generic kernel's times from the same run (`generic_ms`,
    # `generic_kernel_ms`).
    # The streamed-hop rows carry phase 4f's counts of its hops' decodes in their dtype
    # (a subset of the serving rows' width count, which WIDTH_LAUNCHES keys by N and C·L).
    entries = []
    for which, dtype in (("serving shape", f32), ("serving shape", bf16),
                         ("DPRNN-TasNet decoder shape", f32),
                         ("DPRNN-TasNet decoder shape", bf16),
                         ("streamed hop shape", f32), ("streamed hop shape", bf16)):
        timing = timings[(which, dtype)]
        shape = DECODE_SHAPES[which]
        launches = (hop_launches[dtype] if which == "streamed hop shape" else
                    total[width_key(timing["path"], str(dtype)[6:], shape["N"], shape["CL"])])
        library_ms = timing["library_ms"]
        if dtype == bf16:  # einsum on bf16 operands: its output is bf16, the kernel's f32
            library_ms = library[f"einsum_bf16/{which}"]
        entry = kernel_entry("fused_mask_decode", "csrc/mask_decode.cu",
                             "ops/pallas_kernels.py:114", launches, timing,
                             mask_decode_bound(**shape, dtype=dtype), library_ms, dtype=dtype)
        entry.update(path=timing["path"], shape=which,
                     **{k: timing[k] for k in ("kernel_ms", "generic_ms", "generic_kernel_ms")
                        if k in timing})
        entries.append(entry)
    for dtype, path, source, suffix in ((f32, "tf32x3", "csrc/recurrence_tf32.cuh", ""),
                                        (bf16, "mma", "csrc/recurrence_mma.cuh", "_bf16")):
        for name, replaces, times, shape, (B, T, chains), gates in forwards:
            route = recurrence_bound(B, T, H, gates, chains, bias=gates == 3, dtype=dtype,
                                     tf32=3 if path == "tf32x3" else 0)
            fma_bound = (recurrence_bound(B, T, H, gates, chains, bias=gates == 3, dtype=dtype)
                         if path == "tf32x3" else None)
            entries.append(kernel_entry(
                name, source, replaces, total[f"{name}/{path}"], times[(name, shape, dtype)],
                route, library[name + suffix], dtype=dtype, fma_bound=fma_bound))
    # The same forwards at UMX's serving shapes (B = 1, a 10 s chunk, H = 256 a direction,
    # 512 causal) on the cluster kernel, timed in phase 3h beside the FMA kernel (fma_ms),
    # the other cluster size (c8_ms or c16_ms), the serial floor (floor_ms) and cuDNN's
    # nn.LSTM, with the launches of musdb18's B = 1 10 s forwards (phase 11's served tracks
    # and causal chunk, phase 12's validation and served checkpoints).
    for name, replaces in (("lstm_scan_bidir", "ops/pallas_lstm.py:323"),
                           ("lstm_scan", "ops/pallas_lstm.py:166")):
        B, T, H_umx, chains = UMX_SCAN_SHAPES[name]
        timing = cluster_timings[(name, f32, "UMX" if name == "lstm_scan_bidir" else "causal UMX")]
        entry = kernel_entry(name, "csrc/recurrence_cluster.cuh", replaces,
                             umx_served[f"{name}/cluster"], timing,
                             recurrence_bound(B, T, H_umx, 4, chains, dtype=f32),
                             timing["library_ms"], dtype=f32)
        entry.update(path="cluster", shape=f"UMX B={B} T={T} H={H_umx}",
                     **{k: timing[k] for k in timing
                        if k in ("cluster", "floor_ms", "fma_max_abs_err") or
                        (k.startswith("c") and k.endswith("_ms"))})
        entries.append(entry)
    # lstm_scan_bidir at musdb18 training's shape (B = 16 x 6 s, T = 259, H = 256 a
    # direction): the forward with cs on the route _plan gives it, the cluster kernel
    # (phase 3h's times, FMA forced beside it, the other cluster size, the serial floor;
    # cuDNN at F = 512) or the wide kernel (phase 3i's: FMA and the cluster route forced
    # beside it; cuDNN at F = 64), and its backward on the cluster
    # backward (phase 3d's times: the whole backward and the kernel alone beside the FMA
    # backward's and cuDNN's; phase 3h's: the other cluster size and the serial floor),
    # each with the launches of phase 12's CLI train steps.
    B, T, H_umx = UMX_TRAIN_SHAPE
    route = plan(ls, B, 2, H_umx, f32)[0]
    timing = (cluster_timings if route == "cluster" else wide_timings)[
        ("lstm_scan_bidir", f32, "UMX train")]
    entry = kernel_entry("lstm_scan_bidir", f"csrc/recurrence_{route}.cuh",
                         "ops/pallas_lstm.py:323",
                         musdb_train["train"][f"lstm_scan_bidir/{route}"], timing,
                         recurrence_bound(B, T, H_umx, 4, 2, cell_state=True, dtype=f32,
                                          tf32=3 if route == "wide" else 0),
                         timing["library_ms"], dtype=f32)
    entry.update(path=route, shape=f"UMX train B={B} T={T} H={H_umx}, with cs",
                 **{k: timing[k] for k in timing
                    if k in ("cluster", "tile", "floor_ms", "fma_max_abs_err") or
                    (k.startswith("c") and k.endswith("_ms"))})
    entries.append(entry)
    timing = bwd_timings[("lstm_scan_bidir_bwd", "umx-train", f32)]
    entry = kernel_entry("lstm_scan_bidir_bwd", "csrc/recurrence_cluster_bwd.cuh",
                         "ops/pallas_lstm.py:339",
                         musdb_train["train"]["lstm_scan_bidir_bwd/cluster"], timing,
                         recurrence_bound(B, T, H_umx, 4, 2, backward=True, cell_state=True,
                                          dtype=f32),
                         timing["library_ms"], dtype=f32)
    entry.update(path="cluster", shape=f"UMX train B={B} T={T} H={H_umx}",
                 **{k: timing[k] for k in ("cluster", "kernel_ms", "fma_kernel_ms",
                                           "fma_max_abs_err")},
                 **cluster_timings[("bwd", "lstm_scan_bidir_bwd", "UMX train")],
                 kernel_bound_ms=backward_kernel_bound(B, T, H_umx, 4, 2, f32, 1,
                                                       peak=f32)["bound_ms"])
    entries.append(entry)
    # The backwards of kernels 2-4 (`custom_vjp` _bidir_bwd and _lstm_bwd, both
    # _lstm_bwd_core; _gru_bidir_bwd, _gru_bwd_core) twice, f32 (three TF32
    # products) and bf16 (two), each at the training shape of its phase: `ms` is
    # the whole backward (the gate recompute, the kernel, the parameter
    # gradients), `kernel_ms` the kernel alone, each beside the FMA kernel's in
    # the same run (`fma_ms`, `fma_kernel_ms`) and its route's bounds; cuDNN's
    # backward in the same dtype (input projection included).
    backwards = [  # name, replaces, timings, timed shape, (B, T, chains), gates
        ("lstm_scan_bidir_bwd", "ops/pallas_lstm.py:339", bwd_timings, "intra", (510, 250, 2),
         4),
        ("lstm_scan_bwd", "ops/pallas_lstm.py:230", bwd_timings, "inter", (500, 255, 1), 4),
        ("gru_scan_bidir_bwd", "ops/pallas_lstm.py:473", gru_bwd_timings, "intra",
         (510, 250, 2), 3),
        ("gru_scan_bwd", "ops/pallas_lstm.py:431", gru_bwd_timings, "inter", (500, 255, 1), 3),
    ]
    for dtype, path, suffix in ((f32, "tf32x3", ""), (bf16, "tf32x2", "_bf16")):
        tf32 = 3 if dtype == f32 else 2
        for name, replaces, times, shape, (B, T, chains), gates in backwards:
            lstm = gates == 4
            timing = times[(name, shape, dtype)]
            entry = kernel_entry(
                name, "csrc/recurrence_bwd_tf32.cuh", replaces, total[f"{name}/{path}"], timing,
                recurrence_bound(B, T, H, gates, chains, backward=True, cell_state=lstm,
                                 bias=not lstm, dtype=dtype, tf32=tf32),
                library[name + suffix], dtype=dtype,
                fma_bound=recurrence_bound(B, T, H, gates, chains, backward=True,
                                           cell_state=lstm, bias=not lstm, dtype=dtype))
            entry.update(kernel_ms=timing["kernel_ms"], fma_kernel_ms=timing["fma_kernel_ms"],
                         kernel_bound_ms=backward_kernel_bound(B, T, H, gates, chains, dtype,
                                                               tf32)["bound_ms"])
            entries.append(entry)
    # DPTNet's recurrences at its shapes (phase 13): the forwards at serving's B = 8 x 4 s
    # (intra 5112 x 100, inter 800 x 639, bidirectional or causal) in both dtypes and at
    # recipe training's B = 2 x 4 s with cs (intra 1278 x 100, inter 200 x 639) in f32 with
    # their backwards, each on its planned route (the FMA kernel forced beside any other),
    # beside cuDNN's nn.LSTM at DPTNet's input width (F = 64), with phase 13's main-path
    # launches of that kernel on that route (every shape and dtype of phase 13).
    for (name, label, dtype), timing in dptnet["kernels"].items():
        route = timing["path"]
        backward = name.endswith("_bwd")
        source = {("cluster", False): "csrc/recurrence_cluster.cuh",
                  ("cluster", True): "csrc/recurrence_cluster_bwd.cuh",
                  ("wide", False): "csrc/recurrence_wide.cuh",
                  ("wide", True): "csrc/recurrence_wide_bwd.cuh",
                  ("fma", False): "csrc/lstm_scan.cu",
                  ("fma", True): "csrc/lstm_scan_bwd.cu"}[(route, backward)]
        replaces = {"lstm_scan_bidir": "ops/pallas_lstm.py:323",
                    "lstm_scan": "ops/pallas_lstm.py:166",
                    "lstm_scan_bidir_bwd": "ops/pallas_lstm.py:339",
                    "lstm_scan_bwd": "ops/pallas_lstm.py:230"}[name]
        B, T, _ = next(shape for lab, shape, *_ in DPT_SHAPES if lab == label)
        entry = kernel_entry(name, source, replaces, dpt_launches[f"{name}/{route}"], timing,
                             {k: timing[k] for k in ("bound_ms", "bound_by")},
                             timing["library_ms"], dtype=dtype)
        entry.update(path=route, shape=f"DPTNet {label} B={B} T={T} H={DPT_H}"
                     + (", with cs" if "train" in label else ""),
                     **{k: timing[k] for k in ("kernel_ms", "fma_kernel_ms", "kernel_bound_ms",
                                               "fma_bound_ms", "fma_max_abs_err", "cluster",
                                               "tile")
                        if k in timing})
        # The wide backward's rows also carry phase 3j's cluster backward forced and serial
        # floor at the same shape.
        extra = wide_bwd_timings.get((name, dtype, f"DPTNet {label}")) if backward else None
        if route == "wide" and extra is not None:
            entry.update(cluster_kernel_ms=extra["cluster_kernel_ms"], floor_ms=extra["floor_ms"])
        entries.append(entry)
    # Phase 14's shapes and widths (phase 14k's times): fused_mask_decode at LSTM-TasNet's,
    # SepFormer's and GALRNet's decoder widths, with phase 14's decodes of that width and
    # dtype (one whole call as `ms`, the kernel alone as `kernel_ms`, a "mma" row beside the
    # generic kernel; `library_ms` einsum, in bf16 on bf16 operands with a bf16 output); and
    # the LSTM kernels at LSTM-TasNet's shapes (H = 500, the cluster kernels padded to 512:
    # the whole call with its pads as `ms`, the kernel alone as `kernel_ms`, with phase 14's
    # padded launches of that kernel) and GALRNet's (H = 128, the tensor cores), forwards at
    # serving's B = 8 x 4 s and training's B = 4 with cs, and their backwards, beside cuDNN's
    # nn.LSTM at the model's input width, with phase 14's main-path launches of that kernel
    # on that route (every shape and dtype).
    for (tag, dtype), timing in slice_d["kernels"]["decodes"].items():
        shape = SLICE_D_DECODE_SHAPES[tag]
        width = width_key(timing["path"], str(dtype)[6:], shape["N"], shape["CL"])
        entry = kernel_entry("fused_mask_decode", "csrc/mask_decode.cu",
                             "ops/pallas_kernels.py:114", slice_launches[width], timing,
                             mask_decode_bound(**shape, dtype=dtype), timing["library_ms"],
                             dtype=dtype)
        entry.update(path=timing["path"], shape=f"{SLICE_D_NAMES[tag]} decoder shape",
                     **{k: timing[k] for k in ("kernel_ms", "generic_ms", "generic_kernel_ms")
                        if k in timing})
        entries.append(entry)
    sources = {("fma", False): "csrc/lstm_scan.cu", ("fma", True): "csrc/lstm_scan_bwd.cu",
               ("cluster", False): "csrc/recurrence_cluster.cuh",
               ("cluster", True): "csrc/recurrence_cluster_bwd.cuh",
               ("wide", False): "csrc/recurrence_wide.cuh",
               ("wide", True): "csrc/recurrence_wide_bwd.cuh",
               ("mma", False): "csrc/recurrence_mma.cuh",
               ("tf32x3", False): "csrc/recurrence_tf32.cuh",
               ("tf32x3", True): "csrc/recurrence_bwd_tf32.cuh",
               ("tf32x2", True): "csrc/recurrence_bwd_tf32.cuh"}
    replaces_of = {"lstm_scan_bidir": "ops/pallas_lstm.py:323",
                   "lstm_scan": "ops/pallas_lstm.py:166",
                   "lstm_scan_bidir_bwd": "ops/pallas_lstm.py:339",
                   "lstm_scan_bwd": "ops/pallas_lstm.py:230"}
    for (name, tag, label, dtype), timing in slice_d["kernels"]["recurrences"].items():
        route = timing["path"]
        B, T, H_row, _ = next(shape for t, lab, shape, *_ in SLICE_D_SHAPES
                              if (t, lab) == (tag, label))
        launched = f"{name}/{'padded' if 'padded_width' in timing else route}"
        entry = kernel_entry(name, sources[(route, name.endswith("_bwd"))], replaces_of[name],
                             slice_launches[launched], timing,
                             {k: timing[k] for k in ("bound_ms", "bound_by")},
                             timing["library_ms"], dtype=dtype)
        entry.update(path=route, shape=f"{SLICE_D_NAMES[tag]} {label} B={B} T={T} H={H_row}"
                     + (", with cs" if "train" in label else ""),
                     **{k: timing[k] for k in ("kernel_ms", "fma_kernel_ms", "kernel_bound_ms",
                                               "fma_bound_ms", "fma_max_abs_err",
                                               "vs_fma_max_abs_err", "tile", "cluster",
                                               "padded_width", "co_resident", "waves")
                        if k in timing})
        entries.append(entry)
    # Phase 15's shapes (phase 15k's times): the LSTM kernels at FurcaNet's (H = 128, 4 x
    # 16000 training with cs and its backward, 8 x 32000 serving in both dtypes; cuDNN at F =
    # 128 as `library_ms`, at 256 as `library_f256_ms`, the tf32x3 tiles' times as
    # `tiles_ms`) and MRX's (H = 256: 1 x 1724 serving, 16 x 1035 training with cs and its
    # backward, on "cluster"), with phase 15's launches of that kernel on that route; and
    # fused_mask_decode at stereo Conv-TasNet's (N = 256, C·L = 40) and Meta-TasNet's (N =
    # 440, C·L = 20) widths, f32, with phase 15's decodes of that width.
    for (name, model, label, dtype), timing in rest["kernels"]["recurrences"].items():
        route = timing["path"]
        B, T, H_row, _ = next(shape for m, lab, shape, *_ in REST_SHAPES
                              if (m, lab) == (model, label))
        entry = kernel_entry(name, sources[(route, name.endswith("_bwd"))], replaces_of[name],
                             rest_launches[f"{name}/{route}"], timing,
                             {k: timing[k] for k in ("bound_ms", "bound_by")},
                             timing["library_ms"], dtype=dtype)
        entry.update(path=route, shape=f"{model} {label} B={B} T={T} H={H_row}"
                     + (", with cs" if "train" in label else ""),
                     **{k: timing[k] for k in ("kernel_ms", "fma_kernel_ms", "kernel_bound_ms",
                                               "fma_bound_ms", "fma_max_abs_err", "tile",
                                               "cluster", "library_f256_ms", "tiles_ms",
                                               "tiles_kernel_ms", "plain_steps")
                        if k in timing})
        entries.append(entry)
    for kind, timing in rest["kernels"]["decodes"].items():
        shape = WAVE_DECODE_SHAPES[kind][0]
        entry = kernel_entry("fused_mask_decode", "csrc/mask_decode.cu",
                             "ops/pallas_kernels.py:114",
                             rest_launches[width_key(timing["path"], "float32", shape["N"],
                                                     shape["CL"])], timing,
                             mask_decode_bound(**shape, dtype=torch.float32),
                             timing["library_ms"])
        entry.update(path=timing["path"], shape=f"{kind} decoder shape (B=1 x 10 s)",
                     kernel_ms=timing["kernel_ms"])
        entries.append(entry)
    # Phase 16's shapes (phase 16k's times): lstm_scan_bidir at H = 300 on its planned route
    # (the cluster kernels padded to 384 for a 4 s utterance's (1, 501) x 2 in both dtypes;
    # the recipes' training shape (64, 101) x 2 with cs and its backward where the plan's
    # constants put it): the whole call as `ms` (a padded one's pads and slices included),
    # the kernel alone as `kernel_ms`, the FMA kernel forced beside it as `fma_ms` /
    # `fma_kernel_ms`, cuDNN's nn.LSTM (F = 129) as `library_ms`, the bound of the unpadded
    # work, with phase 16's launches of that kernel on that route (every shape and dtype of
    # phase 16).
    for (name, label, dtype), timing in spec["kernels"].items():
        route = timing["path"]
        B, T, _ = next(shape for lab, shape, *_ in SPEC_SHAPES if lab == label)
        entry = kernel_entry(name, sources[(route, name.endswith("_bwd"))], replaces_of[name],
                             spec_launches[f"{name}/{route}"], timing,
                             {k: timing[k] for k in ("bound_ms", "bound_by")},
                             timing["library_ms"], dtype=dtype)
        entry.update(path=route, shape=f"DANet / ADANet / DC {label} B={B} T={T} H={SPEC_H}"
                     + (", with cs" if label == "train" else ""),
                     **{k: timing[k] for k in ("kernel_ms", "fma_kernel_ms", "kernel_bound_ms",
                                               "fma_max_abs_err", "vs_fma_max_abs_err", "tile",
                                               "cluster", "padded_width")
                        if k in timing})
        entries.append(entry)
    # Phase 17's shapes (phase 17k's times): lstm_scan_bidir at MMDenseLSTM's H = 64 and 16
    # (tf32x3 in f32, mma in bf16, the FMA kernel forced beside them as `fma_ms`) and 4 (the
    # FMA kernel: the whole call as `ms`, the kernel alone as `kernel_ms`), a 10 s chunk's
    # B = 1 sequences in both dtypes and recipe training's B = 6 with cs and its backward;
    # cuDNN's nn.LSTM at the layer's input width as `library_ms`; with phase 17's launches
    # of that kernel on that route (every shape and dtype of phase 17).
    for (name, label, H_row, dtype), timing in slice_e["kernels"].items():
        route = timing["path"]
        (B, T, _), features = next((shape, f) for lab, shape, f, *_ in MMDL_SHAPES
                                   if lab == label and shape[2] == H_row)
        entry = kernel_entry(name, sources[(route, name.endswith("_bwd"))], replaces_of[name],
                             slice_e_launches.get(f"{name}/{route}", 0), timing,
                             {k: timing[k] for k in ("bound_ms", "bound_by")},
                             timing["library_ms"], dtype=dtype)
        entry.update(path=route, shape=f"MMDenseLSTM {label} B={B} T={T} H={H_row} F={features}"
                     + (", with cs" if label == "train" else ""),
                     **{k: timing[k] for k in ("kernel_ms", "fma_kernel_ms", "kernel_bound_ms",
                                               "fma_bound_ms", "fma_max_abs_err", "tile")
                        if k in timing})
        entries.append(entry)
    # Phase 18's decodes (the ORPIT CLI's validation batches, its evaluated utterances and
    # the other PITs' three-source validation forwards: every one f32 "generic" at N = 512,
    # C·L = 16), timed at the ORPIT validation shape.
    timing = slice_g["decode"]
    entry = kernel_entry("fused_mask_decode", "csrc/mask_decode.cu", "ops/pallas_kernels.py:114",
                         slice_g_launches[width_key(timing["path"], "float32", 512, 16)], timing,
                         mask_decode_bound(**ORPIT_VALID_SHAPE, dtype=torch.float32),
                         timing["library_ms"])
    entry.update(path=timing["path"], shape="ORPIT validation shape (phase 18)",
                 kernel_ms=timing["kernel_ms"])
    entries.append(entry)
    entries += [
        # Two reads of x and one int8 write; no single PyTorch call computes it.
        kernel_entry("quantize_int8", "csrc/quantize.cu", "ops/pallas_kernels.py:45",
                     total["quantize_int8"], quant_timing,
                     bound(3.0 * n_big, 9.0 * n_big + 4, f32)),
    ]
    log(card)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
