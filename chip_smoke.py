"""Smoke run of the s2t_tpu_torch serving, training, raw-audio, PDS, SATE, Conformer, CTC
research-stack, encoder-variant, generator, wav2vec 2.0, dual / multibranch, text MT,
Berard, Emformer, wav2vec v1, ConvS2S, adaptive-LM, alignment, NAT, BART / mBART,
LSTM / LightConv / DynamicConv, multilingual Transformer, RoBERTa / BERT, GPT-2, online
backtranslation, latency-augmented training and training-loop breadth slices on one
NVIDIA H100.

The earlier paths' fp32 CPU references run at a smaller depth than their presets
(``shallow``: REF_LAYERS layers a stack, each inter tap kept), while every path's bf16
steps and timed decodes run the preset on the card; the launch assertions scale with
the depth each run has.  Only phase 8's training step is profiled (the other busy shares
and by-part device ms are recorded in PERF.md; CTC-Aug's oracle Viterbi is counted by
call), and the earlier phases take EARLIER_TIMED timed steps.

    python3 chip_smoke.py [--out results.json]

Phases (any failure ends the run with a non-zero exit):
  1. build   every CUDA source of s2t_tpu_torch/csrc with nvcc (sm_90a), one
             process per source, all started together, printing each kernel's
             registers and spills (-Xptxas -v) and failing if fbank_kernel
             spills; then cuobjdump -sass counts the
             tensor-core instructions (HMMA, HGMMA) of every attention kernel
             and fails if a bf16 kernel (forward, dK/dV, dQ) has none at any
             padded head dim, WIDE (16-byte copies) or not.  While nvcc runs,
             phases 39, 41, 42, 43, 48 and 51, which launch no kernel of the port,
             run first;
  2. kernel  the attention forward (K1f) against its plain PyTorch version on
             the card at the s/m/l head plans, T' = 250 and 1000, ragged
             lengths with a 0-length row, fp32 and bf16, native (B, T, H, D)
             and head-major strided layouts; at the recipes' head dims 44, 80,
             90, 96 (and an odd 45) also a fused (B, T, 3, H, D) buffer; rows of
             0 frames (a SATE textual encoder under a CTC shrink that calls a
             row all blank), one batch entirely so; times
             kernel, plain version and torch's scaled_dot_product_attention (a
             yardstick only), at the serving shape for D = 64, 44, 80, 90, 96,
             and at the PDS stage-0 serving shape (B=64, T'=500, H=4, D=64;
             D = 50, the growth360 recipes' stage 0, held ragged at T'=500);
  3. grad    K1f with dropout 0 / 0.15 and its log-sum-exp, and the attention
             backward (K1b), against the plain version and its autograd
             backward with the same seed, at the same head plans, dtypes and
             layouts, and at D = 44, 80, 90, 96 (p = 0 and 0.15, native and
             fused layouts, ragged with a 0-length row); two bf16 cases whose
             rows put their probability on one
             key (a length-1 row; Q = 8 K), where Delta must come from the f32
             O; the kept share of the dropout mask; at the training shape K1f
             with lse and K1b at p = 0.1 (the main path) and p = 0, beside the
             backward of scaled_dot_product_attention at p = 0, and so at the PDS
             stage-0 training shape (B=40, T'=500, H=8, D=64; D = 50 ragged);
  4. ctc     the CTC alpha (K3) and beta/gradient (K4) kernels against their
             plain versions at the training shape (B=40, T'=250, S=59), a
             long one (T'=1000, S=401) and S = 1, 3, 31, 33, 63, 65, 255, 257,
             1023 and 1025 across K3's states-per-lane steps and its
             single-warp limit and K4's warps and its 32-warp limit, ragged
             lengths, repeated labels, an infeasible and a 0-frame row; K4's
             device ms beside its CTA-wide kernel's at every case; at the
             training shape the chain floor of K3's and of K4's own step and
             torch's ctc_loss;
  5. serve   s2t_transformer_s at full width (seeded random weights) answers
             the four fixture wavs with beam 5 through the hub, fp32, on the
             card (kernel) and on the CPU (plain): encoder outputs within
             ENC_ATOL and identical top-beam tokens, or a printed near-tie;
  6. speed   the same model in bf16 on 64 synthetic 10 s waveforms;
  7. train   s2t_transformer_m at full width, fp32, dropout 0: 2 steps of the
             port's Trainer on the card (kernels) and on the CPU (plain),
             per-step loss / ctc_loss / gnorm and the parameters after 2 steps
             (every phase's fp32 training parity takes 2 steps; the serving
             parity of phases 5, 16, 19, 21, 23, 25, 26, 28 decodes 20 tokens;
             phase 6's timing takes a warm-up and one timed batch, as phases 16,
             19, 21 and 25, and phase 30 a warm-up and one timed decode a mode; the
             fp32 card and CPU models of a check are one seeded build, copied to
             the card, ``seeded_pair``);
  8. train   s2t_transformer_m in bf16 at the bench shape (B=40, T=1000, U=30,
     speed   V=10000, preset dropouts, ctc_weight 0.3): one warm-up step, 20
             timed steps, steps/s, frames/s, tokens/s, MFU, and one profiled
             step (device busy share, top device ops, each kernel's share);
 10. fbank   the Kaldi fbank (K5) against fbank_plain over every frame and
             against fbank_numpy over each row's frames: silence, a square
             wave, a DC offset, the fixture wavs and ragged lengths 399 ...
             123457 padded to 160,000 samples; times at B=40 x 10 s;
 11. train   cli.train trains s2t_transformer_m at full width in bf16 from a
     audio   seeded corpus of 16-bit wavs (80 train / 16 dev, 4-12 s, V=10000):
             K5 then utterance CMVN + SpecAugment inside the step, label-smoothed
             CE + CTC, 2 epochs with validation and checkpoints (the losses
             must fall), then a 3rd epoch resumed from checkpoint_last.pt; one
             fp32 forward_fn + criterion pass card vs CPU;
 12. generate cli.generate beam-5 decodes 8 dev utterances as fbank_numpy
             features from phase 11's checkpoint_last.pt;
 13. nast     s2t_ctc at full width (s2t_ctc_base, V=10000) serves greedy CTC
             through CTCGenerator in bf16 at bench.py's NAST shape (B=256,
             T=1000 frames): utterances/s and RTF (median of 3 batches after
             a warm-up) and the device busy share of one profiled batch; then
             fp32 on the fixture wavs, greedy and beam 5, card vs CPU: top
             tokens identical, or a printed near-tie;
 14. train    cli.train trains s2t_ctc with purectc.yaml's model section (18
     ctc      layers, embed norm, no embedding scale) in bf16, criterion ctc,
             2 epochs on phase 11's corpus written as fbank features, with
             eval_ctc_wer and eval_wer; cli.generate decodes the dev split
             (beam 5, ctc_infer) from checkpoint_best.pt, and
             hub.from_pretrained transcribes 4 dev utterances to cli.generate's
             D- strings;
 15. wer      tools/wer_sanity (bench.py section C) overfits 16 synthetic
     sanity   utterances with the 2-layer model on the card and must read WER 0;
 16. pds      pdss2t_transformer_s_8 at full width (256 d, stages 3/3/3/3 at
     serve    ratios 2/2/1/2, 6 decoder layers, V=10000) serves as phases 5-6
             do: the fixture wavs in fp32 card vs CPU (encoder outputs within
             ENC_ATOL, beam-5 tokens identical or a near-tie), then 64 x 10 s
             in bf16 (utterances/s, RTF, host fbank, encode and beam seconds),
             and the device ms of each stage of one encode;
 17. pds      s2t_ctc_pds with the model section of purectc_pds_base_8_growth360
     ctc      (dims 200/256/256/360, 4/4/4/4 layers) serves greedy CTC in bf16 at
             phase 13's B=256 x 1000 frames (RTF, busy share, each stage's
             device ms); fp32 fixture wavs greedy and beam 5 card vs CPU;
 18. pds      (a) pds_big.yaml's model (pdss2t_transformer_m_8 with fusion) in
     train    fp32, dropout 0, 2 Trainer steps card vs CPU at TRAIN_RTOL; (b) the
             same model in bf16 at the bench shape (B=40, T=1000, U=30, V=10000,
             label-smoothed CE + 0.3 CTC), 20 timed steps, one profiled step and
             K1f's / K1b's device ms split by stage; (c) cli.train on phase 14's
             feature corpus with egs/mustc/asr/conf/pds_base_8.yaml over its
             basis.yaml (eval_wer), 2 epochs, cli.generate (beam 5) from
             checkpoint_best.pt, and hub.from_pretrained transcribing the 4
             longest hypotheses to cli.generate's D- strings;
 19. sate     s2t_sate_s (sate.yaml: acoustic 12 x 256, league adapter, textual
     serve    6 x 256, decoder 6 x 256, V=10000) as phases 5-6: fp32 fixture
             wavs card vs CPU (beam-5 tokens identical or a near-tie), 64 x 10 s
             in bf16, 18 K1f launches an encode, the encode's device ms split
             acoustic / adapter / textual by forward-hook ranges; the same for
             sate_pds_8.yaml's model (a PDS acoustic encoder, 3/3/3/3 layers);
 20. sate     (a) s2t_sate_s fp32, dropout 0, 2 Trainer steps card vs CPU at
     train    TRAIN_RTOL; (b) bf16 at the bench shape, 18/18/1/1 launches a step;
             (c) cli.train with sate.yaml (bf16) from phase 11's wav corpus (K5
             in the step), 2 epochs, cli.generate (beam 5) on the feature split
             and hub.from_pretrained;
 21. conformer s2t_conformer (12 x 256, kernel 31, swish, rel_pos: dense, so no
             K1f) served as phases 5-6 with the rel_pos attention's and the conv
             module's device ms of an encode; ConformerCTCSmall.yaml's model
             (16 x 176, head dim 44, Conv2d subsampler) fp32 card vs CPU for 3
             steps, through cli.train from raw audio (K5, K3, K4) for 2 epochs,
             and as phase 13 (greedy bf16 serving; fp32 greedy / beam-5 tokens
             card vs CPU);
 22. nast     s2t_nast (reproduction_nast.yaml: 18 x 256, inter-CTC at 6 / 9 / 12 with the
             inter_league PAE, XCTC, V=10000) as phase 13 through
             CTCGenerator(use_xctc=True), the encode's device ms split into layers, PAE
             adapters and CTC / XCTC heads by forward-hook ranges; fp32 greedy, beam 5
             and ctc_self_ensemble tokens card vs CPU; fp32 training card vs CPU (ctc 1,
             inter 0.5, xctc 1) and bf16 at the bench shape, 18 / 18 / 5 / 5 launches a step;
 23. bil_ctc  reproduction_bil_ctc.yaml on s2t_transformer_s (inter-CTC at 4, inter-XCTC
             at 8, both PAEs, the XCTC oracle at 0.3, CE + CTC 0.3 / 0.2 / 0.3 / 0.2):
             the oracle's Viterbi card vs CPU, fp32 training card vs CPU with 160-token
             targets (XCTC's S = 319 takes K3's CTA-wide kernel), bf16 at the bench shape
             (64-token targets) with each CTC term's device ms, 12 / 12 / 4 / 4 launches a
             step, K3 / K4 at that XCTC shape, fp32 beam-5 serving card vs CPU;
 24. aipa     reproduction_purectc_aipa_kd.yaml (a Conformer s2t_ctc, 18 x 256 rel_pos,
             4 shared inter-CTC taps, keep_org mixup at ratio 1: the batch doubles, the
             mixup-consistency losses): fp32 training card vs CPU with the host draws, bf16
             at the bench shape (each CTC term's device ms and the duplicated unmixed-row
             CTC), cli.train from phase 11's wavs for 2 epochs (K5 1, K3 / K4 10 a step),
             cli.generate greedy and from_pretrained;
 25. ctc_aug  reproduction_ctc_aug.yaml (a 12 x 256 rel_pos Conformer acoustic encoder with
             inter-CTC and the PAE, textual 6 x 256 with serial cross-stream layers 3-6 on
             layer 2's snapshot, inter-XCTC at 4 with xpae and the oracle at 0.5): fp32
             beam-5 tokens card vs CPU, bf16 64 x 10 s with the encode split into acoustic /
             adapter / textual and the textual self- and s2-attention, 10 K1f an encode;
             fp32 training card vs CPU with the oracle (its mask drawn on the host), bf16
             at the bench shape (10 / 10 / 5 / 5 launches a step, each CTC term's and the
             oracle Viterbi's ms);
 26. sate+pds nast_pds_big.yaml (s2t_ctc_sate over 4 PDS stages of 512, textual 12 x 512,
             XCTC) greedy at B=256 x 1000 frames through the task's generator (the acoustic
             head, as in JAX) and through the XCTC head, fp32 tokens card vs CPU for both,
             fp32 training card vs CPU; ctc_aug_pds_big.yaml fp32 beam-5 tokens card vs CPU
             (30 K1f an encode);
 27. pds taps pds_base_8_444.yaml with every stage tap (pds_ctc, pds_xctc, both PAEs, XCTC
             on the output) trained fp32 card vs CPU at ctc_layer 0 and 8; imputer_loss
             and its gradient card vs CPU; Jacobi decoding against beam 1 on the card;
 28. variants dlcl.yaml (DLCL), relative.yaml (s2t_transformer_s_relative: Shaw relative
             keys in the encoder, clip 100, and the decoder, clip 20), local_attn.yaml
             (Gaussian local attention), dynamic.yaml (s2t_dynamic_transformer_s) and
             rope on s2t_transformer_s at full s width: fp32 beam-5 tokens card vs CPU,
             the device ms of the self-attention sublayers (dense, convolving or fused)
             in a bf16 64 x 1000-frame encode, 2 fp32 Trainer steps card vs CPU; K1f /
             K1b 12 an encode / a step under DLCL and rope, none in the dense and
             convolving variants;
 29. efficient EffecientConformerCTCSmall.yaml (s2t_ctc_pds with in-layer strided,
             widening conv modules behind a Conv2d subsampler) as phase 13 with each
             stage's device ms, and one fp32 Trainer step card vs CPU;
 30. generator s2t_transformer_s at full width: fp32 fixture wavs card vs CPU with joint
             CTC at 0.2 (phase 5's beam), then 20-token cases of prefix forcing, diverse
             groups, sampling on handed-over uniforms, ordered constraints, a 2-member
             ensemble (24 K1f an encode), LM fusion with a seeded transformer_lm and the
             int8 cache; lazy = eager tokens on the card; bf16 at phase 6's shape (64 x
             10 s, beam 5, features precomputed): plain, joint CTC, int8 and lazy in
             turns, RTF, busy ms and the prefix scorer's device ms; s2t_ctc_base beam 5
             with an ARPA n-gram LM card vs CPU; ctc_rescore.yaml through cli.generate;
 31. w2v2     wav2vec2_base.yaml (wav2vec2_base, 12 x 768, the 7-layer conv extractor):
     pretrain fp32 card vs CPU on 2 crops (3 s, 2.2 s) with handed-over span uniforms,
             negatives and Gumbel uniforms (loss, codes, every gradient); bf16 as the
             recipe sets it, 3 timed steps of 4 x 250,000-sample crops with the forward
             split into extractor / positional conv / layers / quantizer / loss ranges;
             cli.train from seeded wavs, 2 updates;
 32. w2v2 st  w2v2.yaml (s2t_w2v2_transformer_base at full width, 2 layers a stack):
             cli.generate beam-5 decodes 16 x 10
             s waveforms from a use_audio_input directory (the repaired path: the
             waveforms reach the encoder as collated), fp32 tokens card vs CPU (20
             tokens), hub.from_pretrained; 2 fp32 Trainer steps card vs CPU through
             waveform_forward on handed-over span uniforms;
 33. w2v ctc  wav2vec_ctc_finetune.yaml: 2 fp32 steps under tri_stage card vs CPU, then
             greedy CTC tokens of 4 x 10 s card vs CPU;
 34. league   dual.yaml / multibranch.yaml (s2t_dual_s, s2t_multibranch_s) under
             join_speech_and_text_loss: 2 fp32 steps card vs CPU, 3 bf16 steps at 40 x
             1000 frames, fp32 inference card vs CPU (the beam generator refuses both,
             as JAX's does; CTC and teacher-forced decoder argmax), the league
             attention's share of a bf16 64 x 1000-frame encode;
 35. item 15  quant_noise.yaml and multilingual.yaml (3 language splits) through cli.train,
             2 updates each;
 36. w2v attn K1f / K1b at wav2vec2_base's shape (B=4, T'=781, H=12, D=64, bf16, K1b at p =
             0.1) against their plain versions, timed beside SDPA (run after phase 4);
 37. mt       egs/mustc/mt/conf/base.yaml on basis.yaml (transformer: pre-norm 512 / 2048,
             6 + 6 layers, 8 heads, dictionaries of 10,000): 2 fp32 steps card vs CPU,
             bf16 steps at 128 x 64 source and 64 target tokens, cli.train (2 updates)
             -> cli.generate on a seeded whitespace corpus, hub.from_pretrained answering
             text requests on the card and the CPU, beam-5 tokens of 64 sentences card
             vs CPU (20 tokens); K1f / K1b at the MT shape and K3 / K4 at
             transformer_ctc's (T = 192 upsampled frames, S = 127) against their plain
             versions, timed beside SDPA / ctc_loss (run after phase 4);
 38. mt ctc   egs/mustc/mt/conf/ctc.yaml (transformer_ctc, ratio 3): 2 fp32 steps card
             vs CPU, bf16 steps at phase 37's shape, K3 / K4 on the upsampled encoder;
 39. berard   s2t_berard_512_5_3 (cuDNN LSTMs): 2 fp32 steps card vs CPU, bf16 steps at
             40 x 1000 frames with 40-token targets, teacher-forced argmax card vs CPU;
 40. emformer emformer_s under the CTC loss, cut to 3 layers for card vs CPU (random
             weights make the 12-layer model chaotic, in JAX too): 2 fp32 steps,
             greedy tokens of 40 x 1000 frames, a 1000-frame stream through
             streaming_step; at 12 layers its sensitivity and the stream on the card;
 41. w2v1     wav2vec (v1) under the CPC loss: fp32 scores, loss and gradients card vs
             CPU on handed-over draws with no quantizer, k-means and Gumbel; a bf16
             step on 10 x 150,000-sample crops;
 42. fconv    egs/wmt16/mt/conf/fconv.yaml (fconv_wmt_en_de: 768 embed, 15 GLU convs a
             side up to 2048 channels, dictionaries of 10,000): 2 fp32 steps card vs CPU
             under ``fixed``, bf16 steps at phase 37's shape, cli.train -> cli.generate,
             beam-5 tokens card vs CPU through the rolling conv windows;
 43. lm       egs/wikitext103/lm/adaptive_lm.yaml (transformer_lm_wiki103, 16 x 1024,
             adaptive input / softmax over 267,744 words): fp32 card vs CPU at full width
             and 2 layers, bf16 steps at 8 blocks of 512 under ``cosine``, cli.train;
 44. align    egs/wmt16/align/transformer_align.yaml: 2 fp32 steps card vs CPU with
             seeded alignments and alignment_loss, bf16 steps at phase 37's shape,
             cli.train with load_alignments -> cli.generate;
 45. nat      egs/wmt16/nat/{cmlm,levenshtein,insertion,nacrf}.yaml at 512, 6 + 6: fp32
             steps card vs CPU on handed-over noise, each refinement decode on the card
             with every decoder pass replayed on the CPU (its argmaxes near-ties at
             worst), both at REF_LAYERS a side, bf16 CMLM steps at phase 37's shape;
 46. bart     egs/cnn_dm/bart/denoising_pretrain.yaml (bart_base, 768 / 3072, 6 + 6, one
             table of 50,265) on bart_noise'd lines under its settings but its scheduler
             (polynomial_decay): 2 fp32 steps card vs CPU at 2 layers a side, 3 timed bf16
             steps at 128 x 64 (K1f / K1b 6 / 6 a step), cli.train on denoising (2
             updates) and multilingual_denoising (2 languages, 1 update) at 2 layers,
             beam-5 tokens of 16 noised lines card vs CPU, the classification head's
             logits card vs CPU;
 47. mbart    egs/cnn_dm/bart/mbart_ft_mt.yaml (mbart_large, 1024 / 4096, 12 + 12
             pre-norm): 3 timed bf16 steps over a table of 250,008 (K1f / K1b 12 / 12 a
             step, peak memory); at 2 layers a side and a 10,000-word table 2 fp32 steps
             and beam-5 tokens card vs CPU and cli.train of translation_from_pretrained_bart
             from a seeded checkpoint (finetune_from_model);
 48. rnn conv lstm_wiseman_iwslt_de_en (under cross_entropy), lstm_lm,
             lightconv_iwslt_de_en and dynamicconv_iwslt_de_en on phase 37's dictionaries
             and shapes: 2 fp32 steps card vs CPU, 2 timed bf16 steps, beam-5 tokens card
             vs CPU for the three encoder-decoders (no kernel: outside Pallas in JAX too);
 49. multi    fairseq's IWSLT'17 multilingual recipe (multilingual_transformer_iwslt_de_en:
     lingual  512 / 1024, 6 + 6, a de and an fr encoder, one shared decoder, dictionaries
             of 16,000): 2 fp32 round-robin steps card vs CPU at 2 layers a side, 2
             timed bf16 steps on the first batch of the task's batcher at max_tokens
             4000 (K1f / K1b 12 / 12 a step), cli.train (2 updates) -> cli.generate on
             de-en, translation_multi_simple_epoch (<lang:en> tags, 1 update), beam-5
             tokens of 8 sentences through pair_view card vs CPU;
 50. roberta  fairseq's RoBERTa pretraining recipe (roberta_base, 768 / 3072, 12 post-norm
             layers, 50,265 entries; masked_lm at 512 tokens, 16 samples): 2 fp32 steps
             card vs CPU on handed-over masks at 2 layers, 2 timed bf16 steps at 16 x 512
             (K1f / K1b 12 / 12 a step, one profiled), the 2-class head's logits card vs
             CPU, cli.train one update each of sentence_prediction, sentence_ranking,
             legacy_masked_lm (bert_base, NSP) and cross_lingual_lm (2 languages);
 51. gpt2     hf_gpt2 (GPT-2 small: 768, 12 layers, 50,257 entries, 1024 positions)
             through language_modeling: 2 fp32 steps card vs CPU at 2 layers, 2 timed
             bf16 steps at 8 x 1024, incremental logits against the full forward and
             greedy tokens card vs CPU at full depth (no kernel; it runs while nvcc
             compiles);
 52. bt       semisupervised_translation over egs/mustc/mt/conf/base.yaml (both
             directions 512 / 2048, 6 + 6 pre-norm, bf16): cli.train of one epoch of
             BT_LINES bitext, backtranslation and denoising sentences (one batch each,
             3 updates, the origins logged) with the reverse model from a seeded port
             checkpoint generating in the BT batch's collate (K1f 6 there); one BT step
             timed with its generation (ms, the generation's share, peak memory); the
             reverse model's synthetic sources card vs CPU at 2 layers a side, identical;
 53. latency  s2t_transformer_s (egs/mustc/st/conf/base.yaml's widths) under
             latency_augmented_label_smoothed_cross_entropy (weighted_average, DAL, both
             weights 0.1): 2 fp32 steps card vs CPU at 2 layers (loss, latency_loss,
             gnorm), 2 timed bf16 steps at full depth beside the plain label-smoothed CE
             (the capture's cost), one bf16 step of the MT base under it; composite_loss /
             model and the legacy modules card vs CPU on small inputs;
 54. optim    the seven new optimizers (3 updates of s2t_transformer_s's parameters,
             one non-finite step, clipping, lr_groups with the encoder frozen) card vs
             CPU; bf16 steps of s2t_transformer_s at phase 8's shape plain, with
             encoder_layerdrop 0.2 and with remat full / dots (ms, peak memory, each
             step's K1f / K1b: a dropped layer runs none, a checkpointed one K1f twice);
             fp32 gradients with every remat policy against those without at dropout
             0.1 under torch's deterministic algorithms, bit for bit; cli.train under
             reduce_lr_on_plateau over 2 epochs at lr 0 (the lr scale shrinks at the
             second validation);
 55. parallel s2t_transformer_s at full width and depth with CTC, fp32, dropout 0, 2 steps
             at B=8 x T=600: the one-device Trainer's steps (Adam; SGD followed by
             the port's BMUF block update) as references; pipeline_parallel=2 on one
             rank (4 microbatches) from the same weights restacked; then, alone on
             the card, two ranks over gloo on cuda:0 (``--parallel-rank``): DP, TP
             (H / 2 heads a rank), FSDP and BMUF (SGD, a sync every update with block
             momentum 0.5 and the NBM lookahead), each held to its reference on the
             whole batch (loss and norm at the card-vs-CPU rtol, Adam's parameters
             within 2 sum(lr), BMUF's within 1e-5); each mode's step ms and peak GB;
 56. item16   pdss2t_transformer_s_8 under a 192-wide decoder with learned positions
             over its 256-wide encoder: 2 fp32 steps card vs CPU at the cut depth, one
             timed bf16 step at full depth;
  9. summary the ten slowest phases and the seconds of phases 1-54 and 55-56, the
             kernels line, the card's name and power limit, and the final
             {"ok": true, ...} line.
The launch counters are set to 0 before each main-path run and read after
it: serving (phases 5-6, 13, 16-17, 19, 21-23, 25-30) launches K1f once per encoder
layer that attends with the fused kernel and encode (abs or rope under a padding
mask; a PDS encoder: every stage's layers; SATE: the acoustic and the textual
layers, and a cross-stream layer's s2-attention; a rel_pos, Shaw-relative or
Gaussian layer attends densely and a lightweight or dynamic one convolves: they
launch none); a training step (phases 7-8, 14, 15, 18, 20-29) launches K1f and K1b
once per such layer,
K3 and K4 once per CTC term (once without the stack; phase 22 5, 23 4, 24 10:
mixup runs each term twice; 25 5, 26 2, 27 7); a
raw-audio forward (phases 11, 20, 21, 24, train or valid) adds K5 once; decoding
(phases 12, 14, 18, 20, 24) launches K1f once per such layer and encode, and a
validation batch of phase 14 runs three encodes (the loss, eval_ctc_wer,
eval_wer), of phase 18 two (the loss, eval_wer).  Phases 31-35 count the same way:
every self-attention of the wav2vec 2.0 stacks, the w2v2 model's post-w2v layers, the
dual text encoder and the multibranch branches takes a padding-only mask and runs K1f /
K1b (12 a wav2vec2_base encode, 18 for w2v2.yaml's model and the dual model, 24 for the
multibranch one); the league (s2) attention is dense and launches none.  Phases
37-38: the text encoder's self-attention runs K1f (6 an encode) and K1b (6 a step);
transformer_ctc's CTC term K3 / K4 once a step; phases 39-41 launch none of the kernels
but the Emformer's CTC term (K3 / K4 once a step): Berard's LSTMs, the Emformer's
segment attention and wav2vec's convolutions are outside Pallas in JAX too.  Phases
42-43 launch none either (fconv's convolutions and the causal LM's attention are dense
in JAX too); phase 44's text encoder runs K1f / K1b 6 a pass; phase 45's encoder and
its non-causal decoder run them 6 a pass each: 12 / 12 a CMLM, NACRF or insertion step,
24 / 24 a Levenshtein step, and a refinement decode 6 + 6 a decoder pass (at the
references' depth 2 a pass).  Phases 46-47: the BART / mBART encoder runs K1f / K1b once a
layer (6 / 6 a bart_base step, 12 / 12 an mbart_large one; 2 / 2 at the cut depth), and
K1f once a layer an encode; their causal decoders attend densely; phase 48 launches none.
Phase 49: each language's encoder runs K1f / K1b once a layer (a round-robin step runs
both pairs: 12 / 12, 4 / 4 at the cut depth), the shared causal decoder none; phase 50's
RoBERTa / BERT layers once a layer (12 / 12 a roberta_base step); phase 51 none.
Phase 52's text encoders run K1f / K1b once a layer (6 / 6 a step) and the reverse
model's encoder K1f 6 in a BT batch's collate; phase 53's once a layer of the encoder
(12 / 12 an s2t_transformer_s step, no CTC term under the latency CE); phase 54 counts
each step's kept layers under LayerDrop and K1f twice a checkpointed layer (the
recompute), and so does the remat-vs-plain gradient check.  Phase 55: K1f / K1b 12 / 12
and K3 / K4 once a step in every mode and rank (a TP rank runs them on its own heads),
the pipelined model's K1f / K1b once a layer a microbatch (48 / 48); each gloo rank
counts its own launches and hands them back; phase 56's PDS encoder once a layer.
Every kernel and library time is taken twice: ``ms`` with CUDA events around
back-to-back calls (the call's host work included, which is what a call of a
few tens of microseconds reads) and ``device_ms``, the device time of the
call's own kernels (all kernels of a library call) in a torch.profiler trace.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from s2t_tpu_torch.cli.train import step_batch
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.hub import GeneratorHub
from s2t_tpu_torch.models.pds import (
    PDSConfig, PDSS2TTransformerModel, pdss2t_transformer_m_8, pdss2t_transformer_s_8)
from s2t_tpu_torch.models.s2t_transformer import (
    S2TTransformerConfig, S2TTransformerModel, s2t_conformer, s2t_transformer_m,
    s2t_transformer_s)
from s2t_tpu_torch.models.sate import S2TSATEModel, SATEConfig, s2t_sate_s
from s2t_tpu_torch.ops import _build
from s2t_tpu_torch.ops.attention_cuda import (
    PADDED_HEAD_DIMS, fused_attention, fused_attention_bwd, fused_attention_fwd,
    fused_attention_plain, keep_mask)
from s2t_tpu_torch.ops.ctc import _extend_labels, _lattice_logp, _transition_mask
from s2t_tpu_torch.ops.ctc_cuda import (
    _SIGNATURES as CTC_SIGNATURES, NEG_INF, beta_grad_kernel, ctc_alpha, ctc_alpha_plain,
    ctc_beta_grad, ctc_beta_grad_plain, ctc_chain_floor)
from s2t_tpu_torch.ops.fbank_cuda import fbank, mel_bin_ranges
from s2t_tpu_torch.registry import ARCHS
from s2t_tpu_torch.trainer import Trainer
from s2t_tpu_torch.utils.flops import s2t_train_flops
from s2t_tpu_torch.utils.masking import lengths_to_mask

ROOT = Path(__file__).resolve().parent
WAVS = [str(ROOT / "tests" / "fixtures" / "audio" / f"utt{i}.wav") for i in range(4)]

# kernel vs plain: fp32 sums in another order; bf16 output is one rounding of
# an f32 result (half a bf16 ulp is 1.6e-2 below |x| = 8) after P rounded to bf16
# before P V, as the Pallas kernel rounds it, held to the plain version evaluated
# in f32 on the same bf16 inputs (tests/test_torch_attention_bf16.py holds the
# Pallas kernel's own bf16 numerics inside this and GRAD_RTOL)
KERNEL_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# fp32 serving, card (kernel, cuBLAS, cuDNN without TF32) vs CPU (plain):
# 12 encoder layers summed in another order
ENC_ATOL = 1e-3
# attention backward, kernel vs autograd through the plain version (in f32 on the
# same inputs), relative to the largest entry of the reference gradient: fp32 sums
# in another order; bf16 adds one rounding of each output and of P o Z and dS before
# their products, each ~2^-8 relative; Delta = rowsum(dO o O) is taken from the
# forward's f32 output, so for a row whose probability sits on one key dS cancels
# to f32 rounding as in the Pallas kernel
GRAD_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
PEAK_SHARE = 0.99  # the peaked phase-3 case: each query's own key takes this much
LSE_ATOL = 1e-4  # log-sum-exp in f32 of f32-accumulated scores (|lse| < ~20)
KEPT_SHARE_TOL = 0.005  # kept share of the dropout mask vs 1 - k/256, absolute
# CTC kernels vs plain: the same f32 operations in the same order per state
CTC_ATOL = {"alpha": 1e-3, "demit": 1e-5}
# label counts U of phase 4's width cases: S = 2U + 1 = 1, 3 (one state a lane), 31, 33,
# 63, 65 (the steps to 2 and 3 a lane for K3, to 2 and 3 warps for K4), 255 (8, K3's
# single-warp limit), 257 (past it: K3's CTA-wide kernel), 1023 (32 warps, K4's widest
# one-state-a-lane lattice) and 1025 (past it: K4's CTA-wide kernel)
CTC_WIDTHS = (0, 1, 15, 16, 31, 32, 127, 128, 511, 512)
ALPHA_KERNELS = ("ctc_alpha_warp_kernel", "ctc_alpha_kernel")  # K3's two kernels
BETA_KERNELS = ("ctc_beta_grad_warps_kernel", "ctc_beta_grad_kernel")  # K4's two kernels
K4_FRAGMENT = "ctc_beta_grad"  # in both BETA_KERNELS: K4's launches in order, either kernel
# (head dim, heads) of phases 2-3's cases at the recipes' head dims that are no
# instantiation of the attention kernels: 176/4 (compare_purectc_base), 640/8
# (purectc_pds_large_8), 360/4 (the growth360 recipes), 384/4 (encoder_embed_dim 384)
NEW_HEAD_DIMS = ((44, 4), (80, 8), (90, 4), (96, 4))
# kernels whose -Xptxas -v line must show no spill, every instantiation
NO_SPILL_KERNELS = ("fbank_kernel", "ctc_beta_grad_warps_kernel")
# fp32 training card vs CPU over 2-3 steps (the same f32 math, reductions in another
# order through 18 layers): loss and ctc_loss relative, gnorm relative
TRAIN_RTOL = {"loss": 1e-4, "ctc_loss": 1e-4, "gnorm": 1e-3}
TRAIN_LAUNCHES = {"attention_fwd": 12, "attention_bwd": 12, "ctc_alpha": 1, "ctc_beta_grad": 1}
# name fragments of each attention wrapper's own kernels in a profiler trace (the
# bf16 tensor-core kernels and the fp32 FMA kernels both match)
FWD_KERNELS = ("attention_fwd",)
BWD_KERNELS = ("delta_", "dkdv_", "dq_")
# the bf16 kernels whose SASS must hold tensor-core instructions, by library
MMA_KERNELS = {"attention_fwd": ("attention_fwd_mma_kernel",),
               "attention_bwd": ("dkdv_mma_kernel", "dq_mma_kernel")}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # fp32 without tensor cores
GEN = dict(beam_size=5, max_len_a=0.0, max_len_b=100, lenpen=1.0)
EARLIER_TIMED = 2  # timed bf16 steps of the earlier phases' training (no kernel row reads them)
# the depth (layers a stack, each side) of the earlier paths' fp32 CPU references: the card
# runs each path at its preset's depth in its bf16 steps, and the launch assertions of a
# reference scale with the depth it runs at
REF_LAYERS = 2
REF_DEPTH = {"encoder_layers": REF_LAYERS, "decoder_layers": REF_LAYERS}


def log(msg: str) -> None:
    print(msg, flush=True)


# the attention types that take K1f / K1b under a padding mask (the JAX module's
# condition, s2t_tpu/modules/attention.py:264-269), written here and not read from the
# port, so that the expected launches do not follow a fault in the port's routing
KERNEL_ATTENTION_TYPES = ("abs", "rope")


def encoder_layers(cfg) -> int:
    """Encoder self-attention layers that run the fused kernel: K1f's launches per
    encode, K1b's per step (a dense layer launches neither; neither does a windowed or
    reduced abs / rope layer, which carries a bias or fewer keys)."""
    from s2t_tpu_torch.models.s2t_dual import S2TDualConfig
    from s2t_tpu_torch.models.s2t_multibranch import S2TMultiBranchConfig
    from s2t_tpu_torch.models.s2t_w2v2_transformer import S2TW2V2Config
    from s2t_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    # the wav2vec 2.0 family's, the dual text encoder's and the multibranch branches'
    # layers all attend under a padding-only mask (their league attention is dense)
    if isinstance(cfg, Wav2Vec2Config):
        return cfg.encoder_layers
    if isinstance(cfg, S2TW2V2Config):
        return cfg.w2v.encoder_layers + cfg.encoder_layers
    if isinstance(cfg, S2TDualConfig):
        return encoder_layers(cfg.speech) + cfg.text.encoder_layers
    if isinstance(cfg, S2TMultiBranchConfig):
        return encoder_layers(cfg.junior) + cfg.senior_layers + cfg.textual_layers
    if isinstance(cfg, SATEConfig):
        acoustic = cfg.pds if cfg.acoustic_encoder == "pds" else cfg.acoustic
        # CTC-Aug's cross layers attend with abs attention whatever text_attention_type
        # says, and their s2-attention too once the snapshot exists
        cross = cfg.cross_attn_start_layer if cfg.xctc_cross_attn and \
            cfg.cross_attn_start_layer > 0 else cfg.text_encoder_layers + 1
        snap = cfg.cross_attn_layer if cross <= cfg.text_encoder_layers else 0
        text = sum(1 + int(0 < snap < i) if i >= cross
                   else int(cfg.text_attention_type in KERNEL_ATTENTION_TYPES)
                   for i in range(1, cfg.text_encoder_layers + 1))
        return encoder_layers(acoustic) + text
    if cfg.encoder_attention_type not in KERNEL_ATTENTION_TYPES:
        return 0
    if isinstance(cfg, PDSConfig):
        return sum(cfg.pds_layers) + cfg.pds_final_layers
    if cfg.encoder_attention_window > 0 or cfg.encoder_attention_stride > 1:
        return 0
    return cfg.encoder_layers


TAP_FIELDS = ("inter_ctc_layers", "inter_xctc_layers", "inter_axctc_layers")


def shallow(cfg):
    """An earlier path's fp32 reference config: the encoder at the smallest depth (at least
    REF_LAYERS) that keeps each inter tap, in order (the tap layers renumbered 1, 2, ...,
    one layer past the last), a PDS encoder one layer a stage, the decoder at REF_LAYERS;
    SATE's acoustic encoder so and its textual one at REF_LAYERS (its textual taps and
    CTC-Aug's cross-stream layers keep the textual depth).
    The taps, so the CTC terms and K3 / K4's launches, stay; K1f / K1b's scale with the
    layers (``step_launches``, ``encoder_layers``)."""
    if isinstance(cfg, SATEConfig):
        kw = {"acoustic": shallow(cfg.acoustic)}
        if cfg.pds is not None:
            kw["pds"] = shallow(cfg.pds)
        # the textual taps and CTC-Aug's cross-stream layers keep the textual depth
        if not (cfg.inter_xctc_layers or cfg.cross_attn_start_layer or cfg.cross_attn_layer):
            kw["text_encoder_layers"] = REF_LAYERS
        return dataclasses.replace(cfg, **kw)
    if isinstance(cfg, PDSConfig):
        kw = {"pds_layers": (1,) * len(cfg.pds_layers)}
    else:
        taps = sorted({n for f in TAP_FIELDS for n in getattr(cfg, f, ())})
        where = {n: i + 1 for i, n in enumerate(taps)}
        kw = {f: tuple(where[n] for n in getattr(cfg, f)) for f in TAP_FIELDS
              if getattr(cfg, f, ())}
        kw["encoder_layers"] = max(len(taps) + 1, REF_LAYERS)
    if getattr(cfg, "decoder_layers", 0):
        kw["decoder_layers"] = REF_LAYERS
    return cfg.replace(**kw)


def step_launches(cfg, ctc_terms: int = 1) -> dict:
    """Launches of one training step of a model of ``cfg`` whose loss has
    ``ctc_terms`` CTC lattices (K3 and K4 once each)."""
    layers = encoder_layers(cfg)
    return {"attention_fwd": layers, "attention_bwd": layers, "ctc_alpha": ctc_terms,
            "ctc_beta_grad": ctc_terms}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Event-timed ms per call of ``iters`` back-to-back calls: the call's host work
    (checks, allocation, the launch) is inside, so a call of a few tens of
    microseconds reads its host time; ``device_ms`` reads the card's own."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, names=None, iters: int = 20, warmup: int = 3):
    """Device time per call of the CUDA kernels ``fn`` launched, from a torch.profiler
    trace of ``iters`` calls: the kernels whose names contain one of ``names`` (a
    hand-written kernel's own), or everything the call ran on the device when
    ``names`` is None (a library call).  Each name counts its mean duration times
    its launches per call, so an event the trace drops or doubles moves no sum;
    device events that start before the trace's first host event are not this
    trace's and are left out; a trace with no device event, or one whose count of
    a kernel's events is no multiple of ``iters`` (it lost or doubled some), is
    taken again (at most 3 times; a last incomplete trace still counts, logged, and
    so does an earlier incomplete one when the last recorded none).
    Returns (ms, {name: ms})."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    partial = None  # the last trace that kept some of the kernel's events
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        t0 = min((e.time_range.start for e in events if e.device_type == cpu), default=0)
        spans = {}
        for e in events:
            if e.device_type != cuda or e.time_range.start < t0:
                continue
            key = e.name if names is None else next((n for n in names if n in e.name), None)
            if key is not None:
                spans.setdefault(key, []).append((e.time_range.end - e.time_range.start) / 1e3)
        if spans:
            split = {k: float(np.mean(v)) * max(1, round(len(v) / iters)) for k, v in spans.items()}
            lost = {k: len(v) for k, v in spans.items() if len(v) % iters}
            if not lost or attempt == 2:
                if lost:
                    log(f"[profiler] the last trace kept {lost} events of {iters} calls")
                return sum(split.values()), split
            log(f"[profiler] a trace kept {lost} events of {iters} calls: taken again")
            partial = (lost, split)
            continue
        log(f"[profiler] a trace recorded no device kernel matching {names}: taken again")
    if partial is not None:  # a trace can lose events: the mean of those it kept still reads
        log(f"[profiler] the last trace recorded none; an earlier one kept {partial[0]} "
            f"events of {iters} calls")
        return sum(partial[1].values()), partial[1]
    raise AssertionError(f"three traces recorded no device kernel matching {names}")


def attention_bound(B, T, H, D, lengths, dtype):
    """Least time on the card: inputs read once, output written once, and the
    flops these lengths need (keys past a row's length are skipped, a
    0-length row attends to all T)."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * T * H * D * elem + B * T  # q, k, v, o + the (B, T) mask
    kv = [min(int(n), T) if n > 0 else T for n in lengths]
    flops = 4 * H * D * T * sum(kv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------- #
def kernel_label(mangled: str) -> str:
    """'attention_fwd_mma_kernel<64, true>' from a mangled kernel name
    (_ZN<len><namespace><len><name>[I<args>E]...: its int and bool template arguments,
    Li<n>E and Lb<0|1>E; type arguments are left out); other names as they are."""
    pos = 3 if mangled.startswith("_ZN") else len(mangled)
    while pos < len(mangled):
        digits = re.match(r"\d+", mangled[pos:])
        if not digits:
            break
        start = pos + digits.end()
        name, pos = mangled[start:start + int(digits.group())], start + int(digits.group())
        if name.endswith("_kernel"):
            args = re.match(r"I((?:L[ib]\d+E|[a-zA-DF-Z])+)E", mangled[pos:])
            vals = [n if kind == "i" else ("true" if n == "1" else "false")
                    for kind, n in re.findall(r"L([ib])(\d+)E", args.group(1) if args else "")]
            return name + (f"<{', '.join(vals)}>" if vals else "")
    return mangled


def phase_build():
    t0 = time.perf_counter()
    built = _build.build()
    spills = {}
    for name, (secs, out) in built.items():
        log(f"[build] {name}.cu in {secs:.1f} s")
        label = None
        for line in out.splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            props = re.search(r"Function properties for (\w+)", line)
            if entry:
                label = kernel_label(entry.group(1))
                log(f"[build]   {label}:")
            elif props:  # the spill line that follows is this function's
                label = kernel_label(props.group(1))
            elif "registers" in line or "spill" in line:
                log(f"[build]     {line.strip()}")
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if (spill and (label or "").split("<")[0] in NO_SPILL_KERNELS
                        and (int(spill[1]) or int(spill[2]))):
                    spills[label] = line.strip()
    if spills:
        raise AssertionError(f"kernels that must not spill do: {spills}")
    log(f"[build] sources {list(_build.sources())}: {len(built)} compiled, the last "
        f"{max((secs for secs, _ in built.values()), default=0.0):.1f} s after its start; "
        f"waited {time.perf_counter() - t0:.1f} s for them here")
    return sass_check()


def sass_check():
    """Count the tensor-core instructions (HMMA, HGMMA) in the SASS of every kernel of
    the attention libraries with cuobjdump; fail if a bf16 kernel has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    ops = ("HMMA", "HGMMA", "LDSM", "FFMA")
    procs = {lib: subprocess.Popen([tool, "-sass", str(_build.library_path(lib))],  # together
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for lib in MMA_KERNELS}
    counts = {}
    for lib, proc in procs.items():
        sass, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump -sass {lib} failed: {err}")
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            label = kernel_label(body.split("\n", 1)[0].strip())
            found = collections.Counter(re.findall(r"\b(HMMA|HGMMA|LDSM|FFMA)\b", body))
            counts[label] = {op: found[op] for op in ops}
            log(f"[sass] {lib}: {label} {json.dumps(counts[label])}")
    for kernels in MMA_KERNELS.values():
        for kernel in kernels:  # every padded head dim, with and without the WIDE copies
            want = [f"{kernel}<{dp}, {wide}>" for dp in PADDED_HEAD_DIMS
                    for wide in ("true", "false")]
            found = {k: counts.get(k) for k in want}
            if any(c is None or c["HMMA"] + c["HGMMA"] == 0 for c in found.values()):
                raise AssertionError(f"{kernel}: no tensor-core instructions in its SASS for "
                                     f"every instantiation: {found}")
    return counts


def make_qkv(B, T, H, D, dtype, layout, g):
    """q, k, v as (B, T, H, D) views: "native", the (B, T, H D) projection the model
    gives (h-stride D); "head_major", a (B, H, T, D) buffer; "fused_qkv", the three slices
    of one (B, T, 3, H, D) buffer (t-stride 3 H D, k and v H D and 2 H D elements in)."""
    if layout == "fused_qkv":
        buf = torch.randn((B, T, 3, H, D), generator=g, device="cuda").to(dtype)
        return list(buf.unbind(2))
    shape = (B, T, H, D) if layout == "native" else (B, H, T, D)
    qkv = [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]
    if layout == "head_major":
        qkv = [a.transpose(1, 2) for a in qkv]  # (B, T, H, D) view of a (B, H, T, D) buffer
    return qkv


def attention_case(B, T, H, D, dtype, layout, lengths, seed, time_it):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = make_qkv(B, T, H, D, dtype, layout, g)
    mask = torch.arange(T, device="cuda")[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]
    out = fused_attention(q, k, v, mask)
    ref = fused_attention_plain(q.float(), k.float(), v.float(), mask)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    res = {"B": B, "T": T, "H": H, "D": D, "dtype": str(dtype).split(".")[-1],
           "layout": layout, "max_abs_err": err, "atol": KERNEL_ATOL[dtype]}
    if time_it:
        bias = torch.where(mask, 0.0, -1e9).to(dtype)[:, None, None, :]
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)

        res["ms"] = cuda_ms(lambda: fused_attention(q, k, v, mask))
        res["device_ms"] = device_ms(lambda: fused_attention(q, k, v, mask), FWD_KERNELS)[0]
        res["plain_ms"] = cuda_ms(lambda: fused_attention_plain(q, k, v, mask), iters=5)
        res["library_ms"] = cuda_ms(sdpa)
        res["library_device_ms"] = device_ms(sdpa)[0]
        res["bound_ms"], res["bound_by"] = attention_bound(B, T, H, D, lengths, dtype)
    return res


def phase_kernel():
    rng = np.random.default_rng(0)
    cases = []
    B = 64
    plans = [(4, 64), (8, 64), (16, 64)]  # s, m, l head plans
    for T in (250, 1000):
        lengths = rng.integers(1, T + 1, size=B)
        lengths[0], lengths[1] = T, 0
        for H, D in plans:
            for dtype in (torch.float32, torch.bfloat16):
                for layout in ("native", "head_major"):
                    cases.append((B, T, H, D, dtype, layout, lengths, layout == "native"))
    lengths = rng.integers(1, 251, size=B)
    lengths[1] = 0
    for D in (32, 128):  # the other head dims that have an instantiation of their own
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((B, 250, 4, D, dtype, "native", lengths, False))
    # the recipes' head dims that are no instantiation (padded to 48, 80, 96, 96), and an
    # odd one (2-byte copies), in the (B, T, H D) projection, head-major and fused layouts;
    # the bf16 projection cases at the serving shape are timed beside the D = 64 row
    for D, H in NEW_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for layout in ("native", "head_major", "fused_qkv"):
                cases.append((16, 250, H, D, dtype, layout, lengths[:16], False))
    cases.append((8, 250, 3, 45, torch.bfloat16, "native", lengths[:8], False))
    cases.append((8, 250, 3, 45, torch.float32, "fused_qkv", lengths[:8], False))
    # a PDS encoder's stage 0 attends at T' = T/2: the growth360 recipes' 200/4 = 50 there
    lengths500 = rng.integers(1, 501, size=16)
    lengths500[0], lengths500[1] = 500, 0
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((16, 500, 4, 50, dtype, "native", lengths500, False))
    # a SATE textual encoder under the CTC shrink: a row the CTC head calls all blank is
    # 0 frames long (the kernel attends uniformly over all T keys, as the dense path
    # does); one batch where every row is
    shrunk = rng.integers(0, 126, size=16)
    shrunk[:4] = 0
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((16, 125, 4, 64, dtype, "native", shrunk, False))
        cases.append((8, 125, 4, 64, dtype, "native", np.zeros(8, np.int64), False))
    results = []
    with torch.inference_mode():
        for i, c in enumerate(cases):
            r = attention_case(*c[:7], seed=i, time_it=c[7])
            results.append(r)
            timing = "".join(
                f" {key}={r[key]:.4f}" for key in ("ms", "device_ms", "plain_ms", "library_ms",
                                                   "library_device_ms", "bound_ms")
                if key in r)
            log(f"[kernel] B={r['B']} T={r['T']} H={r['H']} D={r['D']} {r['dtype']:<8} "
                f"{r['layout']:<10} max_abs_err={r['max_abs_err']:.3e} (atol {r['atol']})"
                f"{timing}{' bound_by=' + r['bound_by'] if 'bound_by' in r else ''}")
            if not r["max_abs_err"] <= r["atol"]:
                raise AssertionError(f"attention kernel disagrees with its plain version: {r}")
        # the serving shape of phase 4: 64 requests of 10 s (T' = 250), bf16, s head plan
        main = attention_case(64, 250, 4, 64, torch.bfloat16, "native", [250] * 64,
                              seed=len(cases), time_it=True)
        # the same shape at the new head dims (4 heads), for the table beside D = 64
        by_dim = {D: attention_case(64, 250, 4, D, torch.bfloat16, "native", [250] * 64,
                                    seed=len(cases) + D, time_it=True)
                  for D, _ in NEW_HEAD_DIMS}
        # the stage-0 serving shape of pdss2t_transformer_s_8: 64 requests of 10 s, T' = 500
        pds0 = attention_case(64, 500, 4, 64, torch.bfloat16, "native", [500] * 64,
                              seed=len(cases) + 1, time_it=True)
    log(f"[kernel] serving shape {json.dumps(main)}")
    log(f"[kernel] PDS stage-0 serving shape {json.dumps(pds0)}")
    for D, r in by_dim.items():
        log(f"[kernel] serving shape at D={D}: device_ms {r['device_ms']:.4f} (D=64: "
            f"{main['device_ms']:.4f}), bound {r['bound_ms']:.4f}, SDPA device "
            f"{r['library_device_ms']:.4f}, max_abs_err {r['max_abs_err']:.3e}")
    if not all(r["max_abs_err"] <= r["atol"] for r in [main, pds0, *by_dim.values()]):
        raise AssertionError(f"attention kernel disagrees at the serving shape: {main} {pds0} "
                             f"{by_dim}")
    return results, main, by_dim, pds0


# --------------------------------------------------------------------------- #
def counters():
    return {"attention_fwd": fused_attention, "attention_bwd": fused_attention_bwd,
            "ctc_alpha": ctc_alpha, "ctc_beta_grad": ctc_beta_grad, "fbank": fbank}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def rel_err(got, want) -> float:
    """max |got - want| over max(1, max |want|), in f32."""
    want = want.float()
    return (got.float() - want).abs().max().item() / max(1.0, want.abs().max().item())


def attention_bwd_bound(B, T, H, D, lengths, dtype):
    """K1b: q, k, v, o, dO read and dq, dk, dv written once, lse / Delta (B, H, T)
    f32; the flops of its five products (S, dP, dV, dK, dQ) over the keys these
    lengths need."""
    elem = torch.finfo(dtype).bits // 8
    nbytes = 8 * B * T * H * D * elem + 2 * 4 * B * H * T + 4 * B
    kv = [min(int(n), T) if n > 0 else T for n in lengths]
    flops = 10 * H * D * T * sum(kv)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def grad_case(B, T, H, D, dtype, layout, lengths, rate, seed, time_it=False, q_from_k=0.0):
    """K1f with lse and K1b against autograd through the plain version; with
    ``q_from_k`` > 0, Q = q_from_k K, so each query's row peaks on its own key."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = make_qkv(B, T, H, D, dtype, layout, g)
    if q_from_k:
        q = (q_from_k * k.float()).to(dtype)
    do = torch.randn((B, T, H, D), generator=g, device="cuda").to(dtype)
    mask = torch.arange(T, device="cuda")[None, :] < torch.as_tensor(lengths, device="cuda")[:, None]
    lens = mask.sum(-1, dtype=torch.int32)
    rate_u8 = min(int(round(rate * 256)), 255)
    dseed = torch.randint(0, 2 ** 62, (1,), generator=g, device="cuda")
    out, lse, out32 = fused_attention_fwd(q, k, v, lens, rate_u8, dseed, with_lse=True)
    dq, dk, dv = fused_attention_bwd(q, k, v, out32, do, lse, lens, rate_u8, dseed)
    qf, kf, vf = (a.detach().float().requires_grad_() for a in (q, k, v))
    ref = fused_attention_plain(qf, kf, vf, mask, rate, dseed)
    ref.backward(do.float())
    with torch.no_grad():
        bias = torch.where(mask[:, None, None, :], 0.0, -1e9)
        lse_ref = torch.logsumexp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) / math.sqrt(D) + bias, -1)
        rows = lens > 0  # a 0-length row's lse is rounded away by the -1e9 bias
        lse_err = (lse[rows] - lse_ref[rows]).abs().max().item()
        # the smallest share of its row that a valid query's top key takes
        top = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf).amax(-1) / math.sqrt(D)
                        - lse_ref).transpose(1, 2)  # (B, T, H)
        peak_share = top[mask & rows[:, None]].min().item()
    torch.cuda.synchronize()
    res = {"B": B, "T": T, "H": H, "D": D, "dtype": str(dtype).split(".")[-1], "layout": layout,
           "dropout": rate, "out_rel_err": rel_err(out, ref), "lse_err": lse_err,
           "peak_share": peak_share,
           "dq_rel_err": rel_err(dq, qf.grad), "dk_rel_err": rel_err(dk, kf.grad),
           "dv_rel_err": rel_err(dv, vf.grad),
           "grad_max_abs_err": max((a.float() - b).abs().max().item()
                                   for a, b in ((dq, qf.grad), (dk, kf.grad), (dv, vf.grad))),
           "rtol": GRAD_RTOL[dtype]}
    if time_it:
        # the forward with lse and the backward at this rate (the main path) and at p = 0,
        # where the library's backward (no dropout) is the like-for-like yardstick
        _, lse0, out0 = fused_attention_fwd(q, k, v, lens, 0, None, with_lse=True)
        calls = {
            "fwd": (lambda: fused_attention_fwd(q, k, v, lens, rate_u8, dseed, True), FWD_KERNELS),
            "fwd_p0": (lambda: fused_attention_fwd(q, k, v, lens, 0, None, True), FWD_KERNELS),
            "": (lambda: fused_attention_bwd(q, k, v, out32, do, lse, lens, rate_u8, dseed),
                 BWD_KERNELS),
            "p0": (lambda: fused_attention_bwd(q, k, v, out0, do, lse0, lens, 0, None),
                   BWD_KERNELS),
        }
        for name, (fn, names) in calls.items():
            pre = f"{name}_" if name else ""
            res[f"{pre}ms"] = cuda_ms(fn)
            res[f"{pre}device_ms"], split = device_ms(fn, names)
            if names is BWD_KERNELS:
                res[f"{pre}device_ms_by_kernel"] = split
        qp, kp, vp = (a.detach().requires_grad_() for a in (q, k, v))
        plain_out = fused_attention_plain(qp, kp, vp, mask, rate, dseed)
        res["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(plain_out, (qp, kp, vp), do,
                                                              retain_graph=True), iters=5)
        qt, kt, vt = (a.detach().transpose(1, 2).requires_grad_() for a in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias.to(dtype))
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)

        res["library_ms"] = cuda_ms(library)
        res["library_device_ms"] = device_ms(library)[0]
        res["bound_ms"], res["bound_by"] = attention_bwd_bound(B, T, H, D, lengths, dtype)
    return res


def check_grad_case(r):
    bad = [key for key in ("out_rel_err", "dq_rel_err", "dk_rel_err", "dv_rel_err")
           if not r[key] <= r["rtol"]]
    if bad or not r["lse_err"] <= LSE_ATOL:
        raise AssertionError(f"attention kernels disagree with the plain version ({bad}): {r}")


def phase_attention_grad():
    rng = np.random.default_rng(1)
    cases = []
    B, T = 16, 250
    lengths = rng.integers(1, T + 1, size=B)
    lengths[0], lengths[1] = T, 0
    for H, D in [(4, 64), (8, 64), (16, 64)]:  # s, m, l head plans
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.15):
                for layout in ("native", "head_major"):
                    cases.append((B, T, H, D, dtype, layout, lengths, rate))
    for D in (32, 128):  # the other head dims that have an instantiation of their own
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((8, T, 4, D, dtype, "native", lengths[:8], 0.15))
    for D, H in NEW_HEAD_DIMS:  # ragged with a 0-length row, both rates, two layouts
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.15):
                for layout in ("native", "fused_qkv"):
                    cases.append((8, T, H, D, dtype, layout, lengths[:8], rate))
    cases.append((4, T, 3, 45, torch.bfloat16, "native", lengths[:4], 0.15))
    pds_lengths = np.array([500, 0, 377, 131, 500, 1, 263, 499])  # a PDS stage 0 (D = 50)
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((8, 500, 4, 50, dtype, "native", pds_lengths, 0.1))
    long_lengths = np.array([1000, 0, 731, 402])
    for dtype in (torch.float32, torch.bfloat16):
        cases.append((4, 1000, 8, 64, dtype, "native", long_lengths, 0.15))
    # rows whose probability sits on one key, where dS = P (dP o Z - Delta) must cancel:
    # a length-1 row (all of P on key 0) at D=32, and Q = 8 K at D=64 (each query's own key)
    cases.append((2, 100, 4, 32, torch.bfloat16, "native", np.array([1, 100]), 0.15))
    cases.append((4, T, 8, 64, torch.bfloat16, "native", np.full(4, T), 0.15, 8.0))
    results = []
    for i, c in enumerate(cases):
        r = grad_case(*c[:8], seed=100 + i, q_from_k=c[8] if len(c) > 8 else 0.0)
        results.append(r)
        log(f"[grad] B={r['B']} T={r['T']} H={r['H']} D={r['D']} {r['dtype']:<8} {r['layout']:<10} "
            f"p={r['dropout']:<4} rel err out {r['out_rel_err']:.2e} dq {r['dq_rel_err']:.2e} "
            f"dk {r['dk_rel_err']:.2e} dv {r['dv_rel_err']:.2e} (rtol {r['rtol']}; max abs "
            f"{r['grad_max_abs_err']:.2e}) lse {r['lse_err']:.2e} (atol {LSE_ATOL}); smallest "
            f"top-key share {r['peak_share']:.4f}")
        check_grad_case(r)
    if not results[-1]["peak_share"] >= PEAK_SHARE:
        raise AssertionError(f"the peaked case's rows are not peaked: {results[-1]}")
    # the kept share of the kernel's dropout mask over a large tensor (the training
    # shape): with Q = K = 0 every probability is 1/T, and with V = 1 each output is
    # (kept keys / T) / (1 - k/256); the plain version's mask gives the same share
    k_u8, (B, T, H, D) = 38, (40, 250, 8, 64)  # k = round(0.15 * 256)
    zeros = torch.zeros((B, T, H, D), device="cuda")
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    dseed = torch.tensor([20241016], device="cuda")
    out = fused_attention_fwd(zeros, zeros, torch.ones_like(zeros), lens, k_u8, dseed)[0]
    share = out.mean().item() * (1 - k_u8 / 256)
    plain_share = keep_mask(dseed, B, H, T, k_u8).float().mean().item()
    log(f"[grad] kept share at p=0.15 over {B}x{H}x{T}x{T}: kernel {share:.6f}, plain "
        f"{plain_share:.6f} (1 - k/256 = {1 - k_u8 / 256:.6f}, tolerance {KEPT_SHARE_TOL})")
    if not (abs(share - (1 - k_u8 / 256)) <= KEPT_SHARE_TOL and abs(share - plain_share) < 1e-5):
        raise AssertionError("the dropout mask keeps the wrong share")
    # the training shape of s2t_transformer_m: bf16, B=40, T'=250, H=8, D=64, p=0.1
    main = grad_case(40, 250, 8, 64, torch.bfloat16, "native", [250] * 40, 0.1,
                     seed=99, time_it=True)
    log(f"[grad] training shape {json.dumps(main)}")
    check_grad_case(main)
    by_dim = {}  # the same shape at the new head dims, for the table beside D = 64
    for D, _ in NEW_HEAD_DIMS:
        r = by_dim[D] = grad_case(40, 250, 8, D, torch.bfloat16, "native", [250] * 40, 0.1,
                                  seed=99 + D, time_it=True)
        check_grad_case(r)
        log(f"[grad] training shape at D={D}: K1b device_ms {r['device_ms']:.4f} (D=64: "
            f"{main['device_ms']:.4f}), K1f with lse {r['fwd_device_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f}, SDPA backward device {r['library_device_ms']:.4f}")
    # the stage-0 training shape of pdss2t_transformer_m_8: bf16, B=40, T'=500, H=8, p=0.1
    pds0 = grad_case(40, 500, 8, 64, torch.bfloat16, "native", [500] * 40, 0.1, seed=98,
                     time_it=True)
    log(f"[grad] PDS stage-0 training shape {json.dumps(pds0)}")
    check_grad_case(pds0)
    return results, share, main, by_dim, pds0


def ctc_bounds(B, T, S, lengths, chain_ms):
    """Least time of K3 and K4: the larger of their bytes at the memory rate (K3 reads
    emit for the frames below each length and writes every alpha row; K4 reads emit and
    alphas for those frames and writes every gradient row) and their chain floor
    (``chain_ms``, K3's and K4's: a row's dependent steps, K3's two shuffles, two
    logaddexp and an add, K4's its gradient entry's expf, an add, two shuffles and two
    logaddexp, run by one warp on register values alone on the card, measured in phase
    4).  K3's floor is its own single-warp step at ceil(S / 32) states a lane; K4's is
    its own design's dependent step, one state a lane (``K4_FLOOR_STATES``) without the
    exchange between warps: each floor bounds the design it measures, shuffle latency
    and validity selects included.
    Returns {kernel: (ms, "bytes" or "operations", {"bytes_ms", "chain_ms"})}; the
    operations that bound a chain are its dependent ones."""
    used = sum(min(int(n), T) for n in lengths)
    k3 = (4 * S * (used + B * T) + 4 * B * S + 4 * B) / HBM_BYTES_PER_S * 1e3
    k4 = (4 * S * (2 * used + B * T) + 2 * 4 * B * S + 8 * B) / HBM_BYTES_PER_S * 1e3
    return {name: (max(b_ms, c_ms), "bytes" if b_ms >= c_ms else "operations",
                   {"bytes_ms": b_ms, "chain_ms": c_ms})
            for name, b_ms, c_ms in (("ctc_alpha", k3, chain_ms[0]),
                                     ("ctc_beta_grad", k4, chain_ms[1]))}


# K4 runs one state a lane (ceil(S / 32) warps a row; one thread a state in the CTA-wide
# kernel past 1024 states): its dependent step is the beta step at one state a lane, the
# single-warp floor kernel over 32 states
K4_FLOOR_STATES = 32


def beta_grad_cta(emit, alphas, skip, final, lengths, logz):
    """K4's CTA-wide kernel (``ctc_beta_grad_kernel``) at any S, which the main path runs
    only past ``BETA_WARPS_MAX_S``: timed beside the warps kernel on the same inputs, it
    is the design that kernel replaced.  No wrapper launch, no count."""
    lib = _build.load_library("ctc_lattice", CTC_SIGNATURES)
    T, B, S = emit.shape
    demit = torch.empty_like(emit)
    rc = lib.s2t_ctc_beta_grad(emit.data_ptr(), alphas.data_ptr(), skip.data_ptr(),
                               final.data_ptr(), lengths.data_ptr(), logz.data_ptr(),
                               demit.data_ptr(), T, B, S, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"s2t_ctc_beta_grad launch failed (cudaError {rc})")
    return demit


def ctc_case(B, T, U, V, seed, time_it=False):
    """K3 and K4 against their plain versions on seeded ragged rows, K4's device ms
    beside its CTA-wide kernel's on the same inputs (``beta_grad_cta``); ``time_it``
    also times them beside ``ctc_loss`` and bounds them (``ctc_bounds``)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(3, V, size=(B, U))
    labels[0, 1::2] = labels[0, 0::2][: U // 2]  # repeated labels
    labels[1] = 5  # U repeats need 2U - 1 frames: infeasible in U + 1
    label_lengths = rng.integers(U // 2, U + 1, size=B)
    input_lengths = rng.integers(max(T // 2, U + 2), T + 1, size=B)
    label_lengths[:2] = U
    input_lengths[0], input_lengths[1], input_lengths[-1] = T, U + 1, 0
    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn(B, T, V, generator=g, device="cuda")
    labels_t = torch.as_tensor(labels, device="cuda")
    ext = _extend_labels(labels_t, 0)
    S = ext.shape[1]
    emit = _lattice_logp(logits, ext, normalized=False).transpose(0, 1).contiguous()
    skip = torch.where(_transition_mask(ext, 0), 0.0, NEG_INF).float().contiguous()
    lens = torch.as_tensor(input_lengths, dtype=torch.int32, device="cuda")
    ll = torch.as_tensor(label_lengths, device="cuda")
    state = torch.arange(S, device="cuda")[None, :]
    final = torch.where((state == 2 * ll[:, None] - 1) | (state == 2 * ll[:, None]),
                        0.0, NEG_INF).float().contiguous()
    alphas = ctc_alpha(emit, skip, lens)
    alphas_p = ctc_alpha_plain(emit, skip, lens)

    def logz(a):
        last = a[-1]
        a_label = torch.where(ll > 0, last.gather(1, (2 * ll - 1).clamp(min=0)[:, None])[:, 0],
                              NEG_INF)
        return torch.logaddexp(a_label, last.gather(1, (2 * ll)[:, None])[:, 0])

    lz, lz_p = logz(alphas), logz(alphas_p)
    demit = ctc_beta_grad(emit, alphas_p, skip, final, lens, lz_p.contiguous())
    demit_p = ctc_beta_grad_plain(emit, alphas_p, skip, final, lens, lz_p)
    torch.cuda.synchronize()
    reach = alphas_p > -1e29
    feasible = torch.as_tensor((input_lengths >= 2 * label_lengths - 1) & (input_lengths > 0),
                               device="cuda") & (lz_p > -1e29)
    res = {"B": B, "T": T, "S": S, "beta_kernel": beta_grad_kernel(S),
           "alpha_err": (alphas - alphas_p)[reach].abs().max().item(),
           "unreached_agree": bool(torch.equal(alphas > -1e29, reach)),
           "nll_err": (lz - lz_p)[feasible].abs().max().item(),
           "demit_err": (demit - demit_p).abs().max().item(), "atol": CTC_ATOL}
    lz_c = lz_p.contiguous()
    res["beta_device_ms"] = device_ms(
        lambda: ctc_beta_grad(emit, alphas_p, skip, final, lens, lz_c), BETA_KERNELS)[0]
    res["beta_cta_device_ms"] = device_ms(
        lambda: beta_grad_cta(emit, alphas_p, skip, final, lens, lz_c), BETA_KERNELS)[0]
    if U > 2:  # row 1's U repeats need 2U - 1 frames and get U + 1 (with U <= 2 they fit)
        res["infeasible_nll_over_5e29"] = bool((-lz_p[1]).item() > 5e29)
    if time_it:
        def alpha():
            return ctc_alpha(emit, skip, lens)

        def beta():
            return ctc_beta_grad(emit, alphas, skip, final, lens, lz)

        res["alpha_ms"] = cuda_ms(alpha)
        res["alpha_device_ms"] = device_ms(alpha, ALPHA_KERNELS)[0]
        res["alpha_plain_ms"] = cuda_ms(lambda: ctc_alpha_plain(emit, skip, lens), iters=3, warmup=1)
        res["beta_ms"] = cuda_ms(beta)
        res["beta_plain_ms"] = cuda_ms(
            lambda: ctc_beta_grad_plain(emit, alphas, skip, final, lens, lz), iters=3, warmup=1)
        lp = torch.log_softmax(logits, dim=-1).transpose(0, 1).detach().requires_grad_()
        args = (labels_t, lens.clamp(min=1).long(), ll)  # the library refuses 0 frames

        def lib():
            return torch.nn.functional.ctc_loss(lp, *args, reduction="sum", zero_infinity=True)

        res["library_fwd_ms"] = cuda_ms(lib)
        res["library_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(lib(), lp))
        res["library_bwd_ms"] = res["library_fwd_bwd_ms"] - res["library_fwd_ms"]
        res["library_fwd_device_ms"] = device_ms(lib)[0]
        loss = lib()
        res["library_bwd_device_ms"] = device_ms(
            lambda: torch.autograd.grad(loss, lp, retain_graph=True))[0]
        # K3 runs max(length) - 1 dependent alpha steps, K4 max(length) beta steps, each
        # with its gradient entry: each floor is its own step's chain
        longest = int(min(input_lengths.max(), T))
        res["chain_steps"] = longest - 1
        floors = [device_ms(lambda: ctc_chain_floor(n, states, "cuda", beta=beta),
                            ("ctc_chain_floor_kernel",))[0]
                  for n, states, beta in ((longest, S, False),
                                          (longest + 1, K4_FLOOR_STATES, True))]
        bounds = ctc_bounds(B, T, S, input_lengths, floors)
        for pre, name in (("alpha", "ctc_alpha"), ("beta", "ctc_beta_grad")):
            res[f"{pre}_bound_ms"], res[f"{pre}_bound_by"], res[f"{pre}_bound_parts"] = bounds[name]
    return res


def phase_ctc():
    # U = 191 (S = 383) before any wider lattice: the multi-warp K4 needs more than the
    # default 48 KB of shared memory there, with its opt-in not yet set by a wider launch
    cases = [ctc_case(40, 250, 29, 10000, seed=7, time_it=True),  # the training shape
             ctc_case(8, 400, 191, 10000, seed=9),
             ctc_case(8, 1000, 200, 10000, seed=8)]
    # T >= 2U + 2, so the widest rows are feasible
    cases += [ctc_case(8, max(300, 2 * U + 2), U, 10000, seed=20 + i)
              for i, U in enumerate(CTC_WIDTHS)]
    for r in cases:
        log(f"[ctc] {json.dumps(r)}")
        if not (r["alpha_err"] <= CTC_ATOL["alpha"] and r["nll_err"] <= CTC_ATOL["alpha"]
                and r["demit_err"] <= CTC_ATOL["demit"] and r["unreached_agree"]
                and r.get("infeasible_nll_over_5e29", True)):
            raise AssertionError(f"CTC kernels disagree with their plain versions: {r}")
    main = cases[0]
    vs_cta = {r["S"]: round(r["beta_device_ms"] / r["beta_cta_device_ms"], 3) for r in cases}
    log(f"[ctc] K3 at the training shape: device {main['alpha_device_ms']:.4f} ms, bound "
        f"{main['alpha_bound_ms']:.4f} "
        f"({main['alpha_bound_by']}: {json.dumps(main['alpha_bound_parts'])}), "
        f"{main['chain_steps']} steps; K4 device {main['beta_device_ms']:.4f} ms "
        f"({main['beta_kernel']}; the CTA-wide kernel {main['beta_cta_device_ms']:.4f}), bound "
        f"{main['beta_bound_ms']:.4f} ({main['beta_bound_by']}: its own beta step's chain), "
        f"bound / device {main['beta_bound_ms'] / main['beta_device_ms']:.3f}; K4 / CTA-wide "
        f"kernel by S {json.dumps(vs_cta)}")
    return cases


# --------------------------------------------------------------------------- #
def rescore(model, gen, features, lengths, tokens):
    """Cumulative log-prob of each hypothesis prefix under teacher forcing:
    the same scores the beam accumulates (its bans never touch a chosen token)."""
    dev = model.device
    with torch.inference_mode():
        enc = model.encode(features.to(dev), lengths.to(dev))
        hyp = torch.as_tensor(tokens, device=dev)[None]
        prev = torch.cat([torch.full((1, 1), gen.eos_id, device=dev), hyp[:, :-1]], dim=1)
        mask = torch.arange(enc["encoder_out"].shape[1], device=dev)[None] < enc["encoder_lengths"][:, None]
        lp = torch.log_softmax(model.decode(prev, enc["encoder_out"], mask).float(), dim=-1)
        return lp[0].gather(-1, hyp[0, :, None])[:, 0].cumsum(0).cpu()


def phase_serve_parity(cfg=None, tag="serve"):
    """fp32 serving of the fixture wavs on the card and on the CPU from the same
    seeded weights (``cfg``: s2t_transformer_s by default).  Returns the encodes."""
    cfg = cfg or s2t_transformer_s(vocab_size=10000, max_target_positions=1024)
    layers = encoder_layers(cfg)
    card = GeneratorHub.build(cfg, device="cuda", seed=0, **GEN_SHORT)
    host = GeneratorHub.build(cfg, device="cpu", seed=0, **GEN_SHORT)
    batch = card._speech_batch(WAVS)
    feats = torch.from_numpy(batch["features"])
    lens = torch.from_numpy(batch["feat_lengths"]).long()
    with torch.inference_mode():
        before = fused_attention.launches
        enc_card = card.model.encode(feats.cuda(), lens.cuda())
        torch.cuda.synchronize()
        if fused_attention.launches - before != layers:
            raise AssertionError(f"encode launched the kernel {fused_attention.launches - before}"
                                 f" times, expected {layers}")
        enc_host = host.model.encode(feats, lens)
    enc_err = (enc_card["encoder_out"].cpu() - enc_host["encoder_out"]).abs().max().item()
    log(f"[{tag}] fp32 encoder_out {tuple(enc_host['encoder_out'].shape)} card vs CPU "
        f"max_abs_err={enc_err:.3e} (atol {ENC_ATOL})")
    if not enc_err <= ENC_ATOL:
        raise AssertionError("encoder outputs disagree between the card and the CPU")
    if not torch.equal(enc_card["encoder_lengths"].cpu(), enc_host["encoder_lengths"]):
        raise AssertionError("encoder lengths disagree between the card and the CPU")

    fused_attention.launches = 0  # the main path starts here
    t0 = time.perf_counter()
    tok_card = card.generate(WAVS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    encodes = 1
    if fused_attention.launches != layers * encodes:
        raise AssertionError(f"serving launched the kernel {fused_attention.launches} times")
    t0 = time.perf_counter()
    tok_host = host.generate(WAVS)
    host_s = time.perf_counter() - t0
    log(f"[{tag}] 4 requests, beam 5: card {card_s:.3f} s, CPU {host_s:.3f} s; "
        f"lengths {[len(t) for t in tok_card]}")
    for b, (a, c) in enumerate(zip(tok_card, tok_host)):
        if np.array_equal(a, c):
            continue
        n = min(len(a), len(c))
        step = int(np.flatnonzero(a[:n] != c[:n])[0]) if (a[:n] != c[:n]).any() else n
        hyp_a = np.append(a, card.generator.eos_id)[: step + 1]
        hyp_c = np.append(c, card.generator.eos_id)[: step + 1]
        gaps = []
        for name, hub in (("card", card), ("cpu", host)):
            sa = rescore(hub.model, hub.generator, feats[b:b + 1], lens[b:b + 1], hyp_a)[-1].item()
            sc = rescore(hub.model, hub.generator, feats[b:b + 1], lens[b:b + 1], hyp_c)[-1].item()
            gaps.append(abs(sa - sc))
            if name == "card":
                encodes += 2  # each rescore encodes once on the card
            log(f"[{tag}] request {b} diverges at step {step}: on {name} candidate "
                f"{hyp_a[-1]} scores {sa:.6f}, candidate {hyp_c[-1]} scores {sc:.6f}")
        if not max(gaps) <= ENC_ATOL:
            raise AssertionError(f"request {b}: tokens differ and the gap {max(gaps):.3e} "
                                 f"is no near-tie (tolerance {ENC_ATOL})")
        log(f"[{tag}] request {b}: near-tie (gap {max(gaps):.3e} <= {ENC_ATOL}), accepted")
    if all(np.array_equal(a, c) for a, c in zip(tok_card, tok_host)):
        log(f"[{tag}] top-beam tokens identical on the card and the CPU")
    return encodes


def synced_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_profile(fn, kernels=(), sequence=()):
    """Run ``fn`` once under torch.profiler: device busy ms (union of the
    kernel and copy intervals), the aten ops with the most device time, the
    device ms of the CUDA kernels whose names contain each of ``kernels``, the
    device ms of each kernel whose name contains one of ``sequence``, in launch
    order, the device ms of the kernels each ``stage_ranges`` range launched, the
    span of each on the device timeline and its host ms, and the synchronised wall
    ms of the call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels and copies; the device-side copies of the ranges span idle gaps
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(RANGE_PREFIXES))
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy_us, start, end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy_us += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy_us += end - start
    averages = prof.key_averages()
    ops = sorted(((a.key, a.self_device_time_total / 1e3) for a in averages
                  if a.key.startswith("aten::") and a.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    kernel_ms = {name: sum(a.self_device_time_total for a in averages if name in a.key) / 1e3
                 for name in kernels}
    # the ranges of stage_ranges and module_ranges: the host range's device_time_total sums
    # the kernels launched inside it (over every entry of a range of that name); the
    # trace's device-side range of the same name spans the device timeline from its first
    # kernel to its last, idle gaps included
    range_ms, range_span_ms, range_host_ms = {}, {}, {}
    for e in prof.events():
        if e.name.startswith(RANGE_PREFIXES):
            if e.device_type == torch.autograd.DeviceType.CPU:
                range_ms[e.name] = range_ms.get(e.name, 0.0) + e.device_time_total / 1e3
                range_host_ms[e.name] = range_host_ms.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3
            else:
                range_span_ms[e.name] = range_span_ms.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3
    device = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    sequence_ms = {name: [(e.time_range.end - e.time_range.start) / 1e3 for e in device
                          if name in e.name] for name in sequence}
    return {"busy_ms": busy_us / 1e3, "top_ops": ops[:8], "kernel_ms": kernel_ms,
            "sequence_ms": sequence_ms, "range_ms": range_ms, "range_span_ms": range_span_ms,
            "range_host_ms": range_host_ms, "wall_ms": wall_ms}


def by_stage(sequence_ms, cfg, names, backward=False):
    """Device ms of a PDS encoder's attention launches summed by stage (and its final
    layers), from ``device_profile``'s launch-ordered kernels: each launch is one
    kernel of each of ``names``; the forward runs stage 0 first, the backward the
    last stage first.  None (logged) when the trace lost a kernel."""
    lists = [sequence_ms[n] for n in names]
    counts = [*cfg.pds_layers, *([cfg.pds_final_layers] if cfg.pds_final_layers else [])]
    if any(len(v) != sum(counts) for v in lists):
        log(f"[profiler] {names}: {[len(v) for v in lists]} kernels in the trace, expected "
            f"{sum(counts)} each: no split by stage")
        return None
    per_launch = [sum(v) for v in zip(*lists)]
    if backward:
        per_launch = per_launch[::-1]
    out, i = {}, 0
    for k, n in enumerate(counts):
        out[f"stage{k}" if k < cfg.pds_stages else "final"] = sum(per_launch[i:i + n])
        i += n
    return out


RANGE_PREFIXES = ("pds_", "sate_", "conformer_", "stack_", "variant_",  # the ranges below
                  "joint_ctc_", "generator_", "w2v_", "dual_", "mb_")


@contextlib.contextmanager
def module_ranges(named_modules):
    """Run the forward of each module of ``named_modules`` ((name, module) pairs; a name
    may repeat, and its ranges then sum) inside a torch.profiler range of that name,
    opened by a forward pre-hook and closed by a forward hook."""
    from torch.profiler import record_function

    hooks = []
    for name, module in named_modules:
        opened = []

        def enter(*_, name=name, opened=opened):
            opened.append(record_function(name))
            opened[-1].__enter__()

        def leave(*_, opened=opened):
            opened.pop().__exit__(None, None, None)

        hooks += [module.register_forward_pre_hook(enter), module.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def sate_ranges(model):
    """SATE's encode split: the acoustic encoder (with its CTC head), the adapter, the
    textual encoder, and inside it every layer's self-attention and CTC-Aug's
    s2-attention (each name sums over the layers)."""
    enc = model.encoder
    parts = [("sate_acoustic", enc.acoustic), ("sate_textual", enc.textual)]
    if enc.adapter is not None:
        parts.append(("sate_adapter", enc.adapter))
    for layer in enc.textual.layers:
        parts.append(("sate_text_self_attn", layer.self_attn))
        if getattr(layer, "s2_attn", None) is not None:
            parts.append(("sate_text_s2_attn", layer.s2_attn))
    return module_ranges(parts)


def conformer_parts(enc):
    """A Conformer encode: the whole encoder, and every layer's self-attention and conv
    module (each name sums over the layers)."""
    return ([("conformer_encoder", enc)]
            + [("conformer_attention", layer.self_attn) for layer in enc.layers]
            + [("conformer_conv_module", layer.conv_module) for layer in enc.layers])


def stack_parts(enc):
    """The CTC research stack's split of an encode: the whole encoder, its layers, the
    PAE adapters (CTC and XCTC), the CTC heads (the final one, which the shared inter taps
    call too, and any per-tap ones) and the XCTC / AXCTC heads; each name sums its calls."""
    parts = [("stack_encoder", enc)] + [("stack_layers", layer) for layer in enc.layers]
    parts += [("stack_pae", m) for m in (enc.pae, enc.xpae) if m is not None]
    heads = [enc.ctc_head] + list((enc.inter_ctc_heads or {}).values())
    parts += [("stack_ctc_heads", m) for m in heads if m is not None]
    parts += [("stack_xctc_heads", m) for m in (enc.xctc_head, enc.axctc_head) if m is not None]
    return parts


def encoder_ranges(model):
    """The ranges of ``model``'s encoder: PDS stages, SATE parts, Conformer sublayers, the
    CTC research stack's parts, or none."""
    cfg = model.cfg
    if hasattr(cfg, "encoder_league_s1_ratio"):  # the dual and multibranch models
        return module_ranges(league_parts(model))
    if isinstance(cfg, PDSConfig):
        return stage_ranges(model.encoder)
    if isinstance(cfg, SATEConfig):
        return sate_ranges(model)
    if not isinstance(cfg, S2TTransformerConfig):  # Berard, the Emformer: no split
        return contextlib.nullcontext()
    parts = []
    if cfg.use_cnn_module and cfg.encoder_attention_type == "rel_pos":
        parts += conformer_parts(model.encoder)
    if cfg.inter_ctc_layers or cfg.use_xctc or cfg.use_axctc:
        # one whole-encoder range: two on one module would close out of order
        parts += stack_parts(model.encoder)[1 if parts else 0:]
    return module_ranges(parts) if parts else contextlib.nullcontext()


@contextlib.contextmanager
def stage_ranges(encoder):
    """Run each PDS stage (its downsampler through its last layer) and the tail (fusion,
    final layers, final norm, CTC head) of ``encoder``'s forward inside a torch.profiler
    range, ``pds_stage<i>`` / ``pds_tail``, opened and closed by forward hooks; a
    profile's ``range_ms`` then holds the device ms of each range's kernels."""
    from torch.profiler import record_function

    open_ranges = []

    def enter(name):
        def hook(*_):
            open_ranges.append(record_function(name))
            open_ranges[-1].__enter__()
        return hook

    def leave(*_):
        open_ranges.pop().__exit__(None, None, None)

    hooks = []
    for i, (down, layers) in enumerate(zip(encoder.downsamplers, encoder.stages)):
        hooks += [down.register_forward_pre_hook(enter(f"pds_stage{i}")),
                  layers[-1].register_forward_hook(leave)]
    hooks += [encoder.stages[-1][-1].register_forward_hook(enter("pds_tail")),
              encoder.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


SERVE_TIMED = 1  # timed bf16 serving batches of phases 6, 16, 19, 21, 25 (after a warm-up)


def phase_speed(cfg=None, tag="speed", n_timed: int = SERVE_TIMED, B: int = 64,
                seconds: float = 10.0):
    """bf16 serving of B synthetic waveforms of ``seconds`` each, beam 5 (``cfg``:
    s2t_transformer_s by default); for a PDS, SATE or Conformer model also the device ms
    of each stage or part of one encode (``encoder_ranges``).  Returns (encodes, results)."""
    from s2t_tpu_torch.inference.generator import SequenceGenerator

    cfg = cfg or s2t_transformer_s(vocab_size=10000, max_target_positions=1024,
                                   dtype_str="bfloat16")
    hub = GeneratorHub.build(cfg, device="cuda", seed=0, **GEN)
    rng = np.random.default_rng(0)
    waves = [list((rng.normal(size=(B, int(16000 * seconds))) * 3000.0).astype(np.float32))
             for _ in range(n_timed + 1)]
    out = hub.generate(waves[0])  # warm-up: cuBLAS/cuDNN plans, allocator
    encodes = 1
    walls = []
    for w in waves[1:]:
        walls.append(synced_s(lambda: out.extend(hub.generate(w))))
        encodes += 1
    if len(out) != B * (n_timed + 1):
        raise AssertionError("wrong number of answers")
    # where the time goes, on the last batch: host features, encoder, encoder + beam
    t0 = time.perf_counter()
    batch = hub._speech_batch(waves[-1])
    fbank_s = time.perf_counter() - t0
    feats = torch.from_numpy(batch["features"]).cuda()
    lens = torch.from_numpy(batch["feat_lengths"]).long().cuda()
    with torch.inference_mode():
        enc = {}
        encode_s = synced_s(lambda: enc.update(hub.model.encode(feats, lens)))
    if not torch.isfinite(enc["encoder_out"]).all():
        raise AssertionError("non-finite encoder output")
    beam_s = synced_s(lambda: hub.generator.generate(batch))
    encodes += 2
    wall = float(np.median(walls))
    # no profiled decode: its busy share and the encode's device ms by stage or part are
    # in PERF.md
    res = {"batch": B, "audio_s_per_request": seconds, "wall_s": walls,
           "utt_per_s": B / wall, "rtf": B * seconds / wall,
           "host_fbank_s": fbank_s, "encode_s": encode_s, "encode_plus_beam_s": beam_s}
    log(f"[{tag}] bf16 untuned first measurement: {json.dumps(res)}")
    return encodes, res


# --------------------------------------------------------------------------- #
CRITERION = ("label_smoothed_cross_entropy_with_ctc", {"ctc": {"ctc_weight": 0.3}})
KERNEL_NAMES = ("attention_fwd_mma_kernel", "delta_bf16_kernel", "dkdv_mma_kernel",
                "dq_mma_kernel", *ALPHA_KERNELS, *BETA_KERNELS)  # the bf16 path


def train_batch(rng, B, T, U, V, lengths):
    """A seeded batch as bench.py section B makes it (transcript = target[:, :-1]),
    with the target lengths the collater gives (the PAE oracle reads them)."""
    targets = rng.integers(4, V, size=(B, U)).astype(np.int32)
    targets[:, -1] = 2
    prev = np.roll(targets, 1, axis=1)
    prev[:, 0] = 2
    return {
        "features": rng.normal(size=(B, T, 80)).astype(np.float32),
        "feat_lengths": np.asarray(lengths, np.int32),
        "prev_tokens": prev,
        "target": targets,
        "target_lengths": np.full((B,), U, np.int32),
        "transcript": targets[:, :-1],
        "transcript_lengths": np.full((B,), U - 1, np.int32),
        "ntokens": np.float32(B * U),
    }


def stack_forward(model, batch, train=False, generator=None):
    """The trainer's forward adapter with the task's encoder inputs (the PAE oracle's
    transcript and EOS-stripped target, mixup's step count) threaded as
    ``SpeechToTextTask.forward_fn`` threads them."""
    from s2t_tpu_torch.tasks.speech_to_text import encoder_inputs

    return model(batch["features"], batch["feat_lengths"], batch["prev_tokens"], train=train,
                 generator=generator, **encoder_inputs(model.cfg, batch, train))


@contextlib.contextmanager
def ctc_term_ranges():
    """Run each CTC term of the CTC criterion (one ``_one_ctc`` call: the emission
    gather, the normaliser and K3, twice under mixup) inside a profiler range
    ``stack_ctc_term<i>``, i counting the calls in order."""
    from torch.profiler import record_function

    from s2t_tpu_torch.criterions.ctc import CTCCriterion

    plain, calls = CTCCriterion._one_ctc, [0]

    def ranged(self, *args, **kw):
        calls[0] += 1
        with record_function(f"stack_ctc_term{calls[0]}"):
            return plain(self, *args, **kw)

    CTCCriterion._one_ctc = ranged
    try:
        yield
    finally:
        CTCCriterion._one_ctc = plain


@contextlib.contextmanager
def viterbi_ranges():
    """Run each call of the PAE oracle's Viterbi (``ctc_best_alignment`` as
    ``modules/adapter.py`` calls it) inside a profiler range ``stack_viterbi``."""
    from torch.profiler import record_function

    from s2t_tpu_torch.modules import adapter

    plain = adapter.ctc_best_alignment

    def ranged(*args, **kw):
        with record_function("stack_viterbi"):
            return plain(*args, **kw)

    adapter.ctc_best_alignment = ranged
    try:
        yield
    finally:
        adapter.ctc_best_alignment = plain


@contextlib.contextmanager
def viterbi_calls():
    """Count the PAE oracle's Viterbi calls (``ctc_best_alignment`` as
    ``modules/adapter.py`` calls it): {"calls": n}."""
    from s2t_tpu_torch.modules import adapter

    plain, seen = adapter.ctc_best_alignment, {"calls": 0}

    def counted(*args, **kw):
        seen["calls"] += 1
        return plain(*args, **kw)

    adapter.ctc_best_alignment = counted
    try:
        yield seen
    finally:
        adapter.ctc_best_alignment = plain


def check_step_launches(counts, steps=1, per_step=None):
    per_step = per_step or TRAIN_LAUNCHES
    want = {**{k: 0 for k in counters()}, **{k: n * steps for k, n in per_step.items()}}
    if counts != want:
        raise AssertionError(f"{steps} training step(s) launched {counts}, expected {want}")


def seeded_pair(build):
    """{"cuda": ..., "cpu": build("cpu")}: one seeded build for both sides of a card-vs-CPU
    check, the card's a copy moved there.  A build samples its weights on the CPU whatever
    its device, so the copy holds what build("cuda") would, without sampling them again."""
    host = build("cpu")
    return {"cuda": copy.deepcopy(host).to("cuda"), "cpu": host}


def make_criterion(criterion):
    """A criterion from (name, cfg), or a built one (a callable)."""
    return criterion if callable(criterion) else build_criterion(*criterion)


def nested_to(batch, device):
    """Every array of a batch, nested dicts too (a zip batch's pairs, handed-over draws),
    as a tensor on ``device``."""
    return {k: nested_to(v, device) if isinstance(v, dict) else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


def phase_train_parity(cfg=None, model_cls=S2TTransformerModel, tag="train", steps: int = 2,
                       criterion=CRITERION, per_step=None, U: int = 30, log_keys=(),
                       batches=None, forward_fn=None, opt=None, prepare=None):
    """fp32, dropout 0: the port's Trainer on the card and on the CPU from the same
    seeded weights and batches (``cfg``: s2t_transformer_m cut by ``shallow`` by default,
    ``step_launches`` of it a step; another model, ``step_launches`` or ``per_step``), through ``stack_forward`` (the task's encoder inputs: the PAE
    oracle's targets).  ``log_keys``: more CTC terms, reported every step and held
    at ctc_loss's rtol on the first (the same weights on both devices; later
    steps start from parameters Adam has moved apart by up to 2 lr).  ``batches``,
    ``forward_fn`` and ``opt`` replace the seeded feature batches, ``stack_forward`` and
    the inverse_sqrt optimizer (the wav2vec 2.0 family's waveform batches); a model
    without a CTC loss is held on the rest.  ``prepare(model)`` edits both devices'
    seeded weights alike before the first step."""
    cfg = cfg or shallow(s2t_transformer_m(vocab_size=10000, max_target_positions=1024,
                                           dropout=0.0, attention_dropout=0.0,
                                           activation_dropout=0.0))
    per_step = per_step or step_launches(cfg)
    first_rtol = {k: TRAIN_RTOL["ctc_loss"] for k in log_keys}
    opt = opt or OptimizationConfig(lr=2e-3, warmup_updates=3, clip_norm=10.0, adam_eps=1e-6)
    if batches is None:
        rng = np.random.default_rng(0)
        batches = [train_batch(rng, 4, 1000, U, 10000, [1000, 873, 640, 412])
                   for _ in range(steps)]
    steps = len(batches)
    runs, launches = {}, {k: 0 for k in per_step}
    models = seeded_pair(lambda d: model_cls(cfg, device=d, seed=0, for_training=True))
    for device in ("cuda", "cpu"):
        model = models[device]
        if prepare is not None:
            prepare(model)
        trainer = Trainer(model, make_criterion(criterion), opt, device=device, seed=1,
                          forward_fn=forward_fn or stack_forward)
        metrics, t0 = [], time.perf_counter()
        for batch in batches:
            reset_counts()  # the main path: one training step on the card
            m = trainer.train_step(batch)
            if device == "cuda":
                torch.cuda.synchronize()
                counts = read_counts()
                check_step_launches(counts, per_step=per_step)
                launches = {k: launches[k] + counts[k] for k in launches}
            metrics.append({k: float(m[k]) for k in ("loss", "ctc_loss", "gnorm", "lr",
                                                     *log_keys) if k in m})
        secs = time.perf_counter() - t0
        runs[device] = (metrics, {n: p.detach().cpu() for n, p in model.named_parameters()})
        log(f"[{tag}] fp32 {device}: {steps} steps in {secs:.2f} s: {json.dumps(metrics)}")
    (card, card_p), (host, host_p) = runs["cuda"], runs["cpu"]
    errs = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in (*TRAIN_RTOL, *log_keys) if k in b}
            for a, b in zip(card, host)]
    diffs = {n: (card_p[n] - host_p[n]).abs() for n in host_p}
    worst = sorted(diffs, key=lambda n: -diffs[n].max().item())[:3]
    param_err = diffs[worst[0]].max().item()
    n_params = sum(d.numel() for d in diffs.values())
    over = sum(int((d > 1e-5).sum()) for d in diffs.values())
    # Adam's first updates are ~lr * sign(g): an entry whose gradient is near 0 and
    # flips sign between the devices (float32 noise, or a ReLU input within rounding
    # of 0 that passes on one device and not the other) moves up to 2 lr apart per step
    param_bound = 2 * sum(m["lr"] for m in host)
    res = {"steps": steps, "card": card, "cpu": host, "rel_err": errs, "rtol": TRAIN_RTOL,
           "first_step_rtol": first_rtol,
           "max_param_diff": param_err, "param_bound": param_bound,
           "worst_params": {n: diffs[n].max().item() for n in worst},
           "share_of_entries_over_1e-5": over / n_params,
           "launches_per_step": per_step}
    log(f"[{tag}] fp32 card vs CPU: rel err per step {json.dumps(errs)} (rtol {TRAIN_RTOL}; "
        f"first step {first_rtol}); "
        f"max param difference after {steps} steps {param_err:.3e} (bound 2 sum(lr) = "
        f"{param_bound:.3e}; worst {json.dumps(res['worst_params'])}, {over} of {n_params} "
        f"entries differ by more than 1e-5); launches per step {per_step}")
    if any(not e[k] <= TRAIN_RTOL[k] for e in errs for k in TRAIN_RTOL if k in e) or \
            any(not errs[0][k] <= r for k, r in first_rtol.items()) or \
            not param_err <= param_bound:
        raise AssertionError("fp32 training disagrees between the card and the CPU")
    return res, launches


def phase_train_speed(cfg=None, model_cls=S2TTransformerModel, tag="train speed",
                      n_timed: int = 20, B: int = 40, T: int = 1000, U: int = 30, V: int = 10000,
                      criterion=CRITERION, per_step=None, batch=None, forward_fn=None, opt=None,
                      profile=None):
    """bf16 at the bench.py section B shape and optimizer (``cfg``: s2t_transformer_m
    by default): 1 warm-up, ``n_timed`` timed and 1 last step on one device-resident
    batch, the launches checked per step.  For the default model only (phase 8 and
    ``tools/train_step_ab``) the last step is profiled: the
    device busy share and top ops; for a PDS model also K1f's and K1b's device ms by stage,
    for SATE, a Conformer and the CTC research stack the device ms of each part of the
    forward (``encoder_ranges``) and of each CTC term of the loss (``ctc_term_ranges``).
    ``batch``, ``forward_fn`` and ``opt`` replace the seeded (B, T, U, V) feature batch,
    ``stack_forward`` and the bench optimizer (the text and waveform batches of phases 37,
    38 and 41).  ``profile``: profile the last step of another model too (its busy share)."""
    profile = cfg is None if profile is None else profile
    cfg = cfg or s2t_transformer_m(vocab_size=V, dtype_str="bfloat16", max_target_positions=1024)
    per_step = per_step or step_launches(cfg)
    model = model_cls(cfg, device="cuda", seed=0, for_training=True)
    trainer = Trainer(model, make_criterion(criterion),
                      opt or OptimizationConfig(lr=2e-3, warmup_updates=10000, clip_norm=10.0),
                      device="cuda", seed=1, forward_fn=forward_fn or stack_forward)
    shape = {}
    if batch is None:
        batch = train_batch(np.random.default_rng(0), B, T, U, V, [T] * B)
        shape = {"batch": B, "frames": T, "target_tokens": U, "vocab": V}
    batch = nested_to(batch, "cuda")  # device-resident, as bench
    reset_counts()  # the main path: 1 warm-up + n_timed timed + 1 profiled step
    losses = [trainer.train_step(batch)["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        losses.append(trainer.train_step(batch)["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pds = isinstance(cfg, PDSConfig)
    prof = None
    if profile:
        with encoder_ranges(model), ctc_term_ranges(), viterbi_ranges():
            prof = device_profile(lambda: losses.append(trainer.train_step(batch)["loss"]),
                                  KERNEL_NAMES,
                                  sequence=FWD_KERNELS + BWD_KERNELS + (K4_FRAGMENT,))
    else:
        losses.append(trainer.train_step(batch)["loss"])
    counts = read_counts()
    check_step_launches(counts, n_timed + 2, per_step)
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all() or not losses.max() > losses.min():
        raise AssertionError(f"bf16 training loss is not finite or does not move: {losses}")
    steps_per_s = n_timed / wall
    step_ms = wall / n_timed * 1e3
    res = {**shape, "parameters": sum(p.numel() for p in model.parameters()),
           "timed_steps": n_timed, "wall_s": wall, "step_ms": step_ms,
           "steps_per_s": steps_per_s, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_first_last": [losses[0].item(), losses[-1].item()]}
    if shape:
        res.update(frames_per_s=steps_per_s * B * T, tokens_per_s=steps_per_s * B * U)
    if prof is None:
        pass
    elif pds:
        res["forward_device_ms_by_stage"] = prof["range_ms"]
        res["forward_device_span_ms_by_stage"] = prof["range_span_ms"]
        res["k1f_device_ms_by_stage"] = by_stage(prof["sequence_ms"], cfg, FWD_KERNELS)
        res["k1b_device_ms_by_stage"] = by_stage(prof["sequence_ms"], cfg, BWD_KERNELS,
                                                 backward=True)
    elif prof["range_ms"]:
        res["forward_device_ms_by_part"] = prof["range_ms"]
    if prof is not None:
        res.update(profiled_step_wall_ms=prof["wall_ms"], profiled_device_busy_ms=prof["busy_ms"],
                   device_busy_share_of_profiled_step=prof["busy_ms"] / prof["wall_ms"],
                   device_busy_share_of_timed_step=prof["busy_ms"] / step_ms,
                   top_aten_ops_device_ms=prof["top_ops"], kernel_device_ms=prof["kernel_ms"],
                   kernel_share_of_busy={k: v / prof["busy_ms"]
                                         for k, v in prof["kernel_ms"].items()})
    if prof is not None and "stack_viterbi" in prof["range_ms"]:  # the PAE oracle's, over T
        res["oracle_viterbi_device_ms"] = prof["range_ms"]["stack_viterbi"]
        res["oracle_viterbi_host_ms"] = prof["range_host_ms"]["stack_viterbi"]
    if prof is not None and per_step.get("ctc_alpha", 0) > 1:  # each CTC term's forward, and
        res["ctc_term_forward_device_ms"] = {k: v for k, v in prof["range_ms"].items()  # K4s
                                             if k.startswith("stack_ctc_term")}
        res["k4_device_ms_in_launch_order"] = prof["sequence_ms"][K4_FRAGMENT]
    if isinstance(cfg, S2TTransformerConfig) and cfg.encoder_attention_type == "abs" \
            and cfg.decoder_layers:  # the analytic flops are the s2t_transformer family's
        flops = s2t_train_flops(B, T, U, d_model=cfg.encoder_embed_dim,
                                ffn=cfg.encoder_ffn_embed_dim, enc_layers=cfg.encoder_layers,
                                dec_layers=cfg.decoder_layers, vocab=V)
        res["model_flops_per_step"] = flops
        res["mfu_vs_989_tflops"] = flops * steps_per_s / 989e12
    log(f"[{tag}] bf16 untuned first measurement: {json.dumps(res)}")
    return res, counts


# --------------------------------------------------------------------------- #
# K5 against fbank_plain (fbank_torch: float64 frames and DFT through cuFFT, the
# power rounded to f32 once, an f32 mel matmul and log) and against fbank_numpy
# (the same precisions on the host): the tolerance of tests/test_fbank_pallas.py,
# |err| <= FBANK_ATOL + FBANK_RTOL |ref|.  All three round a float64 power to f32
# (direct DFT or FFT change only its last float64 bits), so they differ by about
# an f32 ulp of the mel sums under the log; the bound is the parity tests' own,
# which the JAX formulations' f32 DFT sums of 400 int16-scale samples (about
# five digits) still meet
FBANK_ATOL, FBANK_RTOL = 5e-4, 1e-4
FBANK_RAGGED = (399, 400, 401, 559, 560, 8037, 123457)
FBANK_N = 160000  # the timing shape: 40 rows of 10 s, T = 998
# device ms of the direct-DFT design of K5 at the timing shape (an NVIDIA H100 80GB HBM3
# at 700 W, PERF.md), printed beside the FFT's for the log only
DIRECT_DFT_DEVICE_MS = 1.0368528


def fbank_bound(B, N, n_mels=80):
    """Least time for one fbank call: the samples read and the features written
    once, and the operations of the FFT formulation (the fewest known for the
    function): per frame preprocessing (mean, preemphasis, window: 5 per sample),
    a 512-point real FFT (2.5 N log2 N), the power (3 per bin), the mel product
    over the nonzero weights of the Kaldi triangles (2 per weight, 501 weights
    for 80 bins) and the log, at the f32 rate (no tensor cores: see fbank.cu).
    Returns (bound ms, what bounds it, {"bytes_ms", "operations_ms"})."""
    _, lo, hi = mel_bin_ranges(n_mels)
    T = 1 + (N - 400) // 160 if N >= 400 else 0
    nbytes = 4 * B * N + 4 * B * T * n_mels + 4 * B + 4 * B
    per_frame = 5 * 400 + 2.5 * 512 * 9 + 3 * 257 + 2 * int((hi - lo).sum()) + n_mels
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, B * T * per_frame / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            {"bytes_ms": t_bytes * 1e3, "operations_ms": t_ops * 1e3})


def fbank_rows():
    """The content rows (silence, a +-32767 square wave, a DC offset of 1000 with
    sigma 1 noise, the four fixture wavs) and the ragged rows (noise of sigma 2000
    at FBANK_RAGGED lengths): [(name, waveform)]."""
    from s2t_tpu_torch.data.dataset import load_waveform

    rng = np.random.default_rng(10)
    n = np.arange(32000)
    rows = [("silence", np.zeros(16000, np.float32)),
            ("square", np.where((n // 50) % 2 == 0, 32767.0, -32767.0).astype(np.float32)),
            ("dc1000", (1000.0 + rng.normal(size=24000)).astype(np.float32))]
    rows += [(Path(w).stem, load_waveform(w)) for w in WAVS]
    rows += [(f"len{L}", (rng.normal(size=L) * 2000.0).astype(np.float32)) for L in FBANK_RAGGED]
    return rows


def fbank_check(got, want):
    """(max |err|, worst err / (atol + rtol |want|)) over two f32 tensors."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), (err / (FBANK_ATOL + FBANK_RTOL * want.float().abs())).max().item()


def phase_fbank():
    from s2t_tpu_torch.data.audio.fbank import fbank_numpy
    from s2t_tpu_torch.ops.fbank_cuda import fbank_plain

    rows = fbank_rows()
    wave = np.zeros((len(rows), FBANK_N), np.float32)
    for i, (_, w) in enumerate(rows):
        wave[i, : len(w)] = w
    lengths = torch.as_tensor([len(w) for _, w in rows], device="cuda")
    wave_t = torch.from_numpy(wave).cuda()
    got, flens = fbank(wave_t, lengths)
    plain, plain_flens = fbank_plain(wave_t, lengths)
    torch.cuda.synchronize()
    if not torch.equal(flens, plain_flens):
        raise AssertionError(f"K5 frame lengths {flens.tolist()} != plain {plain_flens.tolist()}")
    report, worst = [], 0.0
    for i, (name, w) in enumerate(rows):
        ref = torch.from_numpy(fbank_numpy(w))
        n = int(flens[i])
        if n != ref.shape[0]:
            raise AssertionError(f"row {name}: {n} frames, fbank_numpy has {ref.shape[0]}")
        err_p, ratio_p = fbank_check(got[i], plain[i])  # all T frames, the padded tail included
        err_n, ratio_n = fbank_check(got[i, :n].cpu(), ref) if n else (0.0, 0.0)
        worst = max(worst, ratio_p, ratio_n)
        report.append({"row": name, "samples": len(w), "frames": n, "vs_plain": err_p,
                       "vs_numpy": err_n})
        log(f"[fbank] {name:<9} {len(w):>6} samples {n:>4} frames: max |err| vs plain "
            f"{err_p:.3e} (all {got.shape[1]} frames), vs fbank_numpy {err_n:.3e}")
    silent = got[0, flens[0]:].unique()  # the silent tail is log(EPSILON) in every formulation
    log(f"[fbank] silent frames give {silent.tolist()}; worst err / (atol + rtol |ref|) = "
        f"{worst:.3f} (atol {FBANK_ATOL}, rtol {FBANK_RTOL})")
    if not worst <= 1.0:
        raise AssertionError(f"K5 disagrees with fbank_plain / fbank_numpy: {report}")

    # the timing shape: 40 rows of 10 s of sigma-2000 noise
    B = 40
    g = torch.Generator(device="cuda").manual_seed(11)
    wave_t = torch.randn((B, FBANK_N), generator=g, device="cuda") * 2000.0
    lengths = torch.full((B,), FBANK_N, device="cuda")
    got, _ = fbank(wave_t, lengths)
    plain, _ = fbank_plain(wave_t, lengths)
    err, ratio = fbank_check(got, plain)
    if not ratio <= 1.0:
        raise AssertionError(f"K5 disagrees with fbank_plain at the timing shape: max |err| {err}")
    res = {"B": B, "N": FBANK_N, "T": got.shape[1], "max_abs_err": err, "err_ratio": ratio,
           "rows": report,
           "ms": cuda_ms(lambda: fbank(wave_t, lengths)),
           "device_ms": device_ms(lambda: fbank(wave_t, lengths), ("fbank_kernel",))[0],
           "plain_ms": cuda_ms(lambda: fbank_plain(wave_t, lengths), iters=10)}
    res["bound_ms"], res["bound_by"], res["bound_parts"] = fbank_bound(B, FBANK_N)
    log(f"[fbank] timing shape {json.dumps({k: v for k, v in res.items() if k != 'rows'})}")
    log(f"[fbank] K5 device {res['device_ms']:.4f} ms at B={B} x {FBANK_N} samples: the "
        f"direct-DFT design took {DIRECT_DFT_DEVICE_MS} ms, the bound is {res['bound_ms']:.4f} "
        f"({res['bound_by']})")
    return res


# --------------------------------------------------------------------------- #
# phases 11-12: the raw-audio training path through the task, data and CLI layers
CORPUS = {"train": 80, "dev": 16}
SYMBOLS = 9996  # + the 4 special symbols: V = 10000, the bench's vocabulary
TEST_UTTS = 8
# fairseq's LibriSpeech ("lb") SpecAugment policy, the recipes' train transforms
SPECAUGMENT = {"time_warp_W": 0, "freq_mask_N": 1, "freq_mask_F": 27, "time_mask_N": 1,
               "time_mask_T": 100, "time_mask_p": 1.0}
# fp32 forward_fn + criterion, card (kernels) vs CPU (plain): every output and loss,
# max |err| over max(1, max |CPU|); test_torch_task.py holds the CPU path to JAX at 1e-4
FORWARD_RTOL = 1e-4


def write_wav(path: Path, samples: np.ndarray) -> None:
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.clip(np.rint(samples), -32768, 32767).astype("<i2").tobytes())


def write_corpus(root: Path, seed: int = 0, corpus=None) -> None:
    """A seeded raw-audio corpus (``corpus``: split -> utterances, CORPUS by
    default): 16-bit wavs of 4-12 s (sigma-2000 noise),
    targets of 10-30 words drawn from a Zipf(1.1) law over SYMBOLS words (so a
    model can learn something from the text alone), ``src_text`` = the target
    words for CTC, and ``dict.txt``."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(SYMBOLS)]
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    p = 1.0 / np.arange(1, SYMBOLS + 1) ** 1.1
    p /= p.sum()
    for split, n in (corpus or CORPUS).items():
        lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
        for i in range(n):
            samples = int(rng.integers(4 * 16000, 12 * 16000 + 1))
            write_wav(root / f"{split}{i}.wav", rng.normal(size=samples) * 2000.0)
            text = " ".join(words[j] for j in rng.choice(SYMBOLS, size=int(rng.integers(10, 31)),
                                                         p=p))
            lines.append(f"{split}{i}\t{split}{i}.wav\t{samples}\t{text}\t{text}")
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")


def train_cfg(root: Path, arch: str, model: dict, criterion, save_dir: str,
              dtype: str = "bfloat16", max_epoch: int = 2, dataset=None, optimization=None,
              checkpoint=None, eval=None, generation=None):
    """A cli.train config over ``root``: ``model`` is the recipe's model section, with
    ``dtype`` as its dtype (a SATE model's acoustic dtype), ``criterion`` (name, cfg).
    By default on phase 11's wav corpus (with use_audio_input the size columns and caps
    count samples); warmup 4; the other sections update the defaults below."""
    from s2t_tpu_torch.config import TrainConfig, from_dict

    dtype_key = "acoustic_dtype_str" if arch.startswith("s2t_sate") else "dtype_str"
    return from_dict(TrainConfig, {
        "task": "speech_to_text", "arch": arch, "criterion": criterion[0],
        "criterion_cfg": criterion[1], "model": {**model, dtype_key: dtype},
        "dataset": {"data": str(root), "max_tokens": 6_400_000, "max_source_positions": 200_000,
                    **(dataset or {})},
        "optimization": {"max_epoch": max_epoch, "lr": 2e-3, "warmup_updates": 4,
                         "clip_norm": 10.0, **(optimization or {})},
        "checkpoint": {"save_dir": str(root / save_dir), "keep_last_epochs": 1,
                       **(checkpoint or {})},
        "common": {"seed": 1, "log_interval": 1},
        "eval": eval or {},
        "generation": {"beam": 5, "max_len_b": 100, "scoring": "wer", "post_process": None,
                       **(generation or {})},
    })


def audio_cfg(root: Path, max_epoch: int, dtype: str = "bfloat16"):
    """s2t_transformer_m at full width (the preset's dropouts) on the wav corpus."""
    return train_cfg(root, "s2t_transformer_m", {}, CRITERION, "ckpt", dtype, max_epoch)


def audio_task(cfg, use_audio: bool = True):
    """The task from a data config built in Python (no config.yaml to read)."""
    from s2t_tpu_torch.data.dataset import S2TDataConfig
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask

    data_cfg = S2TDataConfig(use_audio_input=use_audio, transforms={
        "_train": {"transforms": ["utterance_cmvn", "specaugment"], "specaugment": SPECAUGMENT},
        "_eval": {"transforms": ["utterance_cmvn"]}})
    return SpeechToTextTask(cfg, data_cfg, Dictionary.load(Path(cfg.dataset.data) / "dict.txt"))


def check_counts(counts, want, what):
    if counts != want:
        raise AssertionError(f"{what} launched {counts}, expected {want}")


def path_counts(train_steps, forwards, layers=12, ctc_step=1, ctc_valid=1):
    """Launches of a run of ``train_steps`` train steps and ``forwards`` forwards
    in all (train + valid): K5 and K1f once per forward (K1f per encoder layer of
    the fused kernel), K1b per train step, K3 and K4 once per CTC term of a train
    step (``ctc_step``) and K3 once per term of a validation forward (``ctc_valid``)."""
    return {"attention_fwd": layers * forwards, "attention_bwd": layers * train_steps,
            "ctc_alpha": ctc_step * train_steps + ctc_valid * (forwards - train_steps),
            "ctc_beta_grad": ctc_step * train_steps, "fbank": forwards}


def to_device(batch, device):
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in step_batch(batch).items()}


def phase_train_audio(root: Path):
    from s2t_tpu_torch.cli import train as cli_train

    t0 = time.perf_counter()
    write_corpus(root)
    corpus_s = time.perf_counter() - t0
    cfg = audio_cfg(root, max_epoch=2)
    first, counts, _, task = phase_audio_cli(cfg, "train audio")
    steps, n_valid, losses, valid = (first[k] for k in ("train_steps", "valid_batches",
                                                        "train_losses", "valid_losses"))
    # training learns: the last validation below the first, the last epoch's mean train
    # loss below the first's
    epoch_mean = [np.mean([r["loss"] for r in first["train_log"] if r["epoch"] == e])
                  for e in (1, cfg.optimization.max_epoch)]
    if not (valid[-1] < valid[0] and epoch_mean[1] < epoch_mean[0]):
        raise AssertionError(f"train audio: the losses do not fall over "
                             f"{cfg.optimization.max_epoch} epochs: train {losses}, valid "
                             f"{valid}")
    valid_ds = task.datasets[cfg.dataset.valid_subset]
    ckpt = Path(cfg.checkpoint.save_dir)
    files = sorted(p.name for p in ckpt.glob("*.pt"))
    want = {"checkpoint_last.pt", "checkpoint_best.pt", "checkpoint2.pt"}
    if not want <= set(files) or "checkpoint1.pt" in files:  # keep_last_epochs 1
        raise AssertionError(f"checkpoint files {files}, expected {sorted(want)} and no "
                             "checkpoint1.pt")
    log(f"[train audio] checkpoints {files}")
    timing, wall = first["timing"], first["wall_s"]

    # a 3rd epoch resumes from checkpoint_last.pt: step and epoch continue
    cfg4 = audio_cfg(root, max_epoch=3)
    task4 = audio_task(cfg4)
    reset_counts()  # the main path: the resumed run
    out4 = cli_train.main(cfg4, task=task4, device="cuda")
    torch.cuda.synchronize()
    counts4 = read_counts()
    steps4 = out4["trainer"].step - steps
    log4 = out4["train_log"]
    epochs4 = [h["epoch"] for h in out4["history"]]
    if not (log4 and log4[0]["step"] == steps + 1 and steps4 > 0 and epochs4 == [2, 3]
            and all(r["epoch"] == 3 for r in log4)):
        raise AssertionError(f"the resumed run did not continue at step {steps + 1} in epoch 3: "
                             f"train log {log4}, validated epochs {epochs4}")
    check_counts(counts4, path_counts(steps4, steps4 + n_valid * len(epochs4)), "resumed cli.train")
    log(f"[train audio] resumed at step {log4[0]['step']} in epoch 3: {steps4} steps, losses "
        f"{[round(r['loss'], 4) for r in log4]}, validated epochs {epochs4}; launches "
        f"{json.dumps(counts4)}")
    launches = {k: counts[k] + counts4[k] for k in counts}

    # where a step from raw audio spends its time: the host (wav reads, collation),
    # the step, and one profiled step on the device
    trainer = out4["trainer"]
    train_ds = task4.datasets[cfg4.dataset.train_subset]
    t0 = time.perf_counter()
    batch = next(iter(task4.get_batch_iterator(train_ds, max_tokens=cfg4.dataset.max_tokens,
                                               seed=1, shuffle=False,
                                               buffer_size=1).next_epoch_itr()))
    host_batch_s = time.perf_counter() - t0
    step_s = synced_s(lambda: trainer.train_step(step_batch(batch)))
    res = {"corpus_write_s": corpus_s, "train_steps": steps, "resumed_steps": steps4,
           "wall_s": wall, "valid_batches": n_valid, "train_losses": losses,
           "valid_losses": valid, "timing": timing,
           "steps_per_s_in_step": steps / timing["step_s"],
           "steps_per_s_with_data": steps / (timing["step_s"] + timing["data_s"]),
           "data_wait_share": timing["data_s"] / (timing["step_s"] + timing["data_s"]),
           "host_batch_s": host_batch_s, "batch_shape": list(batch["features"].shape),
           "last_step_s": step_s}
    # (no profiled step: its busy share and K5's share of it are in PERF.md)
    res["host_batch_share_of_step"] = host_batch_s / (host_batch_s + step_s)

    res["fp32_forward"] = forward_card_vs_cpu(task, valid_ds, cfg)
    log(f"[train audio] {json.dumps({k: v for k, v in res.items() if 'losses' not in k})}")
    return res, launches


def forward_card_vs_cpu(task, valid_ds, cfg):
    """One fp32 forward_fn + criterion pass on a dev batch from the same weights at
    REF_LAYERS a side, card (K5, K1f, K3) vs CPU (their plain versions): the encoder
    output and the CTC logits over each row's valid frames, the decoder logits over its
    target tokens, elementwise, and the two summed losses."""
    cfg32 = train_cfg(Path(cfg.dataset.data), "s2t_transformer_m", REF_DEPTH, CRITERION,
                      "ckpt", "float32")
    batch = next(iter(task.get_batch_iterator(valid_ds, max_tokens=cfg.dataset.max_tokens,
                                              seed=1, shuffle=False).next_epoch_itr()))
    outs, losses = {}, {}
    for device in ("cuda", "cpu"):
        t = audio_task(cfg32)
        model = t.build_model(device=device, seed=0)
        if model.device.type != device:
            raise AssertionError(f"the fp32 model was built on {model.device}, not {device}")
        b = to_device(batch, device)
        reset_counts()  # a check of the card's pass, not the main path
        with torch.no_grad():
            out = t.forward_fn()(model, b, train=False)
            loss, _, logs = t.build_criterion()(out, b)
        counts = read_counts()
        if device == "cuda":
            check_counts(counts, path_counts(0, 1, REF_LAYERS), "the fp32 card forward")
        outs[device] = {k: v.cpu() for k, v in out.items() if isinstance(v, torch.Tensor)}
        losses[device] = {"loss": float(loss), "ctc_loss": float(logs["ctc_loss"])}
        del model
    card, cpu = outs["cuda"], outs["cpu"]
    if not torch.equal(card["encoder_lengths"], cpu["encoder_lengths"]):
        raise AssertionError(f"encoder lengths card {card['encoder_lengths'].tolist()} != CPU "
                             f"{cpu['encoder_lengths'].tolist()}")
    frames = lengths_to_mask(cpu["encoder_lengths"], cpu["encoder_out"].shape[1])
    tokens = torch.as_tensor(np.asarray(batch["target"])) != task.tgt_dict.pad()
    err = {"encoder_out": rel_err(card["encoder_out"][frames], cpu["encoder_out"][frames]),
           "ctc_logits": rel_err(card["ctc_logits"][frames], cpu["ctc_logits"][frames]),
           "decoder_logits": rel_err(card["decoder_logits"][tokens],
                                     cpu["decoder_logits"][tokens])}
    err.update({k: abs(losses["cuda"][k] - losses["cpu"][k]) / abs(losses["cpu"][k])
                for k in losses["cpu"]})
    res = {"batch_shape": list(batch["features"].shape), "valid_frames": int(frames.sum()),
           "target_tokens": int(tokens.sum()), **losses, "rel_err": err}
    log(f"[train audio] fp32 forward_fn + criterion on a dev batch "
        f"{tuple(batch['features'].shape)}: card {losses['cuda']}, CPU {losses['cpu']}; "
        f"rel err (max |err| / max(1, max |CPU|)) {err} (limit {FORWARD_RTOL})")
    if not all(v <= FORWARD_RTOL for v in err.values()):
        raise AssertionError("the raw-audio forward disagrees between the card and the CPU")
    return res


def write_feature_split(root: Path, src: str, dst: str, n=None) -> None:
    """The fbank_numpy features of the first ``n`` utterances (all when None) of
    the wav split ``src`` as ``<id>.npy`` files and the manifest ``dst.tsv``,
    whose other columns are ``src``'s: the feature splits of phases 12 and 14."""
    from s2t_tpu_torch.data.audio.fbank import fbank_numpy
    from s2t_tpu_torch.data.dataset import load_waveform

    header, *rows = (root / f"{src}.tsv").read_text().splitlines()
    lines = [header]
    for row in rows[:n]:
        uid, wav, _, *rest = row.split("\t")
        feats = fbank_numpy(load_waveform(wav, str(root)))
        np.save(root / f"{uid}.npy", feats)
        lines.append("\t".join([uid, f"{uid}.npy", str(feats.shape[0]), *rest]))
    (root / f"{dst}.tsv").write_text("\n".join(lines) + "\n")


def phase_generate(root: Path):
    """Decode TEST_UTTS dev utterances, as fbank_numpy features, with cli.generate
    from phase 11's checkpoint_last.pt."""
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.utils.checkpoint import load_checkpoint

    write_feature_split(root, "dev", "test", TEST_UTTS)
    cfg = audio_cfg(root, max_epoch=3)
    cfg.dataset.gen_subset = "test"
    cfg.generation.results_path = str(root / "gen")
    task = audio_task(cfg, use_audio=False)
    tree, meta = load_checkpoint(Path(cfg.checkpoint.save_dir) / "checkpoint_last.pt")
    reset_counts()  # the main path: cli.generate
    out = cli_generate.main(cfg, tree["params"], task=task, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    encodes = len(task.get_batch_iterator(task.datasets["test"], max_tokens=cfg.dataset.max_tokens,
                                          shuffle=False))
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": 12 * encodes},
                 "cli.generate")
    text = (Path(cfg.generation.results_path) / "generate-test.txt").read_text().splitlines()
    for tag in ("T", "H", "D"):
        n = sum(line.startswith(f"{tag}-") for line in text)
        if n != TEST_UTTS:
            raise AssertionError(f"generate-test.txt has {n} {tag}- lines, expected {TEST_UTTS}")
    score = [line for line in text if line.startswith("Generate test with beam=5: WER: ")]
    if len(score) != 1:
        raise AssertionError(f"generate-test.txt has no WER line: {text[-1]!r}")
    res = {"checkpoint_step": meta["step"], "utterances": out["n_utts"], "score": score[0],
           "gen_time_s": out["gen_time"], "utts_per_s": out["utts_per_sec"], "rtf": out["rtf"],
           "launches": counts, "first_lines": text[:3]}
    log(f"[generate] {json.dumps(res)}")
    return res, counts


# --------------------------------------------------------------------------- #
# phases 13-15: encoder-only CTC serving and training, and the decode-quality check
NAST_SHAPE = dict(B=256, T=1000, V=10000)  # bench.py:84-94, bench_nast_generation


def ctc_near_tie(card_enc, host_enc, card_tok, host_tok, beam, decoder=None):
    """Whether rows whose CTC tokens differ between the card and the CPU are
    explained by the card's logit error ``err`` (max |card - CPU| over valid
    frames): greedy, every frame whose argmax differs has CPU log-probs of the
    two tokens within 2 err; beam, the CPU's CTC log-likelihood of the card's
    and of the CPU's top hypothesis lie within 4 err per frame (each log-prob
    is off by at most 2 err).  Under a self-ensembling ``decoder`` the decoded
    log-probs are its averages: ``err`` is their own error, so each is off by at
    most err and the same bounds hold.  Returns (accepted, report)."""
    from s2t_tpu_torch.ops.ctc import ctc_loss

    lengths = host_enc["encoder_lengths"]
    valid = lengths_to_mask(lengths, host_enc["ctc_logits"].shape[1])
    if decoder is not None and decoder.self_ensemble:
        card_logits = decoder.select_logits(card_enc).float().cpu()
        host_logits = decoder.select_logits(host_enc).float()
    else:
        card_logits = card_enc["ctc_logits"].float().cpu()
        host_logits = host_enc["ctc_logits"].float()
    err = (card_logits - host_logits).abs()[valid].max().item()
    lp = torch.log_softmax(host_logits, dim=-1)
    report, ok = [], True
    for b in range(card_tok.shape[0]):
        if torch.equal(card_tok[b], host_tok[b]):
            continue
        if beam == 1:
            n = int(lengths[b])
            a, c = card_logits[b, :n].argmax(-1), host_logits[b, :n].argmax(-1)
            frames = torch.nonzero(a != c)[:, 0]
            gaps = (lp[b, frames, c[frames]] - lp[b, frames, a[frames]]).tolist()
            tie = bool(frames.numel()) and max(gaps) <= 2 * err
            report.append({"row": b, "frames": frames.tolist(), "gaps": gaps, "near_tie": tie})
        else:
            hyps = [t[t != 1] for t in (card_tok[b, 0], host_tok[b, 0])]
            nll = [ctc_loss(lp[b:b + 1], h[None].long(), lengths[b:b + 1],
                            torch.tensor([len(h)]), reduction="sum").item() for h in hyps]
            tie = abs(nll[0] - nll[1]) <= 4 * err * int(lengths[b])
            report.append({"row": b, "cpu_nll_of_card_and_cpu_top": nll, "near_tie": tie})
        ok = ok and tie
    return ok, {"ctc_logits_max_abs_err": err, "differing_rows": report}


def phase_nast(preset=None, model_section=None, tag="nast", use_xctc=False, ensemble=False):
    """An encoder-only CTC model at full width (``preset``, s2t_ctc_base by default,
    with ``model_section``): greedy CTC serving in bf16 at bench.py's NAST shape
    through CTCGenerator (``use_xctc``: the XCTC logits), then fp32 fixture wavs card
    vs CPU, greedy and beam 5 (and, with ``ensemble``, ctc_self_ensemble over the
    inter-CTC taps greedy and beam 5)."""
    from s2t_tpu_torch.hub import GeneratorHub
    from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
    from s2t_tpu_torch.models.s2t_ctc import S2TCTCModel, s2t_ctc_base

    preset = preset or s2t_ctc_base
    B, T, V = NAST_SHAPE["B"], NAST_SHAPE["T"], NAST_SHAPE["V"]
    section = {**(model_section or {}), "vocab_size": V, "max_target_positions": 1024}
    dtype_key = "acoustic_dtype_str" if isinstance(preset(**section), SATEConfig) else "dtype_str"
    cfg = preset(**section, **{dtype_key: "bfloat16"})
    layers = encoder_layers(cfg)
    model = S2TCTCModel(cfg, device="cuda", seed=0)
    gen = CTCGenerator(model, CTCDecoder(), use_xctc=use_xctc)
    g = torch.Generator(device="cuda").manual_seed(0)
    feats = [torch.randn((B, T, 80), generator=g, device="cuda") for _ in range(4)]
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")

    def serve(f):
        return gen.generate({"features": f, "feat_lengths": lens})[0].cpu()

    reset_counts()  # the main path: 1 warm-up and 3 timed batches (no profiled batch: the
    out = serve(feats[0])  # busy share and the encode's device ms by stage are in PERF.md)
    walls = [synced_s(lambda: serve(f)) for f in feats[1:]]
    encodes = 4
    counts = read_counts()
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": layers * encodes},
                 f"{tag} serving ({encodes} encodes)")
    wall = float(np.median(walls))
    res = {"batch": B, "frames": T, "vocab": V, "dtype": "bfloat16", "use_xctc": use_xctc,
           "wall_s": walls, "utt_per_s": B / wall, "rtf": B * T * 0.01 / wall,
           "tokens_shape": list(out.shape), "launches_per_encode": layers}
    log(f"[{tag}] bf16 greedy CTC serving: {json.dumps(res)}")

    # fp32: the fixture wavs on the card (kernels) and on the CPU (plain versions)
    cfg32 = preset(**(model_section or {}), vocab_size=V, max_target_positions=1024)
    cfg32 = shallow(cfg32)  # the reference's depth
    layers = encoder_layers(cfg32)
    card, host = seeded_pair(lambda d: S2TCTCModel(cfg32, device=d, seed=0)).values()
    batch = GeneratorHub(card, None)._speech_batch(WAVS)
    parity = {}
    for beam, se in [(1, False), (5, False)] + ([(1, True), (5, True)] if ensemble else []):
        decoder = CTCDecoder(beam_size=beam, self_ensemble=se)
        before = fused_attention.launches
        tc, _, ec = CTCGenerator(card, decoder, use_xctc=use_xctc).generate(batch)
        torch.cuda.synchronize()
        check_counts({"attention_fwd": fused_attention.launches - before},
                     {"attention_fwd": layers}, f"the fp32 beam-{beam} encode")
        th, _, eh = CTCGenerator(host, decoder, use_xctc=use_xctc).generate(batch)
        same = torch.equal(tc.cpu(), th)
        ok, report = (True, {}) if same else ctc_near_tie(ec, eh, tc.cpu(), th, beam, decoder)
        key = f"beam{beam}" + ("_self_ensemble" if se else "")
        parity[key] = {"identical": same, **report,
                       "lengths": [int((row != 1).sum()) for row in th[:, 0]]}
        log(f"[{tag}] fp32 fixture wavs, {key}: card vs CPU top tokens "
            f"{'identical' if same else 'differ'} {json.dumps(parity[key])}")
        if not ok:
            raise AssertionError(f"CTC decoding differs card vs CPU beyond a near-tie: {report}")
    res["fp32_parity"] = parity
    return res, read_counts()


PURECTC_MODEL = {"encoder_layers": 18, "encoder_embed_norm": True,  # the model section of
                 "encoder_no_scale_embedding": True}               # egs/mustc/asr/conf/purectc.yaml
CTC_CORPUS_MAX_TOKENS = 40000  # frames a batch, the recipes' basis.yaml


def ctc_cfg(root: Path, dtype: str = "bfloat16"):
    """arch s2t_ctc at full width with purectc.yaml's model section, criterion ctc,
    on the feature splits of phase 11's corpus; validation decodes (eval_ctc_wer,
    eval_wer), generation is beam 5 with ctc_infer."""
    return train_cfg(
        root, "s2t_ctc", PURECTC_MODEL, ("ctc", {"ctc_weight": 1.0, "zero_infinity": True}),
        "ctc_ckpt", dtype,
        dataset={"train_subset": "ftrain", "valid_subset": "fdev", "gen_subset": "fdev",
                 "max_tokens": CTC_CORPUS_MAX_TOKENS, "max_source_positions": 6000},
        # the best checkpoint by the validation CTC WER, a key the decoding puts in val
        checkpoint={"best_checkpoint_metric": "ctc_wer"},
        eval={"eval_ctc_wer": True, "eval_wer": True, "eval_gen_beam": 1},
        generation={"ctc_infer": True, "results_path": str(root / "ctc_gen")})


def phase_train_ctc(root: Path):
    """cli.train trains s2t_ctc (purectc.yaml: 18 layers, embed norm, no scale) in bf16
    for 2 epochs on phase 11's corpus as fbank features, validating with eval_ctc_wer
    and eval_wer; cli.generate decodes the dev split (beam 5, ctc_infer) from
    checkpoint_best.pt (by ctc_wer) and hub.from_pretrained transcribes the 4 of its
    utterances with the longest hypotheses, both in fp32."""
    from s2t_tpu_torch.cli import train as cli_train

    t0 = time.perf_counter()
    write_feature_split(root, "train", "ftrain")
    write_feature_split(root, "dev", "fdev")
    split_s = time.perf_counter() - t0
    cfg = ctc_cfg(root)
    task = audio_task(cfg, use_audio=False)
    reset_counts()  # the main path: cli.train, 2 epochs, each with a decoding validation
    t0 = time.perf_counter()
    out = cli_train.main(cfg, task=task, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = out["trainer"].step
    n_valid = len(task.get_batch_iterator(task.datasets["fdev"], max_tokens=CTC_CORPUS_MAX_TOKENS,
                                          seed=1, shuffle=False))
    valids = n_valid * len(out["history"])
    layers = PURECTC_MODEL["encoder_layers"]
    # a step: K1f and K1b per layer, K3 and K4 once; a validation batch: the loss's
    # forward (K1f per layer, K3) and two more encodes (eval_ctc_wer, eval_wer's generator)
    want = {"attention_fwd": layers * (steps + 3 * valids), "attention_bwd": layers * steps,
            "ctc_alpha": steps + valids, "ctc_beta_grad": steps, "fbank": 0}
    check_counts(counts, want, f"CTC cli.train ({steps} steps, {valids} validation batches)")
    hist = out["history"]
    for key in ("loss", "ctc_wer", "ctc_cer", "wer"):
        if not all(np.isfinite(h[key]) for h in hist):
            raise AssertionError(f"CTC validation {key} is missing or not finite: {hist}")
    log(f"[train ctc] {cfg.optimization.max_epoch} epochs, {steps} steps in {wall:.2f} s: "
        f"train losses "
        f"{[round(r['loss'], 4) for r in out['train_log']]}; validation "
        + "; ".join(f"epoch {h['epoch']}: loss {h['loss']:.4f} ctc_wer {h['ctc_wer']:.2f} "
                    f"ctc_cer {h['ctc_cer']:.2f} wer {h['wer']:.2f}" for h in hist)
        + f"; launches {json.dumps(counts)} (per step: K1f {layers}, K1b {layers}, K3 1, K4 1)")

    # decode the dev split from checkpoint_best.pt in fp32, beam 5, with ctc_infer
    cfg32 = ctc_cfg(root, dtype="float32")
    gen, text, strings, gen_counts, hub_counts = generate_and_hub(
        root, cfg32, Path(cfg.checkpoint.save_dir) / "checkpoint_best.pt", layers, "train ctc")
    ctc_lines = (Path(cfg32.generation.results_path) / "translation-fdev.txt.ctc").read_text()
    ctc_lines = ctc_lines.splitlines()
    if len(ctc_lines) != CORPUS["dev"]:
        raise AssertionError(f"translation-fdev.txt.ctc does not hold {CORPUS['dev']} hypotheses")
    log(f"[train ctc] first .ctc lines {[x[:80] for x in ctc_lines[:2]]}")
    res = {"feature_split_s": split_s, "train_steps": steps, "wall_s": wall,
           "train_losses": [r["loss"] for r in out["train_log"]], "history": hist,
           "timing": out["timing"], "score": text[-1], "gen_time_s": gen["gen_time"],
           "gen_utts_per_s": gen["utts_per_sec"], "gen_rtf": gen["rtf"],
           "hub_strings": strings, "launches": {"train": counts, "generate": gen_counts,
                                                 "hub": hub_counts}}
    total = {k: counts[k] + gen_counts[k] + hub_counts[k] for k in counts}
    return res, total


def generate_and_hub(root: Path, cfg32, best: Path, layers: int, tag: str):
    """cli.generate decodes the fdev split from the checkpoint ``best`` in fp32, then
    hub.from_pretrained transcribes the 4 dev utterances with the longest hypotheses
    by their feature files, and must give cli.generate's D- strings (a check of equal
    strings, not of four empty ones).  Returns (cli.generate's result, the lines of
    generate-fdev.txt, the hub's strings, the launches of cli.generate and of the hub)."""
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.config import to_dict
    from s2t_tpu_torch.hub import from_pretrained
    from s2t_tpu_torch.utils.checkpoint import load_checkpoint

    tree, meta = load_checkpoint(best)
    gen_task = audio_task(cfg32, use_audio=False)
    reset_counts()  # the main path: cli.generate
    gen = cli_generate.main(cfg32, tree["params"], task=gen_task, device="cuda")
    torch.cuda.synchronize()
    gen_counts = read_counts()
    encodes = len(gen_task.get_batch_iterator(gen_task.datasets["fdev"],
                                              max_tokens=cfg32.dataset.max_tokens, shuffle=False))
    check_counts(gen_counts, {**{k: 0 for k in gen_counts}, "attention_fwd": layers * encodes},
                 f"{tag}: cli.generate")
    text = (Path(cfg32.generation.results_path) / "generate-fdev.txt").read_text().splitlines()
    d_lines = {int(line.split("\t")[0][2:]): line.split("\t", 2)[2]
               for line in text if line.startswith("D-")}
    if len(d_lines) != CORPUS["dev"]:
        raise AssertionError(f"generate-fdev.txt holds {len(d_lines)} hypotheses, expected "
                             f"{CORPUS['dev']}")
    ids = sorted(d_lines, key=lambda i: (-len(d_lines[i]), i))[:4]
    if not d_lines[ids[0]]:
        raise AssertionError(f"{tag}: the trained model decodes every dev utterance to nothing: "
                             f"{text}")

    reset_counts()  # the main path: the hub
    hub = from_pretrained(best, root, config=to_dict(cfg32), device="cuda")
    rows = (root / "fdev.tsv").read_text().splitlines()[1:]
    strings = hub.generate([str(root / rows[i].split("\t")[1]) for i in ids])
    torch.cuda.synchronize()
    hub_counts = read_counts()
    check_counts(hub_counts, {**{k: 0 for k in hub_counts}, "attention_fwd": layers},
                 f"{tag}: hub.from_pretrained")
    want_strings = [d_lines[i] for i in ids]
    log(f"[{tag}] cli.generate (beam {cfg32.generation.beam}) from {best.name} (step "
        f"{meta['step']}): {text[-1]!r}; from_pretrained transcribes {[x[:80] for x in strings]} "
        f"({[len(x) for x in strings]} characters), cli.generate's D- lines "
        f"{[len(x) for x in want_strings]} characters")
    if strings != want_strings:
        raise AssertionError(f"{tag}: from_pretrained's strings differ from cli.generate's D- "
                             f"lines: {strings} vs {want_strings}")
    return gen, text, strings, gen_counts, hub_counts


def phase_wer_sanity():
    """bench.py section C on the card: overfit 16 synthetic utterances with the
    2-layer model (120 steps), decode with beam 2, score WER."""
    from s2t_tpu_torch.tools.wer_sanity import STEPS, wer_sanity

    reset_counts()  # the main path: 120 training steps and one decode
    t0 = time.perf_counter()
    res = wer_sanity(device="cuda")
    torch.cuda.synchronize()
    res["wall_s"] = time.perf_counter() - t0
    counts = read_counts()
    # 2 encoder layers: K1f and K1b twice a step, K3 and K4 once; the decode encodes once
    check_counts(counts, {"attention_fwd": 2 * STEPS + 2, "attention_bwd": 2 * STEPS,
                          "ctc_alpha": STEPS, "ctc_beta_grad": STEPS, "fbank": 0},
                 "wer_sanity")
    log(f"[wer sanity] {json.dumps(res)}")
    if res["wer_sanity"] != 0.0:
        raise AssertionError(f"the overfit model does not decode its references: {res}")
    return res, counts


# --------------------------------------------------------------------------- #
# phases 16-18: the PDS encoder serving, serving CTC and training (the card has no yaml
# package, so the script carries the recipes' sections; tests/test_torch_pds.py holds
# them to the files)
PDS_S8_FIELDS = {"vocab_size": 10000, "max_target_positions": 1024}
GROWTH360_MODEL = {  # the model section of egs/librispeech/asr/conf/purectc_pds_base_8_growth360.yaml
    "pds_stages": 4, "pds_ratios": [2, 2, 1, 2], "pds_layers": [4, 4, 4, 4],
    "pds_kernel_sizes": [5, 5, 5, 5], "pds_embed_dims": [200, 256, 256, 360],
    "pds_attn_heads": [4, 4, 4, 4], "pds_ffn_ratios": [8, 8, 8, 8],
    "pds_position_embed": [1, 1, 1, 1], "encoder_embed_dim": 360}
PDS_BIG_MODEL = {"pds_fusion": True, "dropout": 0.15}  # egs/librispeech/asr/conf/pds_big.yaml
PDS_BIG_ARCH = "pdss2t_transformer_m_8"
# egs/mustc/asr/conf/pds_base_8.yaml (its arch and criterion_cfg) over its basis.yaml
PDS_BASE_8 = {"arch": "pdss2t_transformer_s_8",
              "criterion_cfg": {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}}}
PDS_BASIS = {"criterion": "label_smoothed_cross_entropy_with_ctc", "max_tokens": 40000,
             "max_source_positions": 6000, "max_target_positions": 1024, "num_buckets": 12,
             "eval": {"eval_wer": True, "eval_gen_beam": 1}}


def fields(section):
    """A recipe's model section as config fields (YAML lists -> tuples)."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in section.items()}


def phase_pds_serve():
    """pdss2t_transformer_s_8 at full width: fp32 fixture wavs card vs CPU, then bf16
    serving of 64 x 10 s with each stage's device ms."""
    encodes = phase_serve_parity(pdss2t_transformer_s_8(**PDS_S8_FIELDS), tag="pds serve")
    more, speed = phase_speed(pdss2t_transformer_s_8(**PDS_S8_FIELDS, dtype_str="bfloat16"),
                              tag="pds speed")
    return encodes + more, speed


def phase_pds_train(root: Path):
    """(a) pds_big.yaml's model in fp32 card vs CPU; (b) in bf16 at the bench shape;
    (c) cli.train, cli.generate and from_pretrained with pds_base_8.yaml."""
    cfg32 = pdss2t_transformer_m_8(**{**fields(PDS_BIG_MODEL), "dropout": 0.0,
                                      "attention_dropout": 0.0, "activation_dropout": 0.0},
                                   **PDS_S8_FIELDS)
    parity, parity_launches = phase_train_parity(shallow(cfg32), PDSS2TTransformerModel,
                                                 "pds train")
    speed, speed_launches = phase_train_speed(
        pdss2t_transformer_m_8(**fields(PDS_BIG_MODEL), **PDS_S8_FIELDS, dtype_str="bfloat16"),
        PDSS2TTransformerModel, "pds train speed", n_timed=EARLIER_TIMED)
    cli, cli_launches = phase_pds_cli(root)
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] + cli_launches[k]
                for k in counters()}
    return {"parity": parity, "speed": speed, "cli": cli}, launches


def pds_cfg(root: Path, dtype: str = "bfloat16"):
    """pds_base_8.yaml over basis.yaml on phase 14's feature splits; cut to one update
    (phase 14 trains on these splits for epochs), warmup 4 (basis: 10000) and beam outputs
    of at most 100 tokens, no sentencepiece."""
    return train_cfg(
        root, PDS_BASE_8["arch"], {}, (PDS_BASIS["criterion"], PDS_BASE_8["criterion_cfg"]),
        "pds_ckpt", dtype, max_epoch=1, optimization={"max_update": 1},
        dataset={"train_subset": "ftrain", "valid_subset": "fdev", "gen_subset": "fdev",
                 **{k: PDS_BASIS[k] for k in ("max_tokens", "max_source_positions",
                                              "max_target_positions", "num_buckets")}},
        eval=PDS_BASIS["eval"], generation={"results_path": str(root / "pds_gen")})


def phase_pds_cli(root: Path):
    """cli.train trains pds_base_8 in bf16 for one update on phase 14's feature splits,
    validating with eval_wer (beam 1); cli.generate decodes the dev split (beam 5) from
    checkpoint_best.pt in fp32 and hub.from_pretrained transcribes the 4 utterances with
    the longest hypotheses to cli.generate's D- strings."""
    from s2t_tpu_torch.cli import train as cli_train

    cfg = pds_cfg(root)
    task = audio_task(cfg, use_audio=False)
    reset_counts()  # the main path: cli.train, one update and a decoding validation
    t0 = time.perf_counter()
    out = cli_train.main(cfg, task=task, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = out["trainer"].step
    n_valid = len(task.get_batch_iterator(task.datasets["fdev"], max_tokens=cfg.dataset.max_tokens,
                                          seed=1, shuffle=False))
    valids = n_valid * len(out["history"])
    layers = encoder_layers(out["model"].cfg)
    # a step: K1f and K1b per layer, K3 and K4 once; a validation batch: the loss's forward
    # (K1f per layer, K3) and the eval_wer generator's encode
    want = {"attention_fwd": layers * (steps + 2 * valids), "attention_bwd": layers * steps,
            "ctc_alpha": steps + valids, "ctc_beta_grad": steps, "fbank": 0}
    check_counts(counts, want, f"PDS cli.train ({steps} steps, {valids} validation batches)")
    hist = out["history"]
    if not all(np.isfinite(h["loss"]) and np.isfinite(h["wer"]) for h in hist):
        raise AssertionError(f"PDS validation loss or wer is missing or not finite: {hist}")
    log(f"[pds cli] {steps} steps in {wall:.2f} s: train losses "
        f"{[round(r['loss'], 4) for r in out['train_log']]}; validation "
        + "; ".join(f"epoch {h['epoch']}: loss {h['loss']:.4f} wer {h['wer']:.2f}" for h in hist)
        + f"; launches {json.dumps(counts)}")

    gen, text, strings, gen_counts, hub_counts = generate_and_hub(
        root, pds_cfg(root, dtype="float32"), Path(cfg.checkpoint.save_dir) / "checkpoint_best.pt",
        layers, "pds cli")
    res = {"train_steps": steps, "wall_s": wall, "history": hist, "timing": out["timing"],
           "train_losses": [r["loss"] for r in out["train_log"]], "score": text[-1],
           "gen_time_s": gen["gen_time"], "gen_utts_per_s": gen["utts_per_sec"],
           "gen_rtf": gen["rtf"], "hub_strings": strings,
           "launches": {"train": counts, "generate": gen_counts, "hub": hub_counts}}
    return res, {k: counts[k] + gen_counts[k] + hub_counts[k] for k in counts}


# --------------------------------------------------------------------------- #
# phases 19-21: SATE and the Conformer (the recipes' sections; tests/test_torch_sate.py holds
# them to the files)
SATE_MODEL = {"adapter_type": "league", "text_encoder_layers": 6}  # egs/mustc/st/conf/sate.yaml
SATE_CRITERION = ("label_smoothed_cross_entropy_with_ctc",  # sate.yaml's criterion_cfg
                  {"label_smoothing": 0.1, "ctc": {"ctc_weight": 1.0}})
SATE_PDS_8_MODEL = {  # the model section of egs/mustc/st/conf/sate_pds_8.yaml
    "acoustic_encoder": "pds", "pds_stages": 4, "pds_layers": [3, 3, 3, 3],
    "pds_ratios": [2, 2, 1, 2], "pds_embed_dims": [256, 256, 256, 256],
    "pds_kernel_sizes": [5, 5, 5, 5], "pds_ffn_ratios": [8, 8, 8, 8],
    "pds_attn_heads": [4, 4, 4, 4], "pds_position_embed": [1, 1, 1, 1],
    "adapter_type": "inter_league", "text_encoder_layers": 6,
    "acoustic_encoder_embed_norm": True, "acoustic_encoder_no_scale_embedding": True}
CONFORMER_CTC_SMALL = {  # egs/librispeech/asr/conf/ConformerCTCSmall.yaml
    "arch": "s2t_ctc", "criterion": "ctc", "criterion_cfg": {"ctc_weight": 1.0},
    "optimization": {"lr": 1.5e-3, "weight_decay": 1.0e-6},
    "model": {"encoder_embed_dim": 176, "encoder_ffn_embed_dim": 704, "encoder_layers": 16,
              "encoder_attention_heads": 4, "subsampling_type": "conv2d",
              "subsampling_layers": 2, "subsampling_filter": 176, "subsampling_kernel": 3,
              "subsampling_stride": 2, "subsampling_norm": "batch2d",
              "subsampling_activation": "swish", "macaron_style": True, "use_cnn_module": True,
              "cnn_module_kernel": 31, "encoder_attention_type": "rel_pos",
              "encoder_activation_fn": "swish"}}
NO_DROPOUT = {"dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0}
ACOUSTIC_NO_DROPOUT = {f"acoustic_{k}": v for k, v in NO_DROPOUT.items()}  # a SATE preset's


def sate_cfg(model, dtype="float32", **kw):
    """s2t_sate_s at full width with a recipe's model section (V = 10000); ``kw``
    overrides the section."""
    return s2t_sate_s(**{**fields(model), **PDS_S8_FIELDS, "acoustic_dtype_str": dtype, **kw})


def phase_sate_serve():
    """sate.yaml's and sate_pds_8.yaml's models as phases 5-6 serve: fp32 fixture wavs
    card vs CPU at ``shallow``'s depth, bf16 64 x 10 s at the preset's.  Returns
    ({tag: results}, K1f launches)."""
    out, launches = {}, 0
    for tag, model in (("sate", SATE_MODEL), ("sate pds", SATE_PDS_8_MODEL)):
        cfg = sate_cfg(model)
        layers = encoder_layers(cfg)
        if layers != 18:
            raise AssertionError(f"{tag}: {layers} fused-attention layers, expected 12 + 6")
        ref = shallow(cfg)  # the card-vs-CPU serving's depth; phase_speed's is full
        fused_attention.launches = 0
        encodes = phase_serve_parity(ref, tag=f"{tag} serve")
        want = encoder_layers(ref) * encodes
        more, speed = phase_speed(sate_cfg(model, "bfloat16"), tag=f"{tag} speed")
        encodes += more
        want += layers * more
        if fused_attention.launches != want:
            raise AssertionError(f"{tag} serving launched the attention kernel "
                                 f"{fused_attention.launches} times for {encodes} encodes, "
                                 f"expected {want}")
        launches += fused_attention.launches
        out[tag] = {**speed, "encodes": encodes, "k1f_launches": fused_attention.launches}
        log(f"[{tag} serve] attention_fwd launches {fused_attention.launches} over {encodes} "
            f"encodes ({layers} per encode: 12 acoustic + 6 textual)")
    return out, launches


def audio_cli_cfg(root: Path, arch, model, criterion, tag, dtype, optimization=None,
                  generation=None):
    """A cli.train config on phase 11's wav corpus that decodes phase 14's feature split:
    one update and its validation (one batch of the 16 dev utterances), since phase 11
    drives raw-audio training through the CLI for epochs and a resume."""
    return train_cfg(root, arch, model, criterion, f"{tag}_ckpt", dtype, max_epoch=1,
                     dataset={"gen_subset": "fdev"},
                     optimization={**(optimization or {}), "max_update": 1},
                     generation={"results_path": str(root / f"{tag}_gen"), **(generation or {})})


def phase_audio_cli(cfg, tag: str, ctc_step: int = 1, ctc_valid: int = 1):
    """cli.train from raw audio (K5 in every forward, then utterance CMVN + SpecAugment)
    for ``cfg``'s epochs with validation; checks the launches, and that the losses are
    finite.  Returns (results, launches, fused-attention layers, task)."""
    from s2t_tpu_torch.cli import train as cli_train

    task = audio_task(cfg)
    reset_counts()  # the main path: cli.train from raw audio
    t0 = time.perf_counter()
    out = cli_train.main(cfg, task=task, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps, epochs = out["trainer"].step, cfg.optimization.max_epoch
    n_valid = len(task.get_batch_iterator(task.datasets[cfg.dataset.valid_subset],
                                          max_tokens=cfg.dataset.max_tokens,
                                          seed=cfg.common.seed, shuffle=False))
    layers = encoder_layers(out["model"].cfg)
    check_counts(counts, path_counts(steps, steps + n_valid * len(out["history"]), layers,
                                     ctc_step, ctc_valid),
                 f"{tag} cli.train ({steps} steps, {len(out['history'])} validations of "
                 f"{n_valid} batch)")
    losses = [r["loss"] for r in out["train_log"]]
    valid = [h["loss"] for h in out["history"]]
    if not (np.isfinite(losses).all() and np.isfinite(valid).all()):
        raise AssertionError(f"{tag}: losses not finite: train {losses}, valid {valid}")
    res = {"train_steps": steps, "wall_s": wall, "valid_batches": n_valid,
           "train_losses": losses, "valid_losses": valid, "timing": out["timing"],
           "train_log": out["train_log"], "launches": counts}
    log(f"[{tag} cli] {epochs} epochs from raw audio, {steps} steps in {wall:.2f} s: train "
        f"losses {[round(x, 4) for x in losses]}, valid {[round(x, 4) for x in valid]}; "
        f"launches {json.dumps(counts)}")
    return res, counts, layers, task


def phase_sate_train(root: Path):
    """(a) sate.yaml's model fp32 card vs CPU; (b) bf16 at the bench shape; (c) cli.train
    with sate.yaml from raw audio, cli.generate and from_pretrained."""
    parity, parity_launches = phase_train_parity(
        shallow(sate_cfg(SATE_MODEL, **ACOUSTIC_NO_DROPOUT)),
        S2TSATEModel, "sate train", criterion=SATE_CRITERION)
    speed, speed_launches = phase_train_speed(sate_cfg(SATE_MODEL, "bfloat16"), S2TSATEModel,
                                              "sate train speed", n_timed=EARLIER_TIMED,
                                              criterion=SATE_CRITERION)
    cli, cli_launches, layers, _ = phase_audio_cli(
        audio_cli_cfg(root, "s2t_sate_s", SATE_MODEL, SATE_CRITERION, "sate", "bfloat16"), "sate")
    gen, text, strings, gen_counts, hub_counts = generate_and_hub(
        root, audio_cli_cfg(root, "s2t_sate_s", SATE_MODEL, SATE_CRITERION, "sate", "float32"),
        root / "sate_ckpt" / "checkpoint_best.pt", layers, "sate cli")
    cli.update({"score": text[-1], "gen_time_s": gen["gen_time"], "gen_rtf": gen["rtf"],
                "hub_strings": strings, "generate_launches": gen_counts,
                "hub_launches": hub_counts})
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] + cli_launches[k]
                + gen_counts[k] + hub_counts[k] for k in counters()}
    return {"parity": parity, "speed": speed, "cli": cli}, launches


def phase_conformer(root: Path):
    """s2t_conformer served as phases 5-6 (rel_pos: no K1f; the card-vs-CPU decode at
    ``shallow``'s depth); ConformerCTCSmall's model fp32 card vs CPU for 2 steps at that
    depth, through cli.train from raw audio, and served as phase 13.  Returns (results,
    launches)."""
    from s2t_tpu_torch.models.s2t_ctc import S2TCTCModel, s2t_ctc_base

    fused_attention.launches = 0
    cfg = shallow(s2t_conformer(**PDS_S8_FIELDS))  # the card-vs-CPU serving's depth
    encodes = phase_serve_parity(cfg, tag="conformer serve")
    more, speed = phase_speed(s2t_conformer(**PDS_S8_FIELDS, dtype_str="bfloat16"),
                              tag="conformer speed")
    if fused_attention.launches:
        raise AssertionError(f"the rel_pos encoder launched K1f {fused_attention.launches} times")
    model, crit = fields(CONFORMER_CTC_SMALL["model"]), (
        CONFORMER_CTC_SMALL["criterion"], {**CONFORMER_CTC_SMALL["criterion_cfg"],
                                           "zero_infinity": True})
    parity, parity_launches = phase_train_parity(
        shallow(s2t_ctc_base(**model, **PDS_S8_FIELDS, **NO_DROPOUT)), S2TCTCModel,
        "conformer ctc train", criterion=crit)
    cli, cli_launches, _, _ = phase_audio_cli(
        audio_cli_cfg(root, "s2t_ctc", CONFORMER_CTC_SMALL["model"], crit, "conformer",
                       "bfloat16", CONFORMER_CTC_SMALL["optimization"]), "conformer ctc")
    serve_ctc, serve_ctc_launches = phase_nast(s2t_ctc_base, model, "conformer ctc")
    launches = {k: parity_launches.get(k, 0) + cli_launches[k] + serve_ctc_launches[k]
                for k in counters()}
    return {"serve_encodes": encodes + more, "speed": speed, "ctc_parity": parity,
            "ctc_cli": cli, "ctc_serve": serve_ctc}, launches


# --------------------------------------------------------------------------- #
# phases 22-24: the CTC research stack (the recipes' sections; tests/test_torch_nast.py
# holds them to the files)
NAST_CRITERION = ("ctc", {"ctc_weight": 1.0, "inter_ctc_weight": 0.5,  # reproduction_nast.yaml
                          "xctc_weight": 1.0})
BIL_CTC_MODEL = {  # the model section of egs/mustc/st/conf/reproduction_bil_ctc.yaml
    "inter_ctc_layers": [4], "ctc_pae": "inter_league", "use_xctc": True,
    "inter_xctc_layers": [8], "xctc_pae": "inter_league", "xctc_pae_ground_truth_ratio": 0.3}
BIL_CTC_CRITERION = ("label_smoothed_cross_entropy_with_ctc", {  # its criterion_cfg over basis
    "label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3, "inter_ctc_weight": 0.2,
                                    "xctc_weight": 0.3, "inter_xctc_weight": 0.2}})
AIPA = {  # egs/librispeech/asr/conf/reproduction_purectc_aipa_kd.yaml
    "arch": "s2t_ctc", "criterion": "ctc",
    "criterion_cfg": {"ctc_weight": 1.0, "inter_ctc_weight": 1.0, "zero_infinity": True,
                      "ctc_mixup_consistent_weight": 0.15,
                      "inter_ctc_mixup_consistent_weight": 0.1},
    "model": {"encoder_layers": 18, "macaron_style": True, "use_cnn_module": True,
              "cnn_module_kernel": 15, "encoder_attention_type": "rel_pos",
              "encoder_activation_fn": "swish", "inter_mixup": True, "inter_mixup_layer": 0,
              "inter_mixup_prob": 1.0, "inter_mixup_ratio": 1.0, "inter_mixup_beta": 0.2,
              "inter_mixup_keep_org": True, "inter_mixup_ratio_decay": False,
              "inter_mixup_ratio_decay_params": [20000, 40000, 0],
              "inter_ctc_layers": [6, 9, 12, 15], "share_inter_ctc": True,
              "share_ctc_and_embed": True, "ctc_pae": "inter_league", "pae_unnorm_input": True}}
# CTC terms of a step: NAST's CTC, 3 inter taps and XCTC; BiL-CTC's CTC, inter-CTC, XCTC and
# inter-XCTC; AIPA's CTC and 4 inter taps, each twice under mixup (once without, in eval)
NAST_TERMS, BIL_CTC_TERMS, AIPA_TERMS = 5, 4, 10
# BiL-CTC's fp32 parity targets: 160 tokens, so XCTC's lattice has S = 319 states and takes
# K3's CTA-wide kernel (S > 256) on the main path; its bf16 bench targets: 64 (S = 127)
BIL_CTC_PARITY_U, BIL_CTC_BENCH_U = 160, 64
STACK_TIMED_STEPS = 2


def alignment_card_vs_cpu(B=8, T=250, U=60, V=10000, seed=10):
    """The oracle's Viterbi (``ctc_best_alignment``, a plain PyTorch loop over T on both
    devices) on the same CPU-made log-probs on the card and on the CPU: max, compare and
    add are exact in fp32, so the states must be equal; and its time on the card."""
    from s2t_tpu_torch.ops.ctc import ctc_best_alignment

    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(B, T, V, generator=g) * 3, dim=-1)
    labels = torch.randint(3, V, (B, U), generator=g)
    in_len = torch.randint(U + 2, T + 1, (B,), generator=g)
    lab_len = torch.randint(U // 2, U + 1, (B,), generator=g)
    host = ctc_best_alignment(lp, labels, in_len, lab_len)
    args = [t.cuda() for t in (lp, labels, in_len, lab_len)]
    card = ctc_best_alignment(*args)
    same = all(torch.equal(c.cpu(), h) for c, h in zip(card, host))
    res = {"B": B, "T": T, "U": U, "V": V, "identical": same,
           "ms": cuda_ms(lambda: ctc_best_alignment(*args), iters=3, warmup=1)}
    log(f"[stack] ctc_best_alignment card vs CPU on the same log-probs: {json.dumps(res)}")
    if not same:
        raise AssertionError("the Viterbi alignment differs between the card and the CPU")
    return res


def phase_stack_nast():
    """s2t_nast (reproduction_nast.yaml, V = 10000): bf16 XCTC greedy serving at the NAST
    shape with the encode split by stack part, fp32 fixture wavs card vs CPU greedy, beam
    5 and self-ensemble; fp32 training card vs CPU and bf16 at the bench shape."""
    from s2t_tpu_torch.models.s2t_ctc import S2TCTCModel, s2t_nast

    serve, serve_launches = phase_nast(s2t_nast, None, "s2t_nast", use_xctc=True, ensemble=True)
    per_step = step_launches(s2t_nast(), NAST_TERMS)
    ref = shallow(s2t_nast(**PDS_S8_FIELDS, **NO_DROPOUT))
    parity, parity_launches = phase_train_parity(
        ref, S2TCTCModel, "s2t_nast train", criterion=NAST_CRITERION,
        per_step=step_launches(ref, NAST_TERMS), log_keys=("inter_ctc_loss", "xctc_loss"))
    speed, speed_launches = phase_train_speed(
        s2t_nast(**PDS_S8_FIELDS, dtype_str="bfloat16"), S2TCTCModel, "s2t_nast train speed",
        n_timed=STACK_TIMED_STEPS, criterion=NAST_CRITERION, per_step=per_step)
    launches = {k: serve_launches[k] + parity_launches.get(k, 0) + speed_launches[k]
                for k in counters()}
    return {"serve": serve, "parity": parity, "speed": speed}, launches


def phase_stack_bil_ctc():
    """BiL-CTC (reproduction_bil_ctc.yaml on s2t_transformer_s, V = 10000): the oracle's
    Viterbi card vs CPU; fp32 training card vs CPU with the oracle (its mask drawn on the
    host) and targets long enough for K3's CTA-wide kernel; bf16 at the bench shape with
    each CTC term's device ms; K3 / K4 at its XCTC shape; fp32 beam-5 serving card vs CPU."""
    model = fields(BIL_CTC_MODEL)
    per_step = step_launches(s2t_transformer_s(**model), BIL_CTC_TERMS)
    align = alignment_card_vs_cpu()
    ref = shallow(s2t_transformer_s(**model, **PDS_S8_FIELDS, **NO_DROPOUT))
    parity, parity_launches = phase_train_parity(
        ref, S2TTransformerModel, "bil_ctc train", criterion=BIL_CTC_CRITERION,
        per_step=step_launches(ref, BIL_CTC_TERMS), U=BIL_CTC_PARITY_U,
        log_keys=("inter_ctc_loss", "xctc_loss", "inter_xctc_loss"))
    speed, speed_launches = phase_train_speed(
        s2t_transformer_s(**model, **PDS_S8_FIELDS, dtype_str="bfloat16"), S2TTransformerModel,
        "bil_ctc train speed", n_timed=STACK_TIMED_STEPS, U=BIL_CTC_BENCH_U,
        criterion=BIL_CTC_CRITERION, per_step=per_step)
    xctc = ctc_case(40, 250, BIL_CTC_BENCH_U - 1, 10000, seed=9, time_it=True)
    log(f"[bil_ctc] K3 / K4 at the XCTC shape: {json.dumps(xctc)}")
    if not (xctc["alpha_err"] <= CTC_ATOL["alpha"] and xctc["nll_err"] <= CTC_ATOL["alpha"]
            and xctc["demit_err"] <= CTC_ATOL["demit"] and xctc["unreached_agree"]
            and xctc["infeasible_nll_over_5e29"]):
        raise AssertionError(f"CTC kernels disagree with their plain versions: {xctc}")
    fused_attention.launches = 0
    serve_cfg = shallow(s2t_transformer_s(**model, **PDS_S8_FIELDS))
    encodes = phase_serve_parity(serve_cfg, tag="bil_ctc serve")
    if fused_attention.launches != encoder_layers(serve_cfg) * encodes:
        raise AssertionError(f"BiL-CTC serving launched K1f {fused_attention.launches} times for "
                             f"{encodes} encodes, expected {encoder_layers(serve_cfg)} each")
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] for k in counters()}
    launches["attention_fwd"] += fused_attention.launches
    return {"alignment": align, "parity": parity, "speed": speed, "xctc_shape": xctc,
            "serve_encodes": encodes}, launches


def phase_stack_aipa(root: Path):
    """AIPA (reproduction_purectc_aipa_kd.yaml: a Conformer s2t_ctc, 18 x 256 rel_pos, 4
    shared inter-CTC taps with the inter_league PAE, keep_org mixup at ratio 1, the
    mixup-consistency losses): fp32 training card vs CPU with the host draws, bf16 at the
    bench shape (the batch doubles), cli.train from phase 11's wavs for 2 epochs,
    cli.generate greedy and from_pretrained."""
    from s2t_tpu_torch.models.s2t_ctc import S2TCTCModel, s2t_ctc_base

    model, crit = fields(AIPA["model"]), (AIPA["criterion"], AIPA["criterion_cfg"])
    per_step = step_launches(s2t_ctc_base(**model), AIPA_TERMS)  # rel_pos: no K1f / K1b
    parity, parity_launches = phase_train_parity(
        shallow(s2t_ctc_base(**model, **PDS_S8_FIELDS, **NO_DROPOUT)), S2TCTCModel,
        "aipa train", criterion=crit, per_step=per_step,
        log_keys=("inter_ctc_loss", "ctc_mixup_consistent_loss",
                  "inter_ctc_mixup_consistent_loss"))
    speed, speed_launches = phase_train_speed(
        s2t_ctc_base(**model, **PDS_S8_FIELDS, dtype_str="bfloat16"), S2TCTCModel,
        "aipa train speed", n_timed=STACK_TIMED_STEPS, criterion=crit, per_step=per_step)
    gen_cfg = {"beam": 1}
    cli, cli_launches, layers, _ = phase_audio_cli(
        audio_cli_cfg(root, AIPA["arch"], AIPA["model"], crit, "aipa", "bfloat16",
                      generation=gen_cfg), "aipa", ctc_step=AIPA_TERMS, ctc_valid=AIPA_TERMS // 2)
    gen, text, strings, gen_counts, hub_counts = generate_and_hub(
        root, audio_cli_cfg(root, AIPA["arch"], AIPA["model"], crit, "aipa", "float32",
                            generation=gen_cfg),
        root / "aipa_ckpt" / "checkpoint_best.pt", layers, "aipa cli")
    cli.update({"score": text[-1], "gen_time_s": gen["gen_time"], "gen_rtf": gen["rtf"],
                "hub_strings": strings, "generate_launches": gen_counts,
                "hub_launches": hub_counts})
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] + cli_launches[k]
                + gen_counts[k] + hub_counts[k] for k in counters()}
    return {"parity": parity, "speed": speed, "cli": cli}, launches


# --------------------------------------------------------------------------- #
# phases 25-27: the rest of the CTC research stack (the recipes' sections;
# tests/test_torch_ctc_aug.py holds them to the files)
CTC_AUG_MODEL = {  # the model section of egs/mustc/st/conf/reproduction_ctc_aug.yaml
    "acoustic_encoder_layers": 12, "acoustic_macaron_style": True,
    "acoustic_use_cnn_module": True, "acoustic_cnn_module_kernel": 15,
    "acoustic_encoder_attention_type": "rel_pos", "acoustic_encoder_activation_fn": "swish",
    "acoustic_encoder_embed_norm": True, "acoustic_encoder_no_scale_embedding": True,
    "acoustic_inter_ctc_layers": [6, 9], "acoustic_share_inter_ctc": True,
    "acoustic_ctc_pae": "inter_league", "acoustic_pae_unnorm_input": True,
    "acoustic_dropout": 0.15, "adapter_type": "inter_league", "text_encoder_layers": 6,
    "text_no_pos_emb": True, "textual_encoder_embed_norm": False,
    "textual_encoder_no_scale_embedding": True, "inter_xctc_layers": [4],
    "xctc_pae": "inter_league", "pae_unnorm_input": True, "xctc_pae_ground_truth_ratio": 0.5,
    "xctc_pae_ground_truth_only_mistake": True, "pae_oracle_smooth": True,
    "xctc_cross_attn": True, "cross_attn_start_layer": 3, "cross_attn_layer": 2,
    "cross_attn_collaboration_mode": "serial", "cross_attn_league_drop_net": True,
    "cross_attn_league_drop_net_prob": 0.1}
CTC_AUG_CRITERION = ("label_smoothed_cross_entropy_with_ctc", {  # its criterion_cfg over basis
    "label_smoothing": 0.1, "ctc": {"ctc_weight": 0.2, "inter_ctc_weight": 0.1,
                                    "xctc_weight": 0.2, "inter_xctc_weight": 0.1}})
NAST_PDS_BIG = {  # egs/mustc/st/conf/nast_pds_big.yaml
    "arch": "s2t_ctc_sate", "criterion": "ctc",
    "criterion_cfg": {"ctc_weight": 1.0, "xctc_weight": 1.0, "zero_infinity": True},
    "model": {"acoustic_encoder": "pds", "acoustic_encoder_embed_dim": 512,
              "acoustic_dropout": 0.15, "pds_stages": 4, "pds_layers": [3, 3, 3, 3],
              "pds_ratios": [2, 2, 1, 2], "pds_embed_dims": [512, 512, 512, 512],
              "pds_kernel_sizes": [5, 5, 5, 5], "pds_ffn_ratios": [4, 4, 4, 4],
              "pds_attn_heads": [8, 8, 8, 8], "pds_position_embed": [1, 1, 1, 1],
              "adapter_type": "none", "text_encoder_layers": 12, "text_attention_heads": 8,
              "text_use_xctc": True, "text_no_pos_emb": True}}
CTC_AUG_PDS_BIG_MODEL = {  # the model section of egs/mustc/st/conf/ctc_aug_pds_big.yaml
    **{k: v for k, v in NAST_PDS_BIG["model"].items() if k != "text_no_pos_emb"},
    "acoustic_decoder_embed_dim": 512, "acoustic_decoder_ffn_embed_dim": 4096,
    "acoustic_decoder_attention_heads": 8, "xctc_cross_attn": True,
    "cross_attn_start_layer": 7, "cross_attn_layer": 6}
PDS_BASE_8_444 = {  # egs/mustc/st/conf/pds_base_8_444.yaml (its arch and model section)
    "arch": "pdss2t_transformer_s",
    "model": {"pds_stages": 3, "pds_ratios": [2, 2, 2], "pds_layers": [4, 4, 4],
              "pds_kernel_sizes": [5, 5, 5], "pds_embed_dims": [256, 256, 256],
              "pds_attn_heads": [4, 4, 4], "pds_ffn_ratios": [8, 8, 8],
              "pds_position_embed": [1, 1, 1], "pds_ctc": [0, 0, 0]}}
# phase 27's overrides: every stage tapped (the shared head and PAE), XCTC taps at stages 1-2
# with the shared head and xpae, and XCTC on the output; then the heads at inner layers
PDS_TAPS = {"pds_ctc": [1, 1, 1], "pds_xctc": [0, 1, 1], "ctc_pae": "inter_league",
            "xctc_pae": "inter_league", "use_xctc": True}
PDS_INNER_HEADS = {"ctc_layer": 8, "xctc_layer": 10}
PDS_TAPS_CRITERION = ("label_smoothed_cross_entropy_with_ctc", {
    "label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3, "inter_ctc_weight": 0.2,
                                    "xctc_weight": 0.3, "inter_xctc_weight": 0.2}})
# CTC terms of a step: CTC-Aug's CTC, inter-CTC at 6 and 9, XCTC and inter-XCTC at 4;
# nast_pds_big's CTC and XCTC; phase 27's CTC, 3 stage taps, XCTC and 2 stage taps
CTC_AUG_TERMS, NAST_PDS_BIG_TERMS, PDS_TAPS_TERMS = 5, 2, 7
SCORE_RTOL = 1e-5  # Jacobi's one teacher-forced scoring pass vs the beam's cached steps
IMPUTER_RTOL = 1e-4  # the imputer NLL card vs CPU: TRAIN_RTOL's ctc_loss


def phase_ctc_aug():
    """CTC-Aug (reproduction_ctc_aug.yaml, V = 10000): fp32 beam-5 serving card vs CPU, bf16
    64 x 10 s with the encode split acoustic / adapter / textual self- and s2-attention;
    fp32 training card vs CPU with the XCTC oracle on (its mask drawn on the host); bf16 at
    the bench shape with each CTC term's device ms and the oracle Viterbi's ms."""
    cfg = sate_cfg(CTC_AUG_MODEL)
    layers = encoder_layers(cfg)
    if layers != 10:  # rel_pos acoustic: none; textual: 6 self + 4 s2 (layers 3-6)
        raise AssertionError(f"CTC-Aug: {layers} fused-attention calls an encode, expected 10")
    per_step = step_launches(cfg, CTC_AUG_TERMS)
    ref = shallow(cfg)  # the card-vs-CPU runs' depth: the acoustic encoder cut
    fused_attention.launches = 0  # the main path: serving
    encodes = phase_serve_parity(ref, tag="ctc_aug serve")
    want = encoder_layers(ref) * encodes
    more, speed = phase_speed(sate_cfg(CTC_AUG_MODEL, "bfloat16"), tag="ctc_aug speed")
    encodes += more
    want += layers * more
    if fused_attention.launches != want:
        raise AssertionError(f"CTC-Aug serving launched K1f {fused_attention.launches} times "
                             f"for {encodes} encodes, expected {want}")
    serve_launches = fused_attention.launches
    log(f"[ctc_aug serve] attention_fwd launches {serve_launches} over {encodes} encodes "
        f"({layers} per encode: 6 textual self-attention + 4 s2-attention)")
    log_keys = ("inter_ctc_loss", "xctc_loss", "inter_xctc_loss")
    ref32 = shallow(sate_cfg(CTC_AUG_MODEL, **ACOUSTIC_NO_DROPOUT))
    parity, parity_launches = phase_train_parity(
        ref32, S2TSATEModel, "ctc_aug train", criterion=CTC_AUG_CRITERION,
        per_step=step_launches(ref32, CTC_AUG_TERMS), log_keys=log_keys)
    with viterbi_calls() as viterbi:
        train, train_launches = phase_train_speed(
            sate_cfg(CTC_AUG_MODEL, "bfloat16"), S2TSATEModel, "ctc_aug train speed",
            n_timed=STACK_TIMED_STEPS, criterion=CTC_AUG_CRITERION, per_step=per_step)
    train["oracle_viterbi_calls"] = viterbi["calls"]
    if viterbi["calls"] < STACK_TIMED_STEPS + 2:  # one a step at least
        raise AssertionError(f"the bf16 CTC-Aug steps ran the oracle Viterbi "
                             f"{viterbi['calls']} times")
    launches = {k: parity_launches.get(k, 0) + train_launches[k] for k in counters()}
    launches["attention_fwd"] += serve_launches
    return {"serve_encodes": encodes, "speed": speed, "parity": parity, "train": train,
            "launches_per_encode": layers, "launches_per_step": per_step}, launches


def phase_nast_pds_big():
    """SATE over PDS with XCTC: nast_pds_big.yaml greedy CTC serving through the task's
    generator (the acoustic head: SATEConfig has no use_xctc, as in JAX) and through
    CTCGenerator(use_xctc=True), fp32 training card vs CPU; ctc_aug_pds_big.yaml fp32
    beam-5 serving card vs CPU (30 K1f an encode)."""
    from s2t_tpu_torch.models.s2t_ctc import S2TCTCModel, s2t_ctc_sate

    model = fields(NAST_PDS_BIG["model"])
    task_xctc = getattr(s2t_ctc_sate(**model), "use_xctc", False)
    serve, launches = {}, {k: 0 for k in counters()}
    for use_xctc in (task_xctc, True):
        tag = "nast_pds_big " + ("xctc" if use_xctc else "task generator")
        res, got = phase_nast(s2t_ctc_sate, model, tag, use_xctc=use_xctc)
        serve[tag] = res
        launches = {k: launches[k] + got[k] for k in counters()}
    cfg32 = shallow(s2t_ctc_sate(**{**model, **PDS_S8_FIELDS, **ACOUSTIC_NO_DROPOUT}))
    parity, parity_launches = phase_train_parity(
        cfg32, S2TCTCModel, "nast_pds_big train",
        criterion=(NAST_PDS_BIG["criterion"], NAST_PDS_BIG["criterion_cfg"]),
        per_step=step_launches(cfg32, NAST_PDS_BIG_TERMS), log_keys=("xctc_loss",))
    aug = sate_cfg(CTC_AUG_PDS_BIG_MODEL)
    if encoder_layers(aug) != 30:  # PDS 12, textual 12 self + 6 s2 (layers 7-12)
        raise AssertionError(f"ctc_aug_pds_big: {encoder_layers(aug)} fused-attention calls "
                             f"an encode")
    aug = shallow(aug)  # the card-vs-CPU serving's depth: the PDS stages one layer each
    layers = encoder_layers(aug)
    fused_attention.launches = 0  # the main path: serving
    encodes = phase_serve_parity(aug, tag="ctc_aug_pds_big serve")
    if fused_attention.launches != layers * encodes:
        raise AssertionError(f"ctc_aug_pds_big serving launched K1f {fused_attention.launches} "
                             f"times for {encodes} encodes, expected {layers} each")
    launches = {k: launches[k] + parity_launches.get(k, 0) for k in counters()}
    launches["attention_fwd"] += fused_attention.launches
    return {"serve": serve, "task_generator_use_xctc": task_xctc, "parity": parity,
            "ctc_aug_pds_big_encodes": encodes,
            "ctc_aug_pds_big_launches_per_encode": layers}, launches


def imputer_card_vs_cpu(B=8, T=250, U=60, V=10000, seed=11):
    """``imputer_loss`` (``ctc_loss`` over emissions masked to the forced states: K3 and
    K4 on the card) forced on the Viterbi states of CPU-made log-probs at every third frame
    (the rest free: forced at every frame, the lattice holds one path and the sums are
    exact): the NLL and its gradient on the card and on the CPU, and its time on the card
    (forward and backward).  Returns (results, the card run's launches: one K3 and one
    K4)."""
    from s2t_tpu_torch.ops.ctc import ctc_best_alignment, ctc_loss, imputer_loss

    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(B, T, V, generator=g) * 3, dim=-1)
    labels = torch.randint(3, V, (B, U), generator=g)
    in_len = torch.randint(U + 2, T + 1, (B,), generator=g)
    lab_len = torch.randint(U // 2, U + 1, (B,), generator=g)
    _, states = ctc_best_alignment(lp, labels, in_len, lab_len)
    states = torch.where(torch.arange(T)[None, :] % 3 == 0, states, -1)

    def run(device):
        x = lp.detach().to(device).requires_grad_()
        args = [t.to(device) for t in (labels, states, in_len, lab_len)]
        nll = imputer_loss(x, *args, reduction="none")
        nll.sum().backward()
        return nll.detach().cpu(), x.grad.cpu(), x, args

    host, host_grad, _, _ = run("cpu")
    reset_counts()  # the main path: one imputer loss forward and backward on the card
    card, card_grad, x, args = run("cuda")
    launches = read_counts()
    if launches["ctc_alpha"] != 1 or launches["ctc_beta_grad"] != 1:
        raise AssertionError(f"imputer_loss did not run K3 and K4 once each: {launches}")
    free = ctc_loss(lp, labels, in_len, lab_len, reduction="none")
    res = {"B": B, "T": T, "U": U, "V": V, "nll_rel_err": rel_err(card, host),
           "grad_max_abs_err": (card_grad - host_grad).abs().max().item(),
           "forced_minus_free_nll_min": (host - free).min().item(),
           "ms": cuda_ms(lambda: imputer_loss(x, *args).backward(), iters=3, warmup=1)}
    log(f"[pds taps] imputer_loss card vs CPU, a third of the frames forced to the Viterbi "
        f"states: {json.dumps(res)}")
    if not (res["nll_rel_err"] <= IMPUTER_RTOL and res["grad_max_abs_err"] <= CTC_ATOL["demit"]
            and res["forced_minus_free_nll_min"] >= -1e-3):
        raise AssertionError(f"imputer_loss disagrees between the card and the CPU: {res}")
    return res, launches


def jacobi_card():
    """generation.jacobi's JacobiGenerator on s2t_transformer_s (fp32, V = 10000) against
    the sequential beam-1 generator on the card: the same tokens and scores; the passes
    the fixpoint took.  Returns (results, K1f launches: one encode each)."""
    from s2t_tpu_torch.inference.generator import SequenceGenerator
    from s2t_tpu_torch.inference.jacobi import JacobiGenerator

    model = S2TTransformerModel(s2t_transformer_s(**PDS_S8_FIELDS), device="cuda", seed=0)
    batch = GeneratorHub(model, None)._speech_batch(WAVS)
    kw = dict(max_len_a=0.0, max_len_b=GEN["max_len_b"], max_target_positions=1024)
    jac, out = JacobiGenerator(model, **kw), {}
    fused_attention.launches = 0  # the main path: one Jacobi generation
    jac_s = synced_s(lambda: out.update(jacobi=jac.generate(batch)))
    if fused_attention.launches != 12:
        raise AssertionError(f"a Jacobi generation launched K1f {fused_attention.launches} times")
    greedy_s = synced_s(lambda: out.update(
        greedy=SequenceGenerator(model, beam_size=1, **kw).generate(batch)))
    (jt, js, _), (gt, gs, _) = out["jacobi"], out["greedy"]

    def upto_eos(row):
        row = row.tolist()
        return row[:row.index(2) + 1] if 2 in row else row

    same = [upto_eos(a) == upto_eos(b) for a, b in zip(jt[:, 0].cpu(), gt[:, 0].cpu())]
    score_err = ((js - gs).abs() / gs.abs().clamp(min=1.0)).max().item()
    res = {"tokens_identical": same, "score_rel_err": score_err, "passes": jac.last_iters,
           "lengths": [len(upto_eos(r)) for r in jt[:, 0].cpu()], "jacobi_s": jac_s,
           "greedy_s": greedy_s}
    log(f"[pds taps] Jacobi vs beam-1 on the card: {json.dumps(res)}")
    if not all(same) or not score_err <= SCORE_RTOL:
        raise AssertionError(f"Jacobi decoding differs from beam-1 decoding: {res}")
    return res, 12


def phase_pds_taps():
    """pds_base_8_444.yaml with every stage tap (CTC, PAE, XCTC, xpae, XCTC on the output)
    fp32 training card vs CPU, at ctc_layer 0 and with the heads at inner layers;
    imputer_loss card vs CPU; Jacobi decoding against beam 1 on the card."""
    from s2t_tpu_torch.models.pds import pdss2t_transformer_s_16

    base = {**fields(PDS_BASE_8_444["model"]), **fields(PDS_TAPS), **PDS_S8_FIELDS,
            **NO_DROPOUT}
    out, launches = {}, {k: 0 for k in counters()}
    for tag, extra in (("pds taps", {}), ("pds taps inner heads", PDS_INNER_HEADS)):
        cfg = pdss2t_transformer_s_16(**{**base, **extra})
        res, got = phase_train_parity(
            cfg, PDSS2TTransformerModel, tag, criterion=PDS_TAPS_CRITERION,
            per_step=step_launches(cfg, PDS_TAPS_TERMS),
            log_keys=("inter_ctc_loss", "xctc_loss", "inter_xctc_loss"))
        out[tag] = res
        launches = {k: launches[k] + got.get(k, 0) for k in counters()}
    out["imputer"], imputer_launches = imputer_card_vs_cpu()
    launches = {k: launches[k] + imputer_launches[k] for k in counters()}
    out["jacobi"], jacobi_launches = jacobi_card()
    launches["attention_fwd"] += jacobi_launches
    return out, launches


# --------------------------------------------------------------------------- #
# phases 28-29: the encoder variants (ROADMAP item 7); tests/test_torch_variants_recipes.py
# holds these copies to the recipe files
VARIANT_RECIPES = {  # name -> (arch, model section); an overlay runs on s2t_transformer_s
    "dlcl": ("s2t_transformer_s", {"use_enc_dlcl": True}),  # egs/*/*/conf/dlcl.yaml
    "relative": ("s2t_transformer_s_relative", {}),  # egs/mustc/st/conf/relative.yaml
    "local_attn": ("s2t_transformer_s", {  # egs/librispeech/asr/conf/local_attn.yaml
        "encoder_attention_type": "local", "hard_mask_window": 0, "gauss_mask_sigma": 3,
        "init_mask_weight": 0}),
    "dynamic": ("s2t_dynamic_transformer_s", {}),  # egs/mustc/st/conf/dynamic.yaml
}
# rope has no recipe of its own: an overlay on s2t_transformer_s
VARIANT_OVERLAYS = {"rope": ("s2t_transformer_s", {"encoder_attention_type": "rope"})}
# K1f launches an encode (K1b a step): 12 layers under DLCL and rope, none in the dense
# Shaw-relative and Gaussian attention and the dynamic convolutions
VARIANT_K1F = {"dlcl": 12, "relative": 0, "local_attn": 0, "dynamic": 0, "rope": 12}
EFFICIENT_CONFORMER_SMALL = {  # egs/librispeech/asr/conf/EffecientConformerCTCSmall.yaml
    "arch": "s2t_ctc_pds", "criterion": "ctc", "criterion_cfg": {"ctc_weight": 1.0},
    "model": {"pds_stages": 3, "pds_ratios": [-1, 0, 0], "pds_layers": [5, 5, 5],
              "pds_kernel_sizes": [3, 3, 3], "pds_embed_dims": [120, 168, 240],
              "pds_attn_heads": [4, 4, 4], "pds_ffn_ratios": [4, 4, 4],
              "pds_position_embed": [1, 1, 1], "pds_conv_strides": [2, 2, 1],
              "encoder_embed_dim": 240, "subsampling_type": "conv2d", "subsampling_layers": 1,
              "subsampling_filter": 120, "subsampling_kernel": 3, "subsampling_stride": 2,
              "subsampling_norm": "batch2d", "subsampling_activation": "swish",
              "macaron_style": True, "use_cnn_module": True, "cnn_module_kernel": 15,
              "encoder_attention_type": "rel_pos", "encoder_activation_fn": "swish"}}
VARIANT_SPLIT_SHAPE = dict(B=64, T=1000)  # the encode split: 64 x 10 s of bf16 frames


def variant_encode_split(cfg, tag):
    """One bf16 encode of VARIANT_SPLIT_SHAPE random frames after a warm-up, timed (the
    device ms of its self-attention sublayers, which a profile split out, are in
    PERF.md)."""
    B, T = VARIANT_SPLIT_SHAPE["B"], VARIANT_SPLIT_SHAPE["T"]
    model = S2TTransformerModel(cfg.replace(dtype_str="bfloat16"), device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.randn((B, T, 80), generator=g, device="cuda")
    lens = torch.full((B,), T, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        model.encode(feats, lens)
        encode_s = synced_s(lambda: model.encode(feats, lens))
    res = {"batch": B, "frames": T, "encode_s": encode_s}
    log(f"[{tag} split] bf16 encode: {json.dumps(res)}")
    return res


def phase_variants():
    """Phase 28: dlcl.yaml, relative.yaml, local_attn.yaml, dynamic.yaml and the rope
    overlay at full s width (V=10000): fp32 fixture wavs card vs CPU, beam 5 (the relative
    decoder's self-attention in the beam's cached steps), and 2 fp32 Trainer steps card vs
    CPU at REF_LAYERS a side; the timed bf16 encode at the preset's 12 x 256; K1f / K1b
    launch VARIANT_K1F times a full encode, scaled by the depth.  Returns (results,
    launches)."""
    out, launches = {}, {k: 0 for k in counters()}
    for name, (arch, model) in {**VARIANT_RECIPES, **VARIANT_OVERLAYS}.items():
        cfg = ARCHS.get(arch)[1](**fields(model), **PDS_S8_FIELDS)
        ref = cfg.replace(**REF_DEPTH)  # the card-vs-CPU runs' depth; the split's is full
        layers = VARIANT_K1F[name]
        ref_layers = layers * REF_LAYERS // cfg.encoder_layers
        reset_counts()  # the main path: serving, then the split's warm-up and timed encode
        encodes = phase_serve_parity(ref, tag=f"{name} serve")
        split = variant_encode_split(cfg, name)
        counts = read_counts()
        check_counts(counts, {**{k: 0 for k in counts},
                              "attention_fwd": ref_layers * encodes + layers * 2},
                     f"{name} serving ({encodes} + 2 encodes)")
        parity, got = phase_train_parity(
            ref.replace(**NO_DROPOUT), S2TTransformerModel, f"{name} train",
            per_step={"attention_fwd": ref_layers, "attention_bwd": ref_layers,
                      "ctc_alpha": 1, "ctc_beta_grad": 1})
        out[name] = {"serve_encodes": encodes + 2, "k1f_per_encode": layers,
                     "encode_split": split, "train_parity": parity}
        launches = {k: launches[k] + counts[k] + got.get(k, 0) for k in counters()}
    log(f"[main path] the encoder variants: {json.dumps(launches)}")
    return out, launches


def phase_efficient_conformer():
    """Phase 29: EffecientConformerCTCSmall.yaml (s2t_ctc_pds: a Conv2d subsampler, stages of
    5 x 120 / 168 / 240 whose last layers stride and widen the stream, rel_pos, V=10000) as
    phase 13 (bf16 greedy at 256 x 1000 frames with each stage's device ms; fp32 greedy and
    beam-5 tokens card vs CPU), then one fp32 Trainer step card vs CPU.  No K1f / K1b: the
    attention is rel_pos."""
    from s2t_tpu_torch.models.s2t_ctc import S2TCTCModel, s2t_ctc_pds

    model = fields(EFFICIENT_CONFORMER_SMALL["model"])
    serve, serve_launches = phase_nast(s2t_ctc_pds, model, "efficient conformer")
    crit = (EFFICIENT_CONFORMER_SMALL["criterion"],
            {**EFFICIENT_CONFORMER_SMALL["criterion_cfg"], "zero_infinity": True})
    parity, parity_launches = phase_train_parity(
        s2t_ctc_pds(**model, **PDS_S8_FIELDS, **NO_DROPOUT), S2TCTCModel,
        "efficient conformer train", steps=1, criterion=crit)
    launches = {k: serve_launches[k] + parity_launches.get(k, 0) for k in counters()}
    log(f"[main path] EffecientConformerCTCSmall (serving, parity): {json.dumps(launches)}")
    return {"serve": serve, "train_parity": parity}, launches


# --------------------------------------------------------------------------- #
# phase 30: the generator's full breadth (tests/test_torch_search.py holds the recipe copies)
CTC_RESCORE_GENERATION = {  # egs/mustc/st/conf/ctc_rescore.yaml's generation over basis.yaml's
    "beam": 5, "lenpen": 1.0, "scoring": "sacrebleu", "post_process": "sentencepiece",
    "infer_ctc_weight": 0.2, "ctc_infer": True}
MUSTC_ST_DATASET = {"max_tokens": 40000, "max_source_positions": 6000,  # basis.yaml's dataset
                    "max_target_positions": 1024, "num_buckets": 12}
GEN_SHORT = dict(GEN, max_len_b=20)  # the short card-vs-CPU cases and the profiled decodes
SEARCH_CASES = {  # name -> (generator options, encodes a decode)
    "prefix": (dict(prefix_size=3), 1),
    "diverse_groups": (dict(beam_size=4, diverse_beam_groups=2), 1),
    "sampling_noise": (dict(sampling=True, sampling_topk=10), 1),
    "constraints_ordered": (dict(constraints_mode="ordered"), 1),
    "ensemble": ({}, 2),
    "lm_fusion": (dict(lm_weight=0.3), 1),
}
# the int8 cache card vs CPU, teacher-forced on the CPU's top hypotheses: the encoder
# outputs differ by ~2e-5 between the devices (phase 5), ~1e-3 of a quantisation step
# (absmax / 127 at absmax ~3), so ~2e-3 of the K / V entries round the other way, each
# by one step; such flips move the step logits by ~1e-3, a fault in the path by O(1)
INT8_FLIP_SHARE = 1e-2
INT8_LOGIT_ATOL = 0.05
SEARCH_CONSTRAINTS = [[[11, 12]], [[13], [14, 15]], [[16, 17, 18]], []]
SPEED_MODES = {"plain": {}, "joint_ctc": {"infer_ctc_weight": 0.2},
               "int8": {"kv_cache_dtype": "int8"}, "lazy": {"lazy_beam_reorder": True}}
NGRAM_WORDS = 200  # the CTC n-gram LM's sentences draw from the first 200 words
NGRAM_LM_WEIGHT = 0.5


@contextlib.contextmanager
def scorer_ranges():
    """Run the joint-CTC prefix scorer's ``score_candidates`` and ``select`` inside
    torch.profiler ranges ``joint_ctc_score_candidates`` / ``joint_ctc_select``; yields
    the count of calls of each."""
    from torch.profiler import record_function

    from s2t_tpu_torch.inference.ctc_prefix import CTCPrefixScorer

    saved = {name: getattr(CTCPrefixScorer, name) for name in ("score_candidates", "select")}
    calls = {name: 0 for name in saved}

    def ranged(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            with record_function(f"joint_ctc_{name}"):
                return fn(*args, **kw)
        return call

    for name, fn in saved.items():
        setattr(CTCPrefixScorer, name, ranged(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(CTCPrefixScorer, name, fn)


@contextlib.contextmanager
def decode_ranges(model):
    """Run ``model``'s encode inside the torch.profiler range ``generator_encode`` and count
    its decode steps; yields the count of each."""
    from torch.profiler import record_function

    calls = {"encode": 0, "decode_step": 0}
    encode, decode_step = model.encode, model.decode_step

    def ranged_encode(*args, **kw):
        calls["encode"] += 1
        with record_function("generator_encode"):
            return encode(*args, **kw)

    def counted_step(*args, **kw):
        calls["decode_step"] += 1
        return decode_step(*args, **kw)

    model.encode, model.decode_step = ranged_encode, counted_step
    try:
        yield calls
    finally:
        del model.encode, model.decode_step


def search_card_vs_cpu(tag, card_gen, host_gen, batch, encodes=1):
    """One decode of ``batch`` by two generators over the same seeded weights, on the card
    and on the CPU: K1f launches once a fused-attention encoder layer an encode on the card;
    the tokens must be identical, or differ only where the scores of the differing
    hypotheses agree within ENC_ATOL (a near-tie broken by float error).  Returns the
    result."""
    before = fused_attention.launches
    tc, sc, _ = card_gen.generate(batch)
    torch.cuda.synchronize()
    want = encoder_layers(card_gen.model.cfg) * encodes
    if fused_attention.launches - before != want:
        raise AssertionError(f"[{tag}] the decode launched K1f {fused_attention.launches - before} "
                             f"times, expected {want}")
    th, sh, _ = host_gen.generate(batch)
    tc, sc = tc.cpu(), sc.float().cpu()
    differ = (tc != th).any(dim=-1)  # (B, K)
    score_err = (sc - sh).abs()
    res = {"identical": not bool(differ.any()), "max_score_err": score_err.max().item(),
           "top_lengths": [int((row != 1).sum()) for row in th[:, 0]]}
    if differ.any():
        gaps = score_err[differ]
        res["differing_hypotheses"] = int(differ.sum())
        res["differing_score_gaps"] = gaps.tolist()
        if not gaps.max().item() <= ENC_ATOL:
            raise AssertionError(f"[{tag}] tokens differ card vs CPU and the scores by "
                                 f"{gaps.max().item():.3e} (> {ENC_ATOL}): no near-tie")
    log(f"[{tag}] card vs CPU tokens {'identical' if res['identical'] else 'differ (near-tie)'} "
        f"{json.dumps(res)}")
    return res, tc


def int8_card_vs_cpu(card, host, batch, seed=0):
    """The int8 cache on the card vs the CPU: a 20-token beam on each (tokens reported:
    a rounding flip may move a near-tie), then the CPU's top hypotheses teacher-forced
    through the card's and the CPU's int8 decode steps: the step logits within
    INT8_LOGIT_ATOL, at most INT8_FLIP_SHARE of the cached int8 entries one step apart
    (none further), the bf16 scales within one bf16 step.  Two encodes on the card."""
    from s2t_tpu_torch.inference.generator import SequenceGenerator

    kw = dict(GEN_SHORT, kv_cache_dtype="int8")
    tc, sc, _ = SequenceGenerator(card, **kw).generate(batch)
    th, sh, _ = SequenceGenerator(host, **kw).generate(batch)
    tokens = th[:, 0]  # (B, L) the CPU's top hypotheses, pad after EOS
    feats = torch.from_numpy(batch["features"])
    lens = torch.from_numpy(batch["feat_lengths"]).long()
    B, L = tokens.shape
    prev = torch.cat([torch.full((B, 1), 2, dtype=torch.long), tokens[:, :-1].long()], dim=1)
    caches, steps = [], []
    with torch.inference_mode():
        for model, dev in ((card, "cuda"), (host, "cpu")):
            enc = model.encode(feats.to(dev), lens.to(dev))
            mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
            cache = model.init_cache(B, L, kv_int8=True)
            steps.append([model.decode_step(prev[:, i:i + 1].to(dev), cache, i,
                                            enc["encoder_out"], mask)[0].float().cpu()
                          for i in range(L)])
            caches.append(cache)
    logit_err = max((a - b).abs().max().item() for a, b in zip(*steps))
    flips, worst, scale_err, n = 0, 0, 0.0, 0
    for layer in caches[1]:
        for name in ("k", "v"):
            d = (caches[0][layer][name].cpu().int() - caches[1][layer][name].int()).abs()
            flips += int((d > 0).sum())
            worst = max(worst, int(d.max()))
            n += d.numel()
            sc_c = caches[0][layer][f"{name}_scale"].cpu().float()
            sc_h = caches[1][layer][f"{name}_scale"].float()
            scale_err = max(scale_err,
                            ((sc_c - sc_h).abs() / sc_h.abs().clamp(min=1e-8)).max().item())
    res = {"decode_identical": torch.equal(tc.cpu(), th),
           "decode_max_score_err": (sc.float().cpu() - sh).abs().max().item(),
           "teacher_forced_logit_max_err": logit_err, "int8_entries_flipped_share": flips / n,
           "int8_max_step": worst, "scale_max_rel_err": scale_err}
    log(f"[generator int8] weight seed {seed}: {json.dumps(res)}")
    if not (logit_err <= INT8_LOGIT_ATOL and flips / n <= INT8_FLIP_SHARE and worst <= 1
            and scale_err <= 2 ** -7):
        raise AssertionError(f"the int8 cache disagrees card vs CPU: {res}")
    return res


SPEED_TIMED = 1  # timed decodes of each mode in phase 30 (after its warm-up decode)


def decode_speed(model, batch, B, seconds, n_timed=SPEED_TIMED):
    """Each mode of SPEED_MODES decodes ``batch`` (features on the card) with ``model`` at
    GEN's length once to warm up, then n_timed times in turns.  Returns name -> RTF (audio
    seconds over the median synchronised wall of a decode, features precomputed), decode
    steps, the wall ms a step, and the tokens.  (No profiled decode: the busy shares and
    the scorer's device ms a profile gave are in PERF.md.)"""
    from s2t_tpu_torch.inference.generator import SequenceGenerator

    gens = {name: SequenceGenerator(model, **GEN, **kw) for name, kw in SPEED_MODES.items()}
    out = {}
    for name, gen in gens.items():
        with decode_ranges(model) as calls:
            tokens = gen.generate(batch)[0].cpu()
        out[name] = {"tokens": tokens, "wall_s": [], "decode_steps": calls["decode_step"]}
    for _ in range(n_timed):
        for name, gen in gens.items():
            out[name]["wall_s"].append(synced_s(lambda: gen.generate(batch)))
    for name in SPEED_MODES:
        wall = float(np.median(out[name]["wall_s"]))
        out[name].update({"rtf": B * seconds / wall, "median_wall_s": wall,
                          "wall_ms_per_step": wall * 1e3 / out[name]["decode_steps"]})
    return out


def ctc_ngram_card_vs_cpu():
    """s2t_ctc_base at full width and REF_LAYERS (V=10000) in fp32, beam 5 with an ARPA LM
    (order 3, trained
    on 200 seeded sentences over the first NGRAM_WORDS words, written and loaded back): the
    re-ranked tokens card vs CPU, identical, or, where the CTC beams themselves differ, the
    CTC near-tie of phase 13.  Returns (result, launches)."""
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.data.ngram_lm import ArpaLM, train_ngram_lm
    from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
    from s2t_tpu_torch.models.s2t_ctc import S2TCTCModel, s2t_ctc_base

    d = Dictionary()
    for i in range(SYMBOLS):
        d.add_symbol(f"w{i}")
    rng = np.random.default_rng(4)
    lines = [" ".join(f"w{j}" for j in rng.integers(0, NGRAM_WORDS, size=int(rng.integers(3, 12))))
             for _ in range(200)]
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_arpa_") as tmp:
        train_ngram_lm(lines, order=3).save(Path(tmp) / "lm.arpa")
        lm = ArpaLM.load(Path(tmp) / "lm.arpa")
    cfg = s2t_ctc_base(vocab_size=len(d), max_target_positions=1024, **REF_DEPTH)
    card, host = seeded_pair(lambda dev: S2TCTCModel(cfg, device=dev, seed=0)).values()
    batch = GeneratorHub(card, None)._speech_batch(WAVS)
    dec = CTCDecoder(beam_size=5)
    reset_counts()  # the main path: the card's plain and n-gram decodes
    out = {}
    for name, kw in (("plain", {}), ("ngram", dict(ngram_lm=lm, lm_weight=NGRAM_LM_WEIGHT,
                                                   dictionary=d))):
        tc, sc, ec = CTCGenerator(card, dec, **kw).generate(batch)
        th, sh, eh = CTCGenerator(host, dec, **kw).generate(batch)
        out[name] = (tc.cpu(), sc.cpu(), th, sh, ec, eh)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts(launches, {**{k: 0 for k in launches}, "attention_fwd": 2 * encoder_layers(cfg)},
                 "the CTC n-gram case")
    tc, _, th, _, ec, eh = out["plain"]
    nc, nsc, nh, nsh, _, _ = out["ngram"]
    res = {"plain_identical": torch.equal(tc, th), "ngram_identical": torch.equal(nc, nh),
           "reranked_rows": int((nc[:, 0] != tc[:, 0]).any(dim=-1).sum()),
           "ngram_score_max_err": (nsc - nsh).abs().max().item()}
    if not res["ngram_identical"]:
        ok, report = ctc_near_tie(ec, eh, tc, th, 5)
        res["near_tie"] = report
        if res["plain_identical"] or not ok:
            raise AssertionError(f"[ctc ngram] re-ranked tokens differ card vs CPU: {res}")
    log(f"[ctc ngram] s2t_ctc_base fp32 beam 5 with an order-3 ARPA LM (weight "
        f"{NGRAM_LM_WEIGHT}): {json.dumps(res)}")
    return res, launches


def ctc_rescore_cli(root: Path):
    """cli.generate decodes TEST_UTTS utterances of a seeded feature split with
    ctc_rescore.yaml's generation section over basis.yaml's (joint CTC at 0.2, ctc_infer,
    beam 5) and basis.yaml's dataset caps, from a seeded s2t_transformer_s state dict;
    cut: scoring wer (sacreBLEU is not installed here), no sentencepiece, max_len_b 100.
    Returns (result, launches)."""
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.config import TrainConfig, from_dict

    write_corpus(root, seed=5, corpus={"dev": TEST_UTTS})
    write_feature_split(root, "dev", "test")
    cfg = from_dict(TrainConfig, {
        "task": "speech_to_text", "arch": "s2t_transformer_s",
        "dataset": {"data": str(root), "gen_subset": "test", **MUSTC_ST_DATASET},
        "checkpoint": {"save_dir": str(root / "ckpt")},
        "generation": {**CTC_RESCORE_GENERATION, "scoring": "wer", "post_process": None,
                       "max_len_b": 100, "results_path": str(root / "gen")}})
    task = audio_task(cfg, use_audio=False)
    params = S2TTransformerModel(s2t_transformer_s(vocab_size=len(task.tgt_dict),
                                                   max_target_positions=1024),
                                 device="cuda", seed=2).state_dict()
    reset_counts()  # the main path: cli.generate with joint CTC
    with scorer_ranges() as calls:
        out = cli_generate.main(cfg, params, task=task, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    encodes = len(task.get_batch_iterator(task.datasets["test"], max_tokens=cfg.dataset.max_tokens,
                                          shuffle=False))
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": 12 * encodes},
                 "cli.generate with ctc_rescore.yaml")
    text = (root / "gen" / "generate-test.txt").read_text().splitlines()
    ctc = (root / "gen" / "translation-test.txt.ctc").read_text().splitlines()
    if sum(line.startswith("H-") for line in text) != TEST_UTTS or len(ctc) != TEST_UTTS:
        raise AssertionError(f"ctc_rescore cli.generate wrote {len(text)} lines and {len(ctc)} "
                             "CTC transcripts")
    if not calls["score_candidates"]:
        raise AssertionError("cli.generate with ctc_rescore.yaml never called the prefix scorer")
    res = {"utterances": out["n_utts"], "score": text[-1], "gen_time_s": out["gen_time"],
           "rtf": out["rtf"], "scorer_calls": calls, "launches": counts,
           "first_lines": text[:3]}
    log(f"[ctc_rescore] {json.dumps(res)}")
    return res, counts


def phase_generator():
    """Phase 30: the generator's options on s2t_transformer_s at full width (V=10000).
    (a) fp32 fixture wavs card vs CPU at REF_LAYERS a side: joint CTC at 0.2 with phase 5's beam (5, 100 tokens);
    prefix forcing, diverse groups, sampling on handed-over uniforms, ordered constraints,
    a 2-member ensemble, LM fusion with a seeded transformer_lm and the int8 cache (at two
    weight seeds) at 20 tokens; lazy = eager tokens on the card. (b) bf16 at phase 6's shape
    (64 x 10 s, beam 5) at the preset's depth: plain, joint CTC, int8 and lazy in turns,
    SPEED_TIMED timed decodes each. (c) the CTC n-gram
    LM on s2t_ctc_base. (d) ctc_rescore.yaml through cli.generate.  Returns (results,
    launches)."""
    from s2t_tpu_torch.inference.constrained import pack_constraints
    from s2t_tpu_torch.inference.generator import SequenceGenerator
    from s2t_tpu_torch.models.transformer_lm import TransformerLM, transformer_lm_base

    t0 = time.perf_counter()
    part_s = {}
    cfg = s2t_transformer_s(vocab_size=10000, max_target_positions=1024)
    ref = cfg.replace(**REF_DEPTH)  # (a)'s depth; (b) serves the preset's 12 + 6
    card, host = seeded_pair(lambda d: S2TTransformerModel(ref, device=d, seed=0)).values()
    card2, host2 = seeded_pair(lambda d: S2TTransformerModel(ref, device=d, seed=1)).values()
    lm_cfg = transformer_lm_base(vocab_size=10000, dropout=0.0)
    card_lm, host_lm = seeded_pair(lambda d: TransformerLM(lm_cfg, device=d, seed=2)).values()
    batch = GeneratorHub(card, None)._speech_batch(WAVS)
    B = len(WAVS)
    rng = np.random.default_rng(6)
    batch["target"] = rng.integers(4, 10000, size=(B, 5)).astype(np.int32)
    batch["constraints"] = pack_constraints(SEARCH_CONSTRAINTS)

    reset_counts()  # the main path: every card decode of (a)
    parity = {}
    parity["joint_ctc"], _ = search_card_vs_cpu(
        "generator joint_ctc", SequenceGenerator(card, **GEN, infer_ctc_weight=0.2),
        SequenceGenerator(host, **GEN, infer_ctc_weight=0.2), batch)
    probe = SequenceGenerator(card, **GEN_SHORT)
    max_len = probe._max_len_for(probe._enc_len_bound(batch["features"].shape[1]))
    noise = rng.uniform(size=(max_len, B * GEN_SHORT["beam_size"])).astype(np.float32)
    for name, (kw, encodes) in SEARCH_CASES.items():
        kw = {**GEN_SHORT, **kw}
        if name == "sampling_noise":
            kw["sampling_noise"] = noise
        sides = [dict(kw), dict(kw)]
        if name == "ensemble":
            sides[0]["extra_models"], sides[1]["extra_models"] = [card2], [host2]
        if name == "lm_fusion":
            sides[0]["lm_model"], sides[1]["lm_model"] = card_lm, host_lm
        parity[name], tokens = search_card_vs_cpu(
            f"generator {name}", SequenceGenerator(card, **sides[0]),
            SequenceGenerator(host, **sides[1]), batch, encodes)
        if name == "prefix" and not (tokens[:, :, :3] == torch.from_numpy(
                batch["target"][:, None, :3]).long()).all():
            raise AssertionError("prefix forcing did not force the targets' first 3 tokens")
    eager_t, eager_s, _ = SequenceGenerator(card, **GEN).generate(batch)
    lazy_t, lazy_s, _ = SequenceGenerator(card, **GEN, lazy_beam_reorder=True).generate(batch)
    # the int8 bounds held at two weight seeds (the ensemble's second member is seed 1)
    parity["int8"] = {f"seed{seed}": int8_card_vs_cpu(c, h, batch, seed)
                      for seed, (c, h) in enumerate(((card, host), (card2, host2)))}
    parity["lazy_vs_eager_card"] = {"identical": torch.equal(lazy_t, eager_t),
                                    "max_score_err": (lazy_s - eager_s).abs().max().item()}
    log(f"[generator lazy] card fp32 lazy vs eager {json.dumps(parity['lazy_vs_eager_card'])}")
    if not parity["lazy_vs_eager_card"]["identical"]:
        raise AssertionError("the lazy reorder decodes other tokens than the eager one")
    counts = read_counts()
    encodes = 1 + sum(e for _, e in SEARCH_CASES.values()) + 2 + 2 * len(parity["int8"])
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": REF_LAYERS * encodes},
                 f"phase 30 (a) ({encodes} encodes)")
    launches = dict(counts)
    del card2, host2, card_lm, host_lm, host
    part_s["card_vs_cpu"] = time.perf_counter() - t0

    # (b) bf16 serving at phase 6's shape; the features are computed once on the host
    cfg16 = cfg.replace(dtype_str="bfloat16")
    model = S2TTransformerModel(cfg16, device="cuda", seed=0)
    n, seconds = 64, 10.0
    waves = list((np.random.default_rng(0).normal(size=(n, int(16000 * seconds))) * 3000.0)
                 .astype(np.float32))
    fb = GeneratorHub(model, None)._speech_batch(waves)
    fb = {k: torch.from_numpy(v).cuda() for k, v in fb.items()}
    reset_counts()  # the main path: a warm-up and the timed decodes of each mode
    speed = decode_speed(model, fb, n, seconds, n_timed=SPEED_TIMED)
    counts = read_counts()
    check_counts(counts, {**{k: 0 for k in counts},
                          "attention_fwd": 12 * (SPEED_TIMED + 1) * len(SPEED_MODES)},
                 "phase 30 (b)")
    launches = {k: launches[k] + counts[k] for k in counts}
    plain = speed["plain"].pop("tokens")
    for name in SPEED_MODES:
        if name != "plain":
            t = speed[name].pop("tokens")
            speed[name]["top_tokens_equal_plain_share"] = (
                (t[:, 0] == plain[:, 0]).all(dim=-1).float().mean().item())
    if speed["lazy"]["top_tokens_equal_plain_share"] != 1.0:
        log("[generator speed] bf16 lazy and eager top tokens differ on some rows (bf16 "
            "attention over a gathered or a sliced cache)")
    log(f"[generator speed] bf16 64 x 10 s, beam 5 (generate only): {json.dumps(speed)}")
    part_s["speed"] = time.perf_counter() - t0 - sum(part_s.values())

    ngram, ngram_launches = ctc_ngram_card_vs_cpu()
    launches = {k: launches[k] + ngram_launches[k] for k in launches}
    part_s["ctc_ngram"] = time.perf_counter() - t0 - sum(part_s.values())
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_rescore_") as tmp:
        rescore, rescore_launches = ctc_rescore_cli(Path(tmp))
    launches = {k: launches[k] + rescore_launches[k] for k in launches}
    part_s["ctc_rescore"] = time.perf_counter() - t0 - sum(part_s.values())
    log(f"[main path] the generator (card-vs-CPU cases, speed, CTC n-gram, ctc_rescore "
        f"cli.generate): {json.dumps(launches)}; host seconds by part {json.dumps(part_s)}")
    return {"parity": parity, "speed": speed, "ctc_ngram": ngram, "ctc_rescore": rescore,
            "seconds_by_part": part_s}, launches


# --------------------------------------------------------------------------- #
# --------------------------------------------------------------------------- #
# phases 31-36: the wav2vec 2.0 family, the dual / multibranch models, quant noise and
# multilingual training (the card has no yaml package: the script carries the recipes'
# sections, and tests/test_torch_item9_recipes.py holds them to the files)
W2V2_BASE_RECIPE = {  # egs/librispeech/pretraining/wav2vec2_base.yaml
    "task": "audio_pretraining", "arch": "wav2vec2_base", "criterion": "wav2vec",
    "criterion_cfg": {"prob_ppl_weight": 0.1, "features_pen_weight": 10.0},
    "model": {"dtype_str": "bfloat16"},
    "dataset": {"max_tokens": 1400000, "num_buckets": 8},
    "optimization": {"optimizer": "adam", "lr": 0.0005, "adam_betas": [0.9, 0.98],
                     "weight_decay": 0.01, "lr_scheduler": "polynomial_decay",
                     "warmup_updates": 32000, "max_update": 400000, "clip_norm": 25.0},
    "common": {"dtype": "bfloat16"},
    "task_cfg": {"max_sample_size": 250000}}
W2V2_ST_RECIPE = {  # egs/mustc/st/conf/w2v2.yaml
    "arch": "s2t_w2v2_transformer_base", "task_cfg": {"use_audio_input": True},
    "criterion_cfg": {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.0}}}
# the card-vs-CPU depth of w2v2.yaml's model: its wav2vec 2.0 encoder, the encoder on
# top and the decoder at REF_LAYERS each (12, 6 and 6 in the preset)
W2V2_REF = {"w2v_encoder_layers": REF_LAYERS, **REF_DEPTH}
W2V_CTC_RECIPE = {  # egs/librispeech/pretraining/wav2vec_ctc_finetune.yaml
    "task": "speech_to_text", "arch": "wav2vec_ctc", "criterion": "ctc",
    "criterion_cfg": {"ctc_weight": 1.0}, "model": {"final_dropout": 0.1, "mask_prob": 0.5},
    "optimization": {"lr": 0.00003, "lr_scheduler": "tri_stage", "max_update": 80000}}
JOIN_CFG = {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}}
DUAL_RECIPE = {"arch": "s2t_dual_s", "criterion": "join_speech_and_text_loss",
               "criterion_cfg": JOIN_CFG}  # egs/mustc/st/conf/dual.yaml
MULTIBRANCH_RECIPE = {"arch": "s2t_multibranch_s", "criterion": "join_speech_and_text_loss",
                      "criterion_cfg": JOIN_CFG}  # egs/mustc/st/conf/multibranch.yaml
QUANT_NOISE_RECIPE = {  # egs/mustc/st/conf/quant_noise.yaml
    "optimization": {"quant_noise_p": 0.1, "quant_noise_block_size": 8}}
MULTILINGUAL_RECIPE = {  # egs/mustc/st_multilingual/multilingual.yaml
    "task": "speech_to_text", "arch": "s2t_transformer_m",
    "criterion": "label_smoothed_cross_entropy_with_ctc",
    "criterion_cfg": {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}},
    "dataset": {"train_subset": "train_de_st,train_fr_st,train_es_st",
                "valid_subset": "dev_de_st", "max_tokens": 40000},
    "optimization": {"lr": 0.002, "warmup_updates": 10000}}
MUSTC_ST_BASIS = {  # the parts of egs/mustc/st/conf/basis.yaml that cli.train reads here
    "criterion": "label_smoothed_cross_entropy_with_ctc",
    "dataset": {"max_tokens": 40000, "max_source_positions": 6000,
                "max_target_positions": 1024, "num_buckets": 12},
    "optimization": {"optimizer": "adam", "lr": 2.0e-3, "lr_scheduler": "inverse_sqrt",
                     "warmup_updates": 10000, "warmup_init_lr": 1.0e-7, "clip_norm": 10.0}}
W2V_N = 250000  # wav2vec2_base.yaml's crop: T' = 781 frames
W2V_BENCH_B = 4  # 4 crops, 1.0M samples, under the recipe's max_tokens of 1.4M


def w2v_draws(cfg, lengths, n_samples, seed, pretraining=True):
    """Host draws handed to both devices: the span uniforms and, for pretraining, the
    negatives and the Gumbel uniforms (the port's ``draws`` contract)."""
    from s2t_tpu_torch.models.wav2vec2 import conv_out_lengths, mask_span_count

    B = len(lengths)
    T = int(conv_out_lengths(torch.tensor([n_samples]), cfg.conv_feature_layers)[0])
    n = mask_span_count(T, cfg.mask_prob, cfg.mask_length, cfg.min_masks)
    rng = np.random.default_rng(seed)
    draws = {"mask_uniform": rng.random((B, n), dtype=np.float32)}
    if pretraining:
        M = n * cfg.mask_length
        draws["negatives"] = rng.integers(0, max(M - 1, 1), size=(B, M, cfg.num_negatives))
        draws["gumbel_uniform"] = (rng.random((B, M, cfg.latent_groups, cfg.latent_vars),
                                              dtype=np.float32) * (1 - 2e-6) + 1e-6)
    return {k: torch.from_numpy(v) for k, v in draws.items()}


def wave_batch(rng, lengths, n_samples, scale=0.1):
    src = np.zeros((len(lengths), n_samples), np.float32)
    for i, n in enumerate(lengths):
        src[i, :n] = rng.normal(size=n) * scale
    return src


def grads_card_vs_cpu(card, host, floor=1e-4):
    """Per parameter max |card - CPU| over its largest CPU entry, or over ``floor`` times
    the largest entry of any gradient where that is more: the key projections' biases
    have a gradient of 0 in exact arithmetic (the softmax ignores a shift of a query's
    scores), float32 noise on both devices.  The worst three."""
    top = max(g.abs().max().item() for g in host.values())
    errs = {n: ((card[n] - host[n]).abs().max() / max(host[n].abs().max().item(),
                                                      floor * top)).item()
            for n in host}
    worst = sorted(errs, key=lambda n: -errs[n])[:3]
    return max(errs.values()), {n: errs[n] for n in worst}


# fp32 card vs CPU, each gradient relative to its largest entry: the last layers' query and
# key projections read 2.2e-3 (their gradients are sums of cancelling terms over 180
# masked frames x 100 negatives)
W2V_GRAD_RTOL = 5e-3


def w2v2_pretrain_parity():
    """fp32 at full width, dropout 0, the same seeded weights on both devices: one
    forward / loss / backward of 2 crops (3 s and 2.2 s) on the same handed-over masks,
    negatives and Gumbel uniforms; the loss, the quantizer's codes and every gradient."""
    from s2t_tpu_torch.models.wav2vec2 import Wav2Vec2Model, wav2vec2_base
    from s2t_tpu_torch.tasks.audio_pretraining import gumbel_temperature

    cfg = wav2vec2_base(dropout=0.0, attention_dropout=0.0, dropout_input=0.0,
                        dropout_features=0.0)
    lengths, N = [48000, 35000], 48000
    src = wave_batch(np.random.default_rng(31), lengths, N)
    draws = w2v_draws(cfg, lengths, N, seed=31)
    crit = build_criterion(W2V2_BASE_RECIPE["criterion"], W2V2_BASE_RECIPE["criterion_cfg"])
    runs, counts = {}, None
    models = seeded_pair(lambda d: Wav2Vec2Model(cfg, device=d, seed=0, for_training=True))
    for device in ("cuda", "cpu"):
        model = models[device]
        codes = []
        hook = model.quantizer.register_forward_hook(lambda m, i, o: codes.append(o[3].cpu()))
        reset_counts()  # the main path: one training forward and backward
        out = model(torch.from_numpy(src).to(device), torch.tensor(lengths).to(device),
                    train=True, generator=torch.Generator(device=device).manual_seed(0),
                    temp=gumbel_temperature(cfg.latent_temp, 0),
                    draws={k: v.to(device) for k, v in draws.items()})
        loss, size, logs = crit(out, {})
        loss.backward()
        hook.remove()
        if device == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        runs[device] = {"loss": loss.item(), "size": size.item(),
                        "prob_perplexity": logs["prob_perplexity"].item(),
                        "features_pen": logs["features_pen"].item(), "codes": codes[0],
                        "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()}}
    card, host = runs["cuda"], runs["cpu"]
    loss_err = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    grad_err, worst = grads_card_vs_cpu(card["grads"], host["grads"])
    code_flips = int((card["codes"] != host["codes"]).sum())
    res = {"loss": [card["loss"], host["loss"]], "loss_rel_err": loss_err,
           "sample_size": card["size"], "prob_perplexity": [card["prob_perplexity"],
                                                            host["prob_perplexity"]],
           "features_pen": [card["features_pen"], host["features_pen"]],
           "code_flips": code_flips, "max_grad_rel_err": grad_err, "worst_grads": worst,
           "grad_rtol": W2V_GRAD_RTOL, "launches": counts}
    log(f"[w2v2 pretrain] fp32 card vs CPU at full width: {json.dumps(res)}")
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": 12, "attention_bwd": 12},
                 "w2v2 pretraining step")
    if code_flips or not loss_err <= TRAIN_RTOL["loss"] or not grad_err <= W2V_GRAD_RTOL:
        raise AssertionError("wav2vec 2.0 pretraining disagrees between the card and the CPU")
    return res, counts


def w2v_task_cfg(recipe, data, **sections):
    from s2t_tpu_torch.config import TrainConfig, from_dict

    d = {k: v for k, v in recipe.items()}
    for key, val in sections.items():
        d[key] = {**d.get(key, {}), **val}
    d.setdefault("dataset", {})["data"] = str(data)
    return from_dict(TrainConfig, d)


def w2v2_pretrain_speed(n_timed=2):
    """bf16 as the recipe sets it (preset dropouts, its optimizer) on 4 crops of 250,000
    samples: a warm-up, ``n_timed`` timed steps and one last step."""
    from s2t_tpu_torch.models.wav2vec2 import Wav2Vec2Model, wav2vec2_base
    from s2t_tpu_torch.tasks.audio_pretraining import AudioPretrainingTask

    cfg = wav2vec2_base(**fields(W2V2_BASE_RECIPE["model"]))
    tcfg = w2v_task_cfg(W2V2_BASE_RECIPE, "")
    task = AudioPretrainingTask(tcfg)
    model = Wav2Vec2Model(cfg, device="cuda", seed=0, for_training=True)
    crit = task.build_criterion()

    def ranged_crit(out, batch):
        from torch.profiler import record_function

        with record_function("w2v_loss"):
            return crit(out, batch)

    trainer = Trainer(model, ranged_crit, tcfg.optimization, device="cuda", seed=1,
                      forward_fn=task.forward_fn())
    B = W2V_BENCH_B
    batch = {"source": torch.randn(B, W2V_N, device="cuda") * 0.1,
             "lengths": torch.full((B,), W2V_N, device="cuda"),
             "ntokens": torch.tensor(float(B * W2V_N), device="cuda")}
    reset_counts()  # the main path: 1 warm-up + n_timed timed + 1 last step
    losses = [trainer.train_step(batch)["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        losses.append(trainer.train_step(batch)["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the last step unprofiled: the forward's device ms by part is in PERF.md
    losses.append(trainer.train_step(batch)["loss"])
    counts = read_counts()
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": 12 * (n_timed + 2),
                          "attention_bwd": 12 * (n_timed + 2)}, "w2v2 bf16 steps")
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"wav2vec 2.0 bf16 loss is not finite: {losses}")
    step_ms = wall / n_timed * 1e3
    res = {"batch": B, "samples": W2V_N, "frames": 781, "timed_steps": n_timed,
           "step_ms": step_ms, "samples_per_s": B * W2V_N / (step_ms / 1e3),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses.tolist()}
    log(f"[w2v2 pretrain speed] bf16 untuned first measurement: {json.dumps(res)}")
    return res, counts


def write_manifest(root: Path, splits, seed=31):
    """Seeded 16-bit wavs (4-16 s) and fairseq-style manifests (root, then
    relpath<TAB>samples) for audio_pretraining."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for split, n in splits.items():
        lines = [str(root)]
        for i in range(n):
            samples = int(rng.integers(4 * 16000, 16 * 16000 + 1))
            write_wav(root / f"{split}{i}.wav", rng.normal(size=samples) * 2000.0)
            lines.append(f"{split}{i}.wav\t{samples}")
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")


def w2v2_pretrain_cli(root: Path):
    """cli.train with wav2vec2_base.yaml from seeded wavs, cut to 2 updates."""
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.tasks.audio_pretraining import AudioPretrainingTask

    data = root / "w2v_pretrain"
    write_manifest(data, {"train": 8, "valid": 2})
    cfg = w2v_task_cfg(W2V2_BASE_RECIPE, data, optimization={"max_update": 2},
                       dataset={"valid_subset": "valid"},
                       checkpoint={"save_dir": str(root / "w2v_pretrain_ckpt"), "no_save": True},
                       common={"seed": 1, "log_interval": 1})
    task = AudioPretrainingTask(cfg)
    reset_counts()  # the main path: cli.train
    t0 = time.perf_counter()
    out = cli_train.main(cfg, task=task, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    n_valid = len(task.get_batch_iterator(task.datasets["valid"], shuffle=False))
    steps = out["trainer"].step
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": 12 * (steps + n_valid),
                          "attention_bwd": 12 * steps}, "w2v2 cli.train")
    losses = [r["loss"] for r in out["train_log"]]
    if steps != 2 or not np.isfinite(losses).all() or not np.isfinite(out["history"][-1]["loss"]):
        raise AssertionError(f"wav2vec 2.0 cli.train: {out['train_log']} {out['history']}")
    res = {"steps": steps, "wall_s": wall, "train_log": out["train_log"],
           "valid": out["history"][-1], "timing": out["timing"]}
    log(f"[w2v2 pretrain cli] {json.dumps(res)}")
    return res, counts


def phase_w2v2_pretrain(root: Path):
    """Phase 31: wav2vec2_base.yaml (fp32 card vs CPU, bf16 steps, cli.train)."""
    parity, c1 = w2v2_pretrain_parity()
    speed, c2 = w2v2_pretrain_speed()
    cli, c3 = w2v2_pretrain_cli(root)
    counts = {k: c1[k] + c2[k] + c3[k] for k in c1}
    return {"parity": parity, "speed": speed, "cli": cli}, counts


def rescore_decoder(model, features, lengths, tokens, eos_id):
    """``rescore`` for a model without ``decode``: teacher forcing through its decoder
    (through the whole forward for a model without a ``decoder`` module: the LSTM and
    conv models)."""
    dev = model.device
    with torch.inference_mode():
        hyp = torch.as_tensor(tokens, device=dev)[None]
        prev = torch.cat([torch.full((1, 1), eos_id, device=dev), hyp[:, :-1]], dim=1)
        if not hasattr(model, "decoder"):
            logits = model(features.to(dev), lengths.to(dev), prev)["decoder_logits"]
        else:
            enc = model.encode(features.to(dev), lengths.to(dev))
            mask = lengths_to_mask(enc["encoder_lengths"], enc["encoder_out"].shape[1])
            logits = model.decoder(prev, enc["encoder_out"], mask)
        lp = torch.log_softmax(logits.float(), dim=-1)
        return lp[0].gather(-1, hyp[0, :, None])[:, 0].cumsum(0).cpu()


def tokens_near_tie(card_model, host_model, feats, lens, tok_card, tok_host, eos_id, tag):
    """Rows whose decoded tokens differ must be near-ties: at the first differing step
    the two candidates' prefix scores lie within ENC_ATOL on both devices."""
    for b, (a, c) in enumerate(zip(tok_card, tok_host)):
        if np.array_equal(a, c):
            continue
        n = min(len(a), len(c))
        step = int(np.flatnonzero(a[:n] != c[:n])[0]) if (a[:n] != c[:n]).any() else n
        hyp_a = np.append(a, eos_id)[: step + 1]
        hyp_c = np.append(c, eos_id)[: step + 1]
        gaps = []
        for model in (card_model, host_model):
            sa = rescore_decoder(model, feats[b:b + 1], lens[b:b + 1], hyp_a, eos_id)[-1].item()
            sc = rescore_decoder(model, feats[b:b + 1], lens[b:b + 1], hyp_c, eos_id)[-1].item()
            gaps.append(abs(sa - sc))
        log(f"[{tag}] request {b} diverges at step {step}: score gaps {gaps}")
        if not max(gaps) <= ENC_ATOL:
            raise AssertionError(f"{tag}: request {b}'s tokens differ and the gap {max(gaps):.3e}"
                                 f" is no near-tie (tolerance {ENC_ATOL})")
    return all(np.array_equal(a, c) for a, c in zip(tok_card, tok_host))


W2V2_ST_GEN = {"beam": 5, "max_len_b": 20, "post_process": None}  # 20-token outputs (cut)


def w2v2_st_decode(root: Path):
    """s2t_w2v2_transformer_base (w2v2.yaml) at full width and W2V2_REF depth, fp32, seeded
    weights: cli.generate beam-5 decodes 16 seeded waveforms of 10 s from a use_audio_input data directory (the
    waveforms reach the encoder as collated) on the card and on the CPU (tokens identical
    or a near-tie), then hub.from_pretrained transcribes 4 of them to cli.generate's D-
    strings on the card."""
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.config import TrainConfig, from_dict, to_dict
    from s2t_tpu_torch.data.dataset import S2TDataConfig
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.hub import from_pretrained
    from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
    from s2t_tpu_torch.utils.checkpoint import save_tree

    data = root / "w2v2_st"
    data.mkdir()
    rng = np.random.default_rng(32)
    words = [f"w{i}" for i in range(SYMBOLS)]
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text"]
    for i in range(16):
        write_wav(data / f"u{i}.wav", rng.normal(size=160000) * 2000.0)
        text = " ".join(rng.choice(words, size=12))
        lines.append(f"u{i}\tu{i}.wav\t160000\t{text}\t{text}")
    (data / "test.tsv").write_text("\n".join(lines) + "\n")

    def cfg_for(device):
        return from_dict(TrainConfig, {
            "arch": W2V2_ST_RECIPE["arch"], "criterion": MUSTC_ST_BASIS["criterion"],
            "criterion_cfg": W2V2_ST_RECIPE["criterion_cfg"], "model": W2V2_REF,
            "dataset": {"data": str(data), "gen_subset": "test", "max_tokens": 1_280_000,
                        "max_source_positions": 200_000, "max_target_positions": 1024},
            "generation": {**W2V2_ST_GEN, "scoring": "wer",
                           "results_path": str(root / f"w2v2_gen_{device}")},
            "checkpoint": {"save_dir": str(root / "w2v2_ckpt")}})

    def task_for(cfg):
        return SpeechToTextTask(cfg, S2TDataConfig(use_audio_input=True),
                                Dictionary.load(data / "dict.txt"))

    host_task = task_for(cfg_for("cpu"))
    host_model = host_task.build_model(device="cpu")
    ckpt = root / "w2v2.pt"
    save_tree(ckpt, {"params": host_model.state_dict()})
    layers = encoder_layers(host_model.cfg)
    card_cfg = cfg_for("cuda")
    card_task = task_for(card_cfg)
    reset_counts()  # the main path: cli.generate from waveforms
    card = cli_generate.main(card_cfg, host_model.state_dict(), task=card_task, device="cuda")
    torch.cuda.synchronize()
    gen_counts = read_counts()
    encodes = len(card_task.get_batch_iterator(card_task.datasets["test"],
                                               max_tokens=card_cfg.dataset.max_tokens,
                                               shuffle=False))
    check_counts(gen_counts, {**{k: 0 for k in gen_counts}, "attention_fwd": layers * encodes},
                 "w2v2 cli.generate")
    t0 = time.perf_counter()
    host = cli_generate.main(cfg_for("cpu"), host_model.state_dict(), task=host_task, device="cpu")
    host_s = time.perf_counter() - t0
    ids = sorted(host["results"])
    tok = {who: [np.array(out["results"][i]["hyp_tokens"].split()) for i in ids]
           for who, out in (("card", card), ("cpu", host))}
    identical = all(np.array_equal(a, c) for a, c in zip(tok["card"], tok["cpu"]))
    if not identical:  # compare as ids: a near-tie at the first differing step
        batch = host_task.datasets["test"].collater([host_task.datasets["test"][i] for i in ids])
        feats = torch.from_numpy(batch["features"])
        lens = torch.from_numpy(batch["feat_lengths"]).long()
        as_ids = {who: [np.array([host_task.tgt_dict.index(w) for w in t]) for t in ts]
                  for who, ts in tok.items()}
        card_model = card_task.build_model(device="cuda")
        card_model.load_state_dict(host_model.state_dict())
        tokens_near_tie(card_model, host_model, feats, lens, as_ids["card"], as_ids["cpu"],
                        host_task.tgt_dict.eos(), "w2v2 decode")
    reset_counts()  # the main path: the hub
    hub = from_pretrained(ckpt, data, config=to_dict(card_cfg), device="cuda", task=card_task)
    paths = [str(data / f"u{i}.wav") for i in range(4)]
    strings = hub.generate(paths)
    torch.cuda.synchronize()
    hub_counts = read_counts()
    check_counts(hub_counts, {**{k: 0 for k in hub_counts}, "attention_fwd": layers},
                 "w2v2 hub.from_pretrained")
    want = [card["results"][i]["hyp"] for i in range(4)]
    if strings != want:
        raise AssertionError(f"w2v2: from_pretrained's strings differ from cli.generate's: "
                             f"{strings} vs {want}")
    res = {"utterances": 16, "seconds_each": 10.0, "beam": 5, "max_len_b": W2V2_ST_GEN["max_len_b"],
           "card_gen_s": card["gen_time"], "card_rtf": card["rtf"], "cpu_gen_s": host_s,
           "tokens_identical": identical, "encodes": encodes, "k1f_per_encode": layers}
    log(f"[w2v2 decode] {json.dumps(res)}")
    counts = {k: gen_counts[k] + hub_counts[k] for k in gen_counts}
    return res, counts


def w2v_train_batches(rng, cfg, steps, B, N, lengths, U, V, pretraining=False, seed=0):
    """Seeded waveform batches with targets, the w2v front end's span uniforms handed over."""
    w2v = getattr(cfg, "w2v", cfg)
    out = []
    for s in range(steps):
        b = train_batch(rng, B, 1, U, V, lengths)
        del b["features"]
        b["features"] = wave_batch(rng, lengths, N)
        b["draws"] = w2v_draws(w2v, lengths, N, seed + s, pretraining)
        out.append(b)
    return out


def phase_w2v2_st(root: Path):
    """Phase 32: w2v2.yaml serving through the repaired use_audio_input path, and 2 fp32
    Trainer steps card vs CPU through ``waveform_forward``, both at W2V2_REF depth."""
    from s2t_tpu_torch.models.s2t_w2v2_transformer import (
        S2TW2V2TransformerModel, s2t_w2v2_transformer_base)
    from s2t_tpu_torch.models.wav2vec2 import waveform_forward

    decode, c1 = w2v2_st_decode(root)
    cfg = s2t_w2v2_transformer_base(vocab_size=10000, **W2V2_REF, dropout=0.0,
                                    attention_dropout=0.0, activation_dropout=0.0, w2v_dropout=0.0,
                                    w2v_attention_dropout=0.0, w2v_dropout_input=0.0,
                                    w2v_dropout_features=0.0)
    lengths, N = [48000, 40000], 48000
    batches = w2v_train_batches(np.random.default_rng(32), cfg, 2, 2, N, lengths, 20, 10000)
    train, c2 = phase_train_parity(
        cfg, S2TW2V2TransformerModel, "w2v2 train", batches=batches,
        forward_fn=waveform_forward, criterion=(MUSTC_ST_BASIS["criterion"],
                                                W2V2_ST_RECIPE["criterion_cfg"]),
        per_step=step_launches(cfg, ctc_terms=0))
    return {"decode": decode, "train": train}, {k: c1[k] + c2.get(k, 0) for k in c1}


def phase_w2v_ctc():
    """Phase 33: wav2vec_ctc_finetune.yaml at full width and REF_LAYERS transformer layers
    (the conv extractor whole): 2 fp32 Trainer steps under tri_stage card vs CPU (span-masked on handed-over uniforms), then greedy CTC tokens of
    4 seeded 10 s waveforms card vs CPU (identical, or every differing frame a near-tie)."""
    from s2t_tpu_torch.models.wav2vec2 import Wav2VecCtc, waveform_forward, wav2vec_ctc_arch
    from s2t_tpu_torch.ops.ctc import ctc_greedy_decode

    model_section = {**W2V_CTC_RECIPE["model"], "final_dropout": 0.0}
    cfg = wav2vec_ctc_arch(**model_section, dropout=0.0, attention_dropout=0.0,
                           dropout_input=0.0, dropout_features=0.0,
                           encoder_layers=REF_LAYERS)  # the references' depth
    lengths, N = [48000, 40000], 48000
    batches = w2v_train_batches(np.random.default_rng(33), cfg, 2, 2, N, lengths, 20,
                                cfg.vocab_size)
    opt = OptimizationConfig(**{**W2V_CTC_RECIPE["optimization"], "adam_eps": 1e-6})
    train, c1 = phase_train_parity(
        cfg, Wav2VecCtc, "w2v ctc train", batches=batches, forward_fn=waveform_forward,
        criterion=(W2V_CTC_RECIPE["criterion"], W2V_CTC_RECIPE["criterion_cfg"]), opt=opt,
        per_step=step_launches(cfg))
    src = torch.from_numpy(wave_batch(np.random.default_rng(34), [160000] * 4, 160000))
    lens = torch.full((4,), 160000)
    encs, toks = {}, {}
    models = seeded_pair(lambda d: Wav2VecCtc(cfg, device=d, seed=0))
    for device in ("cuda", "cpu"):
        model = models[device]
        if device == "cuda":
            reset_counts()  # the main path: one encode
        with torch.inference_mode():
            enc = model(src.to(device), lens.to(device))
            toks[device] = ctc_greedy_decode(enc["ctc_logits"], enc["encoder_lengths"])[0].cpu()
        encs[device] = enc
        if device == "cuda":
            torch.cuda.synchronize()
            c2 = read_counts()
    check_counts(c2, {**{k: 0 for k in c2}, "attention_fwd": encoder_layers(cfg)},
                 "wav2vec_ctc greedy encode")
    ok, report = ctc_near_tie(encs["cuda"], encs["cpu"], toks["cuda"][:, None],
                              toks["cpu"][:, None], beam=1)
    identical = torch.equal(toks["cuda"], toks["cpu"])
    log(f"[w2v ctc] greedy tokens card vs CPU identical {identical}; {json.dumps(report)}")
    if not ok:
        raise AssertionError("wav2vec_ctc greedy tokens differ beyond a near-tie")
    res = {"train": train, "greedy_tokens_identical": identical, "greedy_report": report}
    return res, {k: c1.get(k, 0) + c2[k] for k in c2}


def league_parts(model):
    """The dual / multibranch encode split: the speech (junior) encoder, the other
    stacks, and every layer's league (s2) attention; each name sums its calls."""
    from s2t_tpu_torch.models.s2t_dual import S2TDualModel

    if isinstance(model, S2TDualModel):
        parts = [("dual_speech", model.speech_encoder), ("dual_text", model.text_encoder)]
        layers = list(model.text_encoder.layers)
    else:
        enc = model.encoder
        parts = [("mb_junior", enc.junior)]
        layers = list(enc.senior_stack) + list(enc.textual_stack)
        parts += [("mb_branches", layer) for layer in layers]
    prefix = "dual" if isinstance(model, S2TDualModel) else "mb"
    parts += [(f"{prefix}_league", layer.s2_attn) for layer in layers
              if getattr(layer, "s2_attn", None) is not None]
    return parts


def league_encode(model_cls, cfg, tag, B=64, T=1000):
    """One bf16 encode of B x T frames, timed after a warm-up (the league attention's share
    of it, which a profile gave, is in PERF.md); its launches."""
    model = model_cls(cfg, device="cuda", seed=0)
    feats = torch.randn(B, T, 80, device="cuda")
    lens = torch.full((B,), T, device="cuda")
    with torch.inference_mode():
        model.encode(feats, lens)  # warm-up
        reset_counts()
        encode_s = synced_s(lambda: model.encode(feats, lens))
    counts = read_counts()
    check_counts(counts, {**{k: 0 for k in counts}, "attention_fwd": encoder_layers(cfg)},
                 f"{tag} timed encode")
    res = {"batch": B, "frames": T, "encode_s": encode_s}
    log(f"[{tag} encode] bf16 {B} x {T} frames: {json.dumps(res)}")
    return res, counts


def league_inference_card_vs_cpu(model_cls, cfg32, tag):
    """fp32 on the fixture wavs' features: the beam generator raises on both devices (no
    incremental decoder, as in JAX); the CTC argmax and the argmax of the inference
    forward's teacher-forced decoder logits (the dual text stream from the greedy CTC
    hypothesis) card vs CPU, identical or a near-tie."""
    from s2t_tpu_torch.hub import request_features
    from s2t_tpu_torch.inference.generator import SequenceGenerator
    from s2t_tpu_torch.ops.ctc import ctc_greedy_decode

    feats = [request_features(w) for w in WAVS]
    T = max(f.shape[0] for f in feats)
    x = np.zeros((len(feats), T, 80), np.float32)
    for i, f in enumerate(feats):
        x[i, :f.shape[0]] = f
    lens = torch.tensor([f.shape[0] for f in feats])
    prev = torch.from_numpy(train_batch(np.random.default_rng(35), len(feats), 1, 12, 10000,
                                        [1] * len(feats))["prev_tokens"]).long()
    outs, raised = {}, []
    models = seeded_pair(lambda d: model_cls(cfg32, device=d, seed=0))
    for device in ("cuda", "cpu"):
        model = models[device]
        try:
            SequenceGenerator(model, **GEN).generate({"features": x, "feat_lengths": lens})
        except AttributeError as e:
            raised.append(str(e))
        with torch.inference_mode():
            outs[device] = model(torch.from_numpy(x).to(device), lens.to(device),
                                 prev.to(device))
    if len(raised) != 2:
        raise AssertionError(f"{tag}: the beam generator did not refuse the model: {raised}")
    card, host = outs["cuda"], outs["cpu"]
    ctc_tok = {d: ctc_greedy_decode(o["ctc_logits"], o["encoder_lengths"])[0].cpu()
               for d, o in outs.items()}
    ok, report = ctc_near_tie(card, host, ctc_tok["cuda"][:, None], ctc_tok["cpu"][:, None], 1)
    dl = {d: o["decoder_logits"].float().cpu() for d, o in outs.items()}
    err = (dl["cuda"] - dl["cpu"]).abs().max().item()
    a, c = dl["cuda"].argmax(-1), dl["cpu"].argmax(-1)
    lp = torch.log_softmax(dl["cpu"], -1)
    gaps = (lp.gather(-1, c[..., None]) - lp.gather(-1, a[..., None]))[a != c].tolist()
    dec_ok = all(g <= 2 * err for g in gaps)
    res = {"generator_refuses": raised[0], "ctc_tokens_identical": torch.equal(*ctc_tok.values()),
           "ctc_report": report, "decoder_logits_max_abs_err": err,
           "decoder_argmax_identical": bool((a == c).all()), "decoder_argmax_gaps": gaps}
    log(f"[{tag} inference] fp32 card vs CPU: {json.dumps(res)}")
    if not (ok and dec_ok):
        raise AssertionError(f"{tag}: inference disagrees between the card and the CPU")
    return res


def phase_league():
    """Phase 34: dual.yaml and multibranch.yaml (s2t_dual_s, s2t_multibranch_s) under
    join_speech_and_text_loss: bf16 steps at the bench shape and a timed bf16 encode at the
    presets' depth; 2 fp32 steps and inference card vs CPU at REF_LAYERS a stack."""
    from s2t_tpu_torch.models.s2t_dual import S2TDualModel, s2t_dual_s
    from s2t_tpu_torch.models.s2t_multibranch import S2TMultiBranchModel, s2t_multibranch_s

    out, counts = {}, {k: 0 for k in counters()}
    for name, model_cls, preset, recipe, zero, depth in (
            ("dual", S2TDualModel, s2t_dual_s, DUAL_RECIPE,
             dict(speech_dropout=0.0, speech_attention_dropout=0.0,
                  speech_activation_dropout=0.0),
             {f"{k}_layers": REF_LAYERS for k in ("speech_encoder", "speech_decoder",
                                                  "text_encoder")}),
            ("multibranch", S2TMultiBranchModel, s2t_multibranch_s, MULTIBRANCH_RECIPE,
             dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0),
             {f"{k}_layers": REF_LAYERS for k in ("junior", "senior", "textual", "decoder")})):
        base = dict(vocab_size=10000, max_target_positions=1024)
        cfg32 = preset(**base, **zero, **depth)  # the card-vs-CPU runs' depth
        crit = (recipe["criterion"], recipe["criterion_cfg"])
        parity, c1 = phase_train_parity(cfg32, model_cls, f"{name} train", criterion=crit)
        speed, c2 = phase_train_speed(preset(**base, **({"speech_dtype_str": "bfloat16"}
                                                        if name == "dual" else
                                                        {"dtype_str": "bfloat16"})),
                                      model_cls, f"{name} train speed", n_timed=2,
                                      criterion=crit)
        inference = league_inference_card_vs_cpu(model_cls, cfg32, name)
        encode, c3 = league_encode(model_cls, preset(**base, **({"speech_dtype_str": "bfloat16"}
                                                               if name == "dual" else
                                                               {"dtype_str": "bfloat16"})),
                                   name)
        out[name] = {"parity": parity, "speed": speed, "inference": inference, "encode": encode}
        counts = {k: counts[k] + c1.get(k, 0) + c2[k] + c3[k] for k in counts}
    return out, counts


def write_feature_corpus(root: Path, splits, words, seed=35, lang=None):
    """Seeded (T, 80) feature .npy files (400-1200 frames) and TSVs over ``words``;
    ``lang``: a tgt_lang column per split."""
    rng = np.random.default_rng(seed)
    for split, n in splits.items():
        cols = "id\taudio\tn_frames\ttgt_text\tsrc_text" + ("\ttgt_lang" if lang else "")
        lines = [cols]
        for i in range(n):
            t = int(rng.integers(400, 1201))
            np.save(root / f"{split}{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
            text = " ".join(rng.choice(words[:2000], size=int(rng.integers(10, 31))))
            row = f"{split}{i}\t{split}{i}.npy\t{t}\t{text}\t{text}"
            lines.append(row + (f"\t{lang[split]}" if lang else ""))
        (root / f"{split}.tsv").write_text("\n".join(lines) + "\n")


def recipe_cli(root: Path, tag, sections, data_cfg_kw, splits, lang=None, basis=True):
    """cli.train on a seeded feature corpus for 2 updates and one validation (no BLEU:
    the cut keeps the validation to its losses), the recipe's ``sections`` over mustc/st
    basis.yaml's when ``basis``."""
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.data.dataset import S2TDataConfig
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask

    data = root / tag
    data.mkdir()
    words = [f"w{i}" for i in range(SYMBOLS - (3 if lang else 0))]
    tags = [f"<lang:{l}>" for l in sorted(set((lang or {}).values()))]
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words + tags))
    write_feature_corpus(data, splits, words, lang=lang)
    d = {"task": "speech_to_text", "common": {"seed": 1, "log_interval": 1},
         "dataset": {}, "optimization": {}}
    if basis:
        d["criterion"] = MUSTC_ST_BASIS["criterion"]
        for section in ("dataset", "optimization"):
            d[section] = dict(MUSTC_ST_BASIS[section])
    for key, val in sections.items():
        d[key] = {**d.get(key, {}), **val} if isinstance(val, dict) else val
    d["dataset"].update(data=str(data), max_source_positions=6000)
    d["dataset"].setdefault("valid_subset", "dev")
    d["optimization"]["max_update"] = 2
    d["checkpoint"] = {"save_dir": str(root / f"{tag}_ckpt"), "no_save": True}
    cfg = from_dict(TrainConfig, d)
    task = SpeechToTextTask(cfg, S2TDataConfig(**data_cfg_kw), Dictionary.load(data / "dict.txt"))
    reset_counts()  # the main path: cli.train
    t0 = time.perf_counter()
    out = cli_train.main(cfg, task=task, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    steps = out["trainer"].step
    n_valid = len(task.get_batch_iterator(task.datasets[cfg.dataset.valid_subset],
                                          max_tokens=cfg.dataset.max_tokens, shuffle=False))
    check_counts(counts, {**path_counts(steps, steps + n_valid * len(out["history"])),
                          "fbank": 0}, f"{tag} cli.train")
    losses = [r["loss"] for r in out["train_log"]]
    if steps != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"{tag} cli.train: {out['train_log']}")
    res = {"arch": cfg.arch or "s2t_transformer_s", "steps": steps, "wall_s": wall,
           "train_log": out["train_log"], "valid": out["history"][-1]}
    log(f"[{tag} cli] {json.dumps(res)}")
    return res, counts


def phase_item15(root: Path):
    """Phase 35: quant_noise.yaml (over mustc/st basis.yaml: s2t_transformer_s, CE + CTC)
    and multilingual.yaml (s2t_transformer_m, 3 language splits upsampled at alpha 0.5,
    <lang:xx> tags) through cli.train, 2 updates each."""
    qn, c1 = recipe_cli(root, "quant_noise", QUANT_NOISE_RECIPE, {},
                        {"train": 24, "dev": 4})
    langs = {"train_de_st": "de", "train_fr_st": "fr", "train_es_st": "es", "dev_de_st": "de"}
    ml, c2 = recipe_cli(root, "multilingual", MULTILINGUAL_RECIPE,
                        {"prepend_tgt_lang_tag": True, "sampling_alpha": 0.5},
                        {"train_de_st": 24, "train_fr_st": 8, "train_es_st": 4, "dev_de_st": 4},
                        lang=langs, basis=False)
    return {"quant_noise": qn, "multilingual": ml}, {k: c1[k] + c2[k] for k in c1}


def phase_w2v2_attention():
    """Phase 36: K1f and K1b at wav2vec2_base's shape (B=4 crops of 250,000 samples,
    T'=781, H=12, D=64, bf16; K1b at the recipe's attention dropout 0.1) against their
    plain versions, timed beside scaled_dot_product_attention; and ragged lengths."""
    T = 781
    with torch.inference_mode():
        fwd = attention_case(W2V_BENCH_B, T, 12, 64, torch.bfloat16, "native", [T] * 4,
                             seed=36, time_it=True)
        ragged = attention_case(4, T, 12, 64, torch.float32, "native", [781, 500, 0, 93],
                                seed=37, time_it=False)
    bwd = grad_case(W2V_BENCH_B, T, 12, 64, torch.bfloat16, "native", [T] * 4, 0.1, seed=38,
                    time_it=True)
    log(f"[w2v2 attention] K1f {json.dumps(fwd)}; ragged fp32 {json.dumps(ragged)}; "
        f"K1b {json.dumps(bwd)}")
    if not (fwd["max_abs_err"] <= fwd["atol"] and ragged["max_abs_err"] <= ragged["atol"]):
        raise AssertionError("K1f disagrees with its plain version at the wav2vec2 shape")
    check_grad_case(bwd)
    return {"k1f": fwd, "k1f_ragged_fp32": ragged, "k1b": bwd}


# --------------------------------------------------------------------------- #
# phases 37-41: the text Transformer MT path (item 11's first part) and item 9's tail
# (Berard, the Emformer, wav2vec v1)
MUSTC_MT_BASIS = {  # egs/mustc/mt/conf/basis.yaml
    "task": "translation_with_tokenizer", "common": {"seed": 1, "log_interval": 100},
    "dataset": {"max_tokens": 8192, "max_source_positions": 512, "max_target_positions": 512},
    "optimization": {"max_epoch": 50, "max_update": 100000, "patience": 10},
    "checkpoint": {"keep_best_checkpoints": 10, "keep_last_epochs": 1,
                   "best_checkpoint_metric": "bleu", "maximize_best_checkpoint_metric": True},
    "eval": {"eval_bleu": True, "eval_gen_beam": 5},
    "generation": {"beam": 5, "lenpen": 1.0, "scoring": "sacrebleu",
                   "post_process": "sentencepiece"}}
MUSTC_MT_BASE = {  # egs/mustc/mt/conf/base.yaml
    "arch": "transformer",
    "model": {"encoder_embed_dim": 512, "encoder_ffn_embed_dim": 2048, "encoder_layers": 6,
              "encoder_attention_heads": 8, "decoder_embed_dim": 512,
              "decoder_ffn_embed_dim": 2048, "decoder_layers": 6, "decoder_attention_heads": 8,
              "encoder_normalize_before": True, "decoder_normalize_before": True,
              "share_decoder_input_output_embed": True, "dropout": 0.1,
              "attention_dropout": 0.1, "activation_dropout": 0.1, "activation_fn": "relu"},
    "criterion": "label_smoothed_cross_entropy", "criterion_cfg": {"label_smoothing": 0.1},
    "optimization": {"optimizer": "adam", "adam_betas": [0.9, 0.997], "lr": 0.001,
                     "lr_scheduler": "inverse_sqrt", "warmup_updates": 8000,
                     "warmup_init_lr": 1e-07, "clip_norm": 10.0}}
MUSTC_MT_CTC = {  # egs/mustc/mt/conf/ctc.yaml
    "arch": "transformer_ctc",
    "model": {"ctc_upsampling_ratio": 3, "ctc_out_downsampling": False,
              "ctc_out_downsampling_method": "maxpooling"},
    "criterion": "label_smoothed_cross_entropy_with_ctc",
    "criterion_cfg": {"label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3}}}
MT_V = SYMBOLS + 4  # seeded source and target dictionaries of the ST phases' V
MT_BENCH = dict(B=128, S=64, U=64)  # the recipe's max_tokens 8192: 128 x 64 source tokens
MT_PARITY = dict(B=8, S=48, U=40)
MT_PARITY_TEXT = dict(B=8, S=48)  # bart_batch's lines: the targets' length is the lines'
MT_TIMED = 2  # timed bf16 steps of phases 37-38
MT_SENTENCES = 64  # beam-5 card-vs-CPU sentences (20-token outputs: GEN_SHORT)
MT_CORPUS = {"train": 48, "dev": 8, "test": 16}  # phase 37's cli.train / cli.generate lines
MT_LAYERS = 6  # encoder self-attentions a forward (K1f) and a step (K1b)


def mt_cfg(recipe, dtype="float32", **kw):
    """A recipe's model section on its arch's preset, with the task's context (source and
    target dictionaries of MT_V, basis.yaml's position caps)."""
    model = {**MUSTC_MT_BASE["model"], **recipe["model"], **kw}
    preset = ARCHS.get(recipe["arch"])[1]
    return preset(**model, vocab_size=MT_V, src_vocab_size=MT_V, dtype_str=dtype,
                  max_source_positions=MUSTC_MT_BASIS["dataset"]["max_source_positions"],
                  max_target_positions=MUSTC_MT_BASIS["dataset"]["max_target_positions"])


def text_batch(rng, B, S, U, V=MT_V):
    """Seeded source rows of ragged lengths (the longest S, EOS-terminated, padded with 1)
    and EOS-terminated targets of U tokens with their teacher-forced inputs."""
    lengths = np.concatenate([[S], rng.integers(S // 3, S + 1, size=B - 1)]).astype(np.int32)
    src = rng.integers(4, V, size=(B, S)).astype(np.int64)
    for b, n in enumerate(lengths):
        src[b, n - 1], src[b, n:] = 2, 1
    target = rng.integers(4, V, size=(B, U)).astype(np.int64)
    target[:, -1] = 2
    prev = np.concatenate([np.full((B, 1), 2), target[:, :-1]], axis=1)
    return {"src_tokens": src, "src_lengths": lengths, "prev_tokens": prev, "target": target,
            "target_lengths": np.full((B,), U, np.int32), "ntokens": np.float32(B * U)}


def mt_opt():
    o = MUSTC_MT_BASE["optimization"]
    return OptimizationConfig(optimizer=o["optimizer"], adam_betas=tuple(o["adam_betas"]),
                              lr=o["lr"], lr_scheduler=o["lr_scheduler"],
                              warmup_updates=o["warmup_updates"],
                              warmup_init_lr=o["warmup_init_lr"], clip_norm=o["clip_norm"])


def mt_beam_card_vs_cpu(cfg32, model_cls=None, layers=MT_LAYERS, tag="mt beam", batch=None,
                        view=None):
    """fp32 seeded weights on both devices: beam-5 tokens of ``batch`` (MT_SENTENCES
    sentences of 48 source tokens by default), 20-token outputs; rows that differ must be
    near-ties.  ``model_cls`` (the text Transformer by default) launches K1f ``layers``
    times an encode; ``view(model)`` is what decodes (a multilingual model's pair)."""
    from s2t_tpu_torch.inference.generator import SequenceGenerator
    from s2t_tpu_torch.models.transformer import TransformerModel

    model_cls = model_cls or TransformerModel
    if batch is None:
        batch = text_batch(np.random.default_rng(37), MT_SENTENCES, 48, 4)
    keys = ("src_tokens", "src_lengths")
    toks, secs = {}, {}
    models = seeded_pair(lambda d: model_cls(cfg32, device=d, seed=0))
    for device in ("cuda", "cpu"):
        if view is not None:
            models[device] = view(models[device])
        gen = SequenceGenerator(models[device], input_keys=keys, **GEN_SHORT)
        reset_counts()  # the main path: one encode
        secs[device] = synced_s(lambda: toks.__setitem__(device, gen.generate(batch)[0]))
        if device == "cuda":
            check_counts(read_counts(), {**{k: 0 for k in counters()},
                                         "attention_fwd": layers}, f"{tag} beam-5 decode")
    card, host = toks["cuda"][:, 0].cpu().numpy(), toks["cpu"][:, 0].cpu().numpy()
    src = torch.as_tensor(batch["src_tokens"])
    lens = torch.as_tensor(batch["src_lengths"])
    same = tokens_near_tie(models["cuda"], models["cpu"], src, lens, card, host, 2, tag)
    res = {"sentences": len(card), "identical": same, "card_s": secs["cuda"],
           "cpu_s": secs["cpu"], "rows_differing": int(sum(
               not np.array_equal(a, b) for a, b in zip(card, host)))}
    log(f"[{tag}] fp32 beam 5 card vs CPU: {json.dumps(res)}")
    return res


def write_text_corpus(root: Path, splits, seed=38):
    """Whitespace-token lines over one dictionary of MT_V - 4 words (no config.yaml: the
    card has no yaml package; source and target share dict.txt)."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(MT_V - 4)]
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    for split, n in splits.items():
        for lang, (lo, hi) in (("en", (10, 40)), ("de", (8, 30))):
            lines = [" ".join(rng.choice(words[:2000], size=int(rng.integers(lo, hi))))
                     for _ in range(n)]
            (root / f"{split}.{lang}").write_text("\n".join(lines) + "\n")


def mt_cfg_dict(data: Path, save_dir: Path, recipe):
    """basis.yaml's sections under ``recipe``'s at full width and depth, cut for the card:
    2 updates, validation on the losses (the card has no sacreBLEU), WER scoring of
    cli.generate, 20-token outputs."""
    d = {k: (dict(v) if isinstance(v, dict) else v) for k, v in MUSTC_MT_BASIS.items()}
    for key, val in recipe.items():
        d[key] = {**d.get(key, {}), **val} if isinstance(val, dict) else val
    d["dataset"].update(data=str(data), gen_subset="test", valid_subset="dev")
    d["optimization"]["max_update"] = 2
    d["common"]["log_interval"] = 1
    d["checkpoint"] = {"save_dir": str(save_dir), "no_save": True,
                       "best_checkpoint_metric": "loss",
                       "maximize_best_checkpoint_metric": False}
    d["eval"] = {"eval_bleu": False}
    d["generation"] = {**d["generation"], "scoring": "wer", "max_len_b": 20,
                       "results_path": str(save_dir / "gen")}
    return d


def text_cli(d, tag, layers, n_test, updates=2):
    """cli.train, then cli.generate of the test split, of the config dict ``d`` on the
    card; K1f ``layers`` an encode and K1b ``layers`` a step; ``updates`` updates and
    ``n_test`` hypotheses.  Returns (cli.train's output, cli.generate's, the launches,
    train s, generate s)."""
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict

    cfg = from_dict(TrainConfig, d)
    reset_counts()  # the main path: cli.train (2 steps, validations) and cli.generate
    t0 = time.perf_counter()
    out = cli_train.main(cfg, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    task = out["task"]
    n_valid = len(task.get_batch_iterator(task.datasets["dev"], max_tokens=cfg.dataset.max_tokens,
                                          shuffle=False))
    t0 = time.perf_counter()
    gen = cli_generate.main(cfg, out["model"].state_dict(), device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    n_test_batches = len(task.get_batch_iterator(task.load_dataset("test"),
                                                 max_tokens=cfg.dataset.max_tokens, shuffle=False))
    steps = out["trainer"].step
    want = {**{k: 0 for k in counters()},  # a validation after each epoch
            "attention_fwd": layers * (steps + n_valid * len(out["history"]) + n_test_batches),
            "attention_bwd": layers * steps}
    check_counts(counts, want, f"{tag} cli.train + cli.generate")
    hyps = sum(line.startswith("H-") for line in
               (gen["out_dir"] / "generate-test.txt").read_text().splitlines())
    if steps != updates or gen["n_utts"] != n_test or hyps != n_test:
        raise AssertionError(f"{tag} CLIs: {steps} steps, {gen['n_utts']} decoded, {hyps} H-")
    return out, gen, counts, train_s, gen_s


def mt_cli(root: Path):
    """cli.train 2 updates of base.yaml over basis.yaml on a seeded whitespace corpus,
    then cli.generate (beam 5) of its test split, and hub.from_pretrained answering
    text requests on the card and on the CPU."""
    from s2t_tpu_torch.hub import from_pretrained
    from s2t_tpu_torch.utils.checkpoint import save_tree

    data = root / "mt_data"
    data.mkdir()
    write_text_corpus(data, MT_CORPUS)
    d = mt_cfg_dict(data, root / "mt_ckpt", MUSTC_MT_BASE)
    out, gen, counts, train_s, gen_s = text_cli(d, "MT", MT_LAYERS, MT_CORPUS["test"])
    # hub: text requests answered on the card and on the CPU from the trained weights
    ckpt = root / "mt_model.pt"
    save_tree(ckpt, {"params": out["model"].state_dict()})
    requests = (data / "test.en").read_text().splitlines()[:4]
    answers = {dev: from_pretrained(ckpt, config=d, device=dev).generate(requests)
               for dev in ("cuda", "cpu")}
    if not all(isinstance(a, str) for a in answers["cuda"]):
        raise AssertionError(f"hub answers: {answers['cuda']}")
    res = {"train_s": train_s, "generate_s": gen_s, "train_log": out["train_log"],
           "valid": out["history"][-1], "score": gen["score_str"],
           "hub_card_equals_cpu": answers["cuda"] == answers["cpu"],
           "hub_answers": answers["cuda"]}
    log(f"[mt cli] {json.dumps(res)}")
    return res, counts


def mt_kernel_rows():
    """K1f / K1b at the MT shape (128 x 64 source tokens, 8 heads of 64, bf16, K1b at the
    recipe's attention dropout 0.1) and K3 / K4 at transformer_ctc's (T = 3 x 64 upsampled
    frames, 63-label targets: S = 127), against their plain versions, timed beside SDPA /
    ctc_loss and bounded."""
    B, S = MT_BENCH["B"], MT_BENCH["S"]
    lengths = text_batch(np.random.default_rng(3), B, S, 2)["src_lengths"]
    with torch.inference_mode():
        fwd = attention_case(B, S, 8, 64, torch.bfloat16, "native", lengths, seed=40,
                             time_it=True)
    bwd = grad_case(B, S, 8, 64, torch.bfloat16, "native", lengths, 0.1, seed=41, time_it=True)
    ctc = ctc_case(B, 3 * S, MT_BENCH["U"] - 1, MT_V, seed=42, time_it=True)
    log(f"[mt kernels] K1f {json.dumps(fwd)}; K1b {json.dumps(bwd)}; K3 / K4 {json.dumps(ctc)}")
    if not fwd["max_abs_err"] <= fwd["atol"]:
        raise AssertionError("K1f disagrees with its plain version at the MT shape")
    check_grad_case(bwd)
    if not (ctc["alpha_err"] <= CTC_ATOL["alpha"] and ctc["nll_err"] <= CTC_ATOL["alpha"]
            and ctc["demit_err"] <= CTC_ATOL["demit"] and ctc["unreached_agree"]):
        raise AssertionError(f"CTC kernels disagree with their plain versions: {ctc}")
    return {"k1f": fwd, "k1b": bwd, "k3_k4": ctc}


def phase_mt(root: Path):
    """Phase 37: egs/mustc/mt/conf/base.yaml on basis.yaml (transformer: pre-norm 512 /
    2048, 6 + 6 layers, 8 heads, shared decoder embeddings, dictionaries of 10,000): bf16
    steps at 128 x 64 source and 64 target tokens, cli.train -> cli.generate, hub text
    requests; at REF_LAYERS a side 2 fp32 steps and beam-5 tokens card vs CPU."""
    from s2t_tpu_torch.models.transformer import TransformerModel, text_forward

    crit = (MUSTC_MT_BASE["criterion"], MUSTC_MT_BASE["criterion_cfg"])
    per_step = {"attention_fwd": MT_LAYERS, "attention_bwd": MT_LAYERS}
    rng = np.random.default_rng(37)
    parity, parity_launches = phase_train_parity(
        mt_cfg(MUSTC_MT_BASE, **NO_DROPOUT, **REF_DEPTH), TransformerModel, "mt train",
        criterion=crit, per_step={k: REF_LAYERS for k in per_step},
        batches=[text_batch(rng, **MT_PARITY) for _ in range(2)], forward_fn=text_forward)
    speed, speed_launches = phase_train_speed(
        mt_cfg(MUSTC_MT_BASE, dtype="bfloat16"), TransformerModel, "mt train speed",
        n_timed=MT_TIMED, criterion=crit, per_step=per_step,
        batch=text_batch(np.random.default_rng(0), **MT_BENCH), forward_fn=text_forward,
        opt=mt_opt())
    speed["tokens_per_s"] = speed["steps_per_s"] * MT_BENCH["B"] * MT_BENCH["U"]
    cli, cli_launches = mt_cli(root)
    beam = mt_beam_card_vs_cpu(mt_cfg(MUSTC_MT_BASE, **REF_DEPTH), layers=REF_LAYERS)
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] + cli_launches[k]
                for k in counters()}
    launches["attention_fwd"] += REF_LAYERS  # the beam decode's one encode on the card
    return {"parity": parity, "speed": speed, "cli": cli, "beam": beam}, launches


def phase_mt_ctc():
    """Phase 38: egs/mustc/mt/conf/ctc.yaml on basis.yaml (transformer_ctc, ratio 3, CE +
    0.3 CTC on the encoder at 3 x the source length): 2 fp32 steps card vs CPU, bf16
    steps at phase 37's shape (K3 / K4 at T = 192 upsampled frames)."""
    from s2t_tpu_torch.models.transformer import TransformerModel, text_forward

    crit = (MUSTC_MT_CTC["criterion"], MUSTC_MT_CTC["criterion_cfg"])
    per_step = {"attention_fwd": MT_LAYERS, "attention_bwd": MT_LAYERS, "ctc_alpha": 1,
                "ctc_beta_grad": 1}
    rng = np.random.default_rng(38)
    parity, parity_launches = phase_train_parity(
        mt_cfg(MUSTC_MT_CTC, **NO_DROPOUT, **REF_DEPTH), TransformerModel, "mt ctc train",
        criterion=crit, per_step={**per_step, "attention_fwd": REF_LAYERS,
                                  "attention_bwd": REF_LAYERS},
        batches=[text_batch(rng, **MT_PARITY) for _ in range(2)], forward_fn=text_forward)
    speed, speed_launches = phase_train_speed(
        mt_cfg(MUSTC_MT_CTC, dtype="bfloat16"), TransformerModel, "mt ctc train speed",
        n_timed=MT_TIMED, criterion=crit, per_step=per_step,
        batch=text_batch(np.random.default_rng(0), **MT_BENCH), forward_fn=text_forward,
        opt=mt_opt())
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] for k in counters()}
    return {"parity": parity, "speed": speed,
            "ctc_frames": MT_BENCH["S"] * MUSTC_MT_CTC["model"]["ctc_upsampling_ratio"]}, launches


# a step that launches none of the kernels
NO_KERNEL = {"attention_fwd": 0, "attention_bwd": 0, "ctc_alpha": 0, "ctc_beta_grad": 0}
BERARD_ARCH = "s2t_berard_512_5_3"
BERARD_TIMED = 2


def argmax_card_vs_cpu(card_logits, host_logits, tag):
    """Argmax positions that differ between the card and the CPU must be near-ties: the
    CPU's two logits within 2 x the largest card error."""
    card, host = card_logits.float().cpu(), host_logits.float().cpu()
    err = (card - host).abs().max().item()
    a, b = card.argmax(-1), host.argmax(-1)
    diff = a != b
    gaps = (host.gather(-1, a[..., None]) - host.gather(-1, b[..., None])).abs()[..., 0][diff]
    res = {"max_abs_err": err, "positions": int(a.numel()), "differing": int(diff.sum()),
           "largest_gap": gaps.max().item() if gaps.numel() else 0.0}
    log(f"[{tag}] teacher-forced argmax card vs CPU: {json.dumps(res)}")
    if gaps.numel() and not res["largest_gap"] <= 2 * err:
        raise AssertionError(f"{tag}: the argmax differs off a near-tie: {res}")
    return res


def phase_berard():
    """Phase 39: s2t_berard_512_5_3 (5 bidirectional LSTM layers of 512 through cuDNN, a
    3-cell decoder of 1024): bf16 steps at 40 x 1000 frames with 40-token targets; at
    REF_LAYERS LSTMs a side, 2 fp32 steps card vs CPU and the teacher-forced argmax card
    vs CPU (JAX cannot beam-decode it)."""
    from s2t_tpu_torch.models.berard import BerardModel

    preset = ARCHS.get(BERARD_ARCH)[1]
    crit = ("label_smoothed_cross_entropy", {"label_smoothing": 0.1})
    ref = {"encoder_layers": REF_LAYERS, "decoder_layers": REF_LAYERS}  # the references'
    parity, _ = phase_train_parity(preset(vocab_size=10000, dropout=0.0, **ref), BerardModel,
                                   "berard train", criterion=crit, per_step=NO_KERNEL)
    speed, _ = phase_train_speed(preset(vocab_size=10000, dtype_str="bfloat16"), BerardModel,
                                 "berard train speed", n_timed=BERARD_TIMED, U=40,
                                 criterion=crit, per_step=NO_KERNEL)
    batch = train_batch(np.random.default_rng(39), 8, 1000, 40, 10000, [1000, 900, 700, 512,
                                                                         1000, 640, 333, 800])
    logits = {}
    models = seeded_pair(lambda d: BerardModel(preset(vocab_size=10000, **ref), device=d, seed=0))
    for device in ("cuda", "cpu"):
        model = models[device]
        b = {k: torch.as_tensor(batch[k]).to(device) for k in ("features", "feat_lengths",
                                                                "prev_tokens")}
        with torch.inference_mode():
            logits[device] = model(b["features"], b["feat_lengths"].long(),
                                   b["prev_tokens"].long())["decoder_logits"]
    argmax = argmax_card_vs_cpu(logits["cuda"], logits["cpu"], "berard")
    return {"parameters": sum(p.numel() for p in model.parameters()), "parity": parity,
            "speed": speed, "argmax": argmax}, {k: 0 for k in counters()}


EMFORMER_B = 40  # greedy card-vs-CPU rows of 1000 frames
# With seeded random weights the Emformer's keys include the un-normed memory and left
# context, whose norms grow layer by layer, so its attention saturates and float32
# differences grow with depth: at 12 layers a 1e-6 relative perturbation of the features
# moves the valid CTC logits by units, in JAX as in the port, and the port and JAX differ
# by as much (tests/test_torch_emformer_depth.py); ``emformer_sensitivity`` records it at
# both depths each run.  Card-vs-CPU parity is held at this depth; the full-depth model
# streams on the card.
EMFORMER_PARITY_LAYERS = 3


def emformer_sensitivity(model, feats, lengths):
    """Max change of the valid CTC logits under a seeded 1e-6 relative perturbation of
    the features, on the model's device."""
    dev = model.device
    x = torch.from_numpy(feats).to(dev)
    noise = torch.from_numpy(np.random.default_rng(1).normal(size=feats.shape)).float().to(dev)
    lens = torch.from_numpy(lengths).long().to(dev)
    with torch.inference_mode():
        a, b = model(x, lens), model(x * (1 + 1e-6 * noise), lens)
    valid = lengths_to_mask(a["encoder_lengths"], a["ctc_logits"].shape[1])
    return (a["ctc_logits"] - b["ctc_logits"]).abs()[valid].max().item()


def emformer_stream(model, feats):
    """``streaming_step`` over one row of raw features (1, N, 80): chunks of 4 (S + R)
    frames (one segment of subsampled frames and its lookahead) a hop of 4 S apart, the
    state carried from chunk to chunk; the CTC logits of every segment, concatenated."""
    S, R = model.cfg.segment_size, model.cfg.right_context
    x = torch.from_numpy(feats).to(model.device)
    states, outs = model.init_stream_state(1), []
    with torch.inference_mode():
        for start in range(0, x.shape[1] - 4 * (S + R) + 1, 4 * S):
            y, states = model.streaming_step(x[:, start:start + 4 * (S + R)], states)
            outs.append(y)
    return torch.cat(outs, dim=1)


def phase_emformer():
    """Phase 40: emformer_s (12 layers of 256, segments of 16 with 8 left and 4 lookahead
    frames, 8 memory slots) under the CTC loss: 2 fp32 steps card vs CPU (K3 / K4), greedy
    CTC tokens of 40 x 1000 frames card vs CPU and a 1000-frame stream through
    streaming_step card vs CPU, at EMFORMER_PARITY_LAYERS; at 12 layers the sensitivity to
    a 1e-6 input perturbation, and the stream on the card (finite logits, one segment a
    step)."""
    from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
    from s2t_tpu_torch.models.streaming import EmformerModel, emformer_s

    per_step = {"ctc_alpha": 1, "ctc_beta_grad": 1}
    parity_cfg = emformer_s(vocab_size=10000, encoder_layers=EMFORMER_PARITY_LAYERS)
    parity, parity_launches = phase_train_parity(
        parity_cfg.replace(**NO_DROPOUT), EmformerModel, "emformer train",
        criterion=("ctc", {}), per_step=per_step)
    rng = np.random.default_rng(40)
    lengths = np.concatenate([[1000], rng.integers(400, 1001, size=EMFORMER_B - 1)])
    feats = rng.normal(size=(EMFORMER_B, 1000, 80)).astype(np.float32)
    batch = {"features": feats, "feat_lengths": lengths.astype(np.int32)}
    enc, tok, stream = {}, {}, {}
    models = seeded_pair(lambda d: EmformerModel(parity_cfg, device=d, seed=0))
    for device in ("cuda", "cpu"):
        tok[device], _, enc[device] = CTCGenerator(models[device], CTCDecoder()).generate(batch)
        stream[device] = emformer_stream(models[device], feats[:1]).cpu()
    card_tok, host_tok = tok["cuda"][:, 0].cpu(), tok["cpu"][:, 0].cpu()
    near, report = ctc_near_tie(enc["cuda"], enc["cpu"], card_tok, host_tok, 1)
    if not near:
        raise AssertionError(f"emformer greedy tokens differ off a near-tie: {report}")
    stream_err = (stream["cuda"] - stream["cpu"]).abs().max().item()
    sensitivity = {EMFORMER_PARITY_LAYERS: emformer_sensitivity(models["cuda"], feats[:4],
                                                                lengths[:4])}
    model = EmformerModel(emformer_s(vocab_size=10000), device="cuda", seed=0)
    sensitivity[model.cfg.encoder_layers] = emformer_sensitivity(model, feats[:4], lengths[:4])
    full = emformer_stream(model, feats[:1])
    S = model.cfg.segment_size
    steps = (1000 - 4 * (S + model.cfg.right_context)) // (4 * S) + 1
    res = {"parameters": sum(p.numel() for p in model.parameters()),
           "parity_layers": EMFORMER_PARITY_LAYERS, "parity": parity,
           "logit_change_under_1e-6_input_noise": sensitivity,
           "greedy_rows": EMFORMER_B, "greedy_identical":
           bool(torch.equal(card_tok, host_tok)), "near_tie_report": report,
           "stream_steps": steps, "stream_card_vs_cpu_max_abs_err": stream_err,
           "full_depth_stream_shape": list(full.shape),
           "full_depth_stream_finite": bool(torch.isfinite(full).all())}
    log(f"[emformer] {json.dumps(res)}")
    if not stream_err <= ENC_ATOL or tuple(full.shape) != (1, steps * S, 10000) or \
            not res["full_depth_stream_finite"]:
        raise AssertionError(f"emformer streaming disagrees: {res}")
    return res, {k: parity_launches.get(k, 0) for k in counters()}


W2V1_PARITY = dict(lengths=[48000, 35000], N=48000)  # 3 s and 2.2 s crops
W2V1_BENCH = dict(B=10, N=150000)  # fairseq's wav2vec example: --max-sample-size 150000


def w2v1_forward(model, batch, train=False, generator=None):
    """The audio_pretraining task's forward for wav2vec v1 (the Gumbel temperature at its
    schedule's start; ``draws`` handed over where the batch has them)."""
    return model(batch["source"], batch["lengths"], train=train, generator=generator,
                 draws=batch.get("draws"))


def w2v1_card_vs_cpu(cfg, tag):
    """fp32, the same seeded weights and handed-over negatives (and Gumbel uniforms) on
    both devices: one training forward, the CPC loss and backward; the scores, loss and
    every gradient."""
    from s2t_tpu_torch.models.wav2vec import Wav2VecModel
    from s2t_tpu_torch.models.wav2vec2 import conv_out_lengths

    lengths, N = W2V1_PARITY["lengths"], W2V1_PARITY["N"]
    src = wave_batch(np.random.default_rng(41), lengths, N)
    T = int(conv_out_lengths(torch.tensor([N]), cfg.conv_feature_layers)[0])
    rng = np.random.default_rng(41)
    draws = {"negatives": torch.from_numpy(rng.random((2, T, cfg.num_negatives),
                                                      dtype=np.float32))}
    if cfg.vq_type == "gumbel":
        draws["gumbel_uniform"] = torch.from_numpy(
            rng.random((2, T, cfg.vq_groups, cfg.vq_vars), dtype=np.float32) * (1 - 2e-6) + 1e-6)
    crit = build_criterion("wav2vec", {})
    runs = {}
    models = seeded_pair(lambda d: Wav2VecModel(cfg, device=d, seed=0, for_training=True))
    for device in ("cuda", "cpu"):
        model = models[device]
        reset_counts()
        out = model(torch.from_numpy(src).to(device), torch.tensor(lengths).to(device),
                    train=True, generator=torch.Generator(device=device).manual_seed(0),
                    draws={k: v.to(device) for k, v in draws.items()})
        loss, size, _ = crit(out, {})
        loss.backward()
        if device == "cuda":
            torch.cuda.synchronize()
            check_counts(read_counts(), {k: 0 for k in counters()}, f"{tag} step")
        runs[device] = {"loss": loss.item(), "size": size.item(),
                        "scores": out["cpc_logits"].detach().cpu(),
                        "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()}}
    card, host = runs["cuda"], runs["cpu"]
    score_err = ((card["scores"] - host["scores"]).abs().max()
                 / host["scores"].abs().max()).item()
    loss_err = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    grad_err, worst = grads_card_vs_cpu(card["grads"], host["grads"])
    res = {"vq_type": cfg.vq_type, "frames": T, "loss": [card["loss"], host["loss"]],
           "loss_rel_err": loss_err, "sample_size": card["size"],
           "score_rel_err": score_err, "max_grad_rel_err": grad_err, "worst_grads": worst}
    log(f"[{tag}] fp32 card vs CPU: {json.dumps(res)}")
    if not (loss_err <= TRAIN_RTOL["loss"] and score_err <= TRAIN_RTOL["loss"]
            and grad_err <= W2V_GRAD_RTOL):
        raise AssertionError(f"{tag}: the card and the CPU disagree: {res}")
    return res


def phase_w2v1():
    """Phase 41: wav2vec (v1, the base preset: 8 extractor and 12 aggregator convs of 512,
    12 prediction steps, 10 negatives) under the CPC loss: fp32 scores, loss and gradients
    card vs CPU on handed-over draws, with no quantizer and with the k-means and Gumbel
    ones; a bf16 step on 10 x 150,000-sample crops."""
    from s2t_tpu_torch.models.wav2vec import Wav2VecModel, wav2vec_base

    parity = {vq: w2v1_card_vs_cpu(wav2vec_base(vq_type=vq), f"w2v1 {vq}")
              for vq in ("none", "kmeans", "gumbel")}
    lengths = [W2V1_BENCH["N"]] * W2V1_BENCH["B"]
    src = wave_batch(np.random.default_rng(0), lengths, W2V1_BENCH["N"])
    speed, _ = phase_train_speed(
        wav2vec_base(dtype_str="bfloat16"), Wav2VecModel, "w2v1 train speed", n_timed=2,
        criterion=("wav2vec", {}), per_step=NO_KERNEL,
        batch={"source": src, "lengths": np.asarray(lengths)}, forward_fn=w2v1_forward,
        opt=OptimizationConfig(lr=1e-4, warmup_updates=100))
    speed["samples_per_s"] = speed["steps_per_s"] * W2V1_BENCH["B"] * W2V1_BENCH["N"]
    return {"parity": parity, "speed": speed}, {k: 0 for k in counters()}

# --------------------------------------------------------------------------- #
# phases 42-45: the text zoo's recipes (ConvS2S, the wikitext-103 adaptive LM, the
# alignment Transformer, the NAT family); copies of the recipes' YAML (tests hold them
# to the files)
FCONV_RECIPE = {  # egs/wmt16/mt/conf/fconv.yaml
    "task": "translation", "arch": "fconv_wmt_en_de", "criterion": "label_smoothed_cross_entropy",
    "criterion_cfg": {"label_smoothing": 0.1},
    "optimization": {"lr": 0.5, "lr_scheduler": "fixed", "clip_norm": 0.1, "max_epoch": 80}}
ADAPTIVE_LM_RECIPE = {  # egs/wikitext103/lm/adaptive_lm.yaml
    "task": "language_modeling", "arch": "transformer_lm_wiki103", "criterion": "adaptive_loss",
    "task_cfg": {"tokens_per_sample": 512},
    "optimization": {"lr": 1.0, "lr_scheduler": "cosine", "warmup_updates": 16000,
                     "max_update": 286000, "clip_norm": 0.1}}
ALIGN_RECIPE = {  # egs/wmt16/align/transformer_align.yaml
    "task": "translation", "arch": "transformer_align",
    "criterion": "label_smoothed_cross_entropy_with_alignment",
    "criterion_cfg": {"label_smoothing": 0.1, "alignment_lambda": 0.05},
    "task_cfg": {"load_alignments": True},
    "model": {"alignment_layer": 4, "alignment_heads": 1},
    "optimization": {"lr": 0.0007, "warmup_updates": 4000, "max_update": 200000}}
NAT_RECIPES = {  # egs/wmt16/nat/{cmlm,levenshtein,insertion,nacrf}.yaml
    "cmlm": {"task": "translation_lev", "arch": "cmlm_transformer", "criterion": "nat_loss",
             "criterion_cfg": {"label_smoothing": 0.1, "length_loss_factor": 0.1},
             "task_cfg": {"noise": "random_mask"},
             "optimization": {"lr": 0.0005, "warmup_updates": 10000, "max_update": 300000},
             "generation": {"iter_decode_max_iter": 10}},
    "levenshtein": {"task": "translation_lev", "arch": "levenshtein_transformer",
                    "criterion": "nat_loss",
                    "optimization": {"lr": 0.0005, "warmup_updates": 10000},
                    "generation": {"iter_decode_max_iter": 10}},
    "insertion": {"task": "translation_lev", "arch": "insertion_transformer",
                  "criterion": "nat_loss", "task_cfg": {"insertion_tau": 1.0},
                  "optimization": {"lr": 0.0005, "warmup_updates": 10000, "max_update": 300000},
                  "generation": {"iter_decode_max_iter": 10, "iter_decode_eos_penalty": 1.0}},
    "nacrf": {"task": "translation_lev", "arch": "nacrf_transformer", "criterion": "nat_loss",
              "criterion_cfg": {"label_smoothing": 0.1}, "task_cfg": {"noise": "full_mask"},
              "model": {"crf_rank": 32, "crf_beam": 64, "word_ins_factor": 0.5},
              "optimization": {"lr": 0.0005, "warmup_updates": 10000, "max_update": 300000},
              "generation": {"iter_decode_max_iter": 1}}}
WIKI103_V = 267744  # wikitext-103's vocabulary: the adaptive clusters 20000 / 40000 / 207744
LM_BENCH = dict(B=8, L=512)  # 8 blocks of tokens_per_sample
LM_PARITY = dict(B=2, L=64)  # the CPU reference's blocks: its adaptive softmax spans 267,744
LM_CORPUS = {"train": 9 * 512, "dev": 2 * 512}  # tokens of phase 43's seeded text
ZOO_TIMED = 2  # timed bf16 steps of phases 42-45
BART_TIMED = 3  # phases 46-47's
ZOO_CORPUS = {"train": 32, "dev": 8, "test": 16}  # phases 42 and 44's cli.train lines
NAT_SENTENCES = 8  # the refinement decodes' card-vs-CPU sentences
NAT_LAYERS = 6  # the NAT presets' encoder and decoder layers: K1f each a pass
PAD_PLANT = 1.02  # plant_pad's scale: pad wins where the planted token would, and a little more
FCONV_PARITY_LR = 1e-3  # fixed; see phase_fconv
# the fp32 references' depth: one convolution of each of the preset's widths a side (the
# residual projections and the k = 1 windows kept); the bf16 steps and the CLI run all 15
FCONV_REF_CONVS = ((512, 3), (1024, 3), (2048, 1))
FCONV_REF = {"encoder_convs": FCONV_REF_CONVS, "decoder_convs": FCONV_REF_CONVS}
# the fp32 parity steps' warm-up: the recipes' (4000, 10000 updates) start near lr 0, where
# the bound 2 sum(lr) on the weights' card-vs-CPU difference falls below their float32
# rounding (measured: 1.04e-7 against 1e-7 after a Levenshtein step at lr 5e-8)
PARITY_WARMUP = 4


def recipe_opt(recipe, **kw):
    """The recipe's optimization section as the Trainer's config (epochs are the CLI's)."""
    o = {k: v for k, v in recipe["optimization"].items() if k != "max_epoch"}
    return OptimizationConfig(**{**o, **kw})


def zoo_model_cfg(recipe, dtype="float32", vocab=MT_V, **kw):
    from s2t_tpu_torch.models import build  # noqa: F401  (registers every preset)

    preset = ARCHS.get(recipe["arch"])[1]
    ctx = {"vocab_size": vocab} if recipe["task"] == "language_modeling" else {
        "vocab_size": vocab, "src_vocab_size": vocab, "max_source_positions": 1024,
        "max_target_positions": 1024}
    return preset(**{**recipe.get("model", {}), **kw}, **ctx, dtype_str=dtype)


def align_pairs(batch, rng, P=12):
    """Seeded word alignments of a text batch: (B, P, 2) (source, target) index pairs
    inside each row, -1 padded."""
    B = len(batch["src_lengths"])
    U = batch["target"].shape[1]
    pairs = np.full((B, P, 2), -1, np.int32)
    for b, n in enumerate(batch["src_lengths"]):
        k = int(rng.integers(1, P + 1))
        pairs[b, :k, 0] = rng.integers(0, n - 1, size=k)
        pairs[b, :k, 1] = rng.integers(0, U - 1, size=k)
    return {**batch, "alignments": pairs}


def lm_batch(rng, B, L, V=WIKI103_V):
    """Seeded blocks over the whole vocabulary (so every adaptive cluster is hit), the
    targets shifted right with EOS in front."""
    target = rng.integers(4, V, size=(B, L)).astype(np.int64)
    prev = np.concatenate([np.full((B, 1), 2), target[:, :-1]], axis=1)
    return {"prev_tokens": prev, "target": target, "target_lengths": np.full((B,), L, np.int32),
            "ntokens": np.float32(B * L)}


def nat_draws(rng, name, batch):
    """Handed-over uniforms of a translation_lev step (the same on both devices)."""
    B, U = batch["target"].shape

    def u(*shape):
        return rng.random(shape, dtype=np.float32)

    if name == "insertion":
        return {"keep_rates": u(B, 1), "keep_uniforms": u(B, U)}
    if name == "levenshtein":
        return {"delete_scores": u(B, U + 1), "delete_fractions": u(B)}
    return {"noise_scores": u(B, U), "noise_fractions": u(B)}


def recipe_task(root: Path, recipe):
    """The recipe's task over a dictionary of MT_V - 4 words in ``root`` (no config.yaml:
    the card has no yaml package)."""
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.tasks import setup_task

    if not (root / "dict.txt").exists():
        root.mkdir(parents=True, exist_ok=True)
        (root / "dict.txt").write_text("".join(f"w{i} 1\n" for i in range(MT_V - 4)))
    d = {k: v for k, v in recipe.items() if k in ("task", "arch", "task_cfg", "model",
                                                   "generation")}
    return setup_task(from_dict(TrainConfig, {**d, "dataset": {"data": str(root)}}))


def zoo_cli(root: Path, tag, recipe, layers=0, align=False, lr=None):
    """cli.train 2 updates of ``recipe`` (at ``lr`` in place of its own, if given) at full
    width and depth on a seeded whitespace corpus (``align``: with seeded Pharaoh
    alignments), then cli.generate (beam 5, 20 tokens) of its test split (``text_cli``);
    every training loss and gradient norm and the validation loss must be finite."""
    data = root / f"{tag}_data"
    data.mkdir()
    write_text_corpus(data, ZOO_CORPUS)
    if align:
        rng = np.random.default_rng(44)
        for split in ZOO_CORPUS:
            src = (data / f"{split}.en").read_text().splitlines()
            tgt = (data / f"{split}.de").read_text().splitlines()
            (data / f"{split}.align").write_text("".join(" ".join(
                f"{rng.integers(0, len(a.split()))}-{rng.integers(0, len(b.split()))}"
                for _ in range(int(rng.integers(0, 6)))) + "\n" for a, b in zip(src, tgt)))
    save = root / f"{tag}_ckpt"
    d = {k: (dict(v) if isinstance(v, dict) else v) for k, v in recipe.items()}
    d["optimization"] = {**d["optimization"], "max_update": 2, **({"lr": lr} if lr else {})}
    d.update(dataset={"data": str(data), "max_tokens": 4096},
             common={"log_interval": 1},
             checkpoint={"save_dir": str(save), "no_save": True,
                         "best_checkpoint_metric": "loss"},
             eval={"eval_bleu": False},
             generation={"beam": 5, "max_len_b": 20, "scoring": "wer",
                         "results_path": str(save / "gen")})
    out, gen, counts, train_s, gen_s = text_cli(d, tag, layers, ZOO_CORPUS["test"])
    res = {"train_s": train_s, "generate_s": gen_s, "train_log": out["train_log"],
           "valid": out["history"][-1], "score": gen["score_str"],
           "lr": d["optimization"]["lr"]}
    log(f"[{tag} cli] {json.dumps(res)}")
    if not all(math.isfinite(r[k]) for r in out["train_log"] for k in ("loss", "gnorm")) \
            or not math.isfinite(res["valid"]["loss"]):
        raise AssertionError(f"{tag} cli.train: a loss or gradient norm is not finite")
    return res, counts


def phase_fconv(root: Path):
    """Phase 42: egs/wmt16/mt/conf/fconv.yaml (fconv_wmt_en_de: 768 embed; 9 x 512, 4 x
    1024, 2 x 2048 (k = 1) GLU convs a side; dictionaries of 10,000), everything under
    ``fixed`` at lr FCONV_PARITY_LR (the recipe's 0.5 moves every weight by about 0.5 in
    Adam's first step, where a float32 sign flip of a near-zero gradient moves it by
    1.0, and its second update's loss is NaN on the card): 2 fp32 steps card vs CPU and
    beam-5 tokens card vs CPU through the rolling windows (the k = 1 layers' are empty)
    at FCONV_REF_CONVS a side, bf16 steps at 128 x 64 / 64 tokens, cli.train ->
    cli.generate with finite losses at full depth.  No kernel runs: fconv is outside
    Pallas in JAX too."""
    from s2t_tpu_torch.models.fconv import FConvModel
    from s2t_tpu_torch.models.transformer import text_forward

    crit = (FCONV_RECIPE["criterion"], FCONV_RECIPE["criterion_cfg"])
    opt = recipe_opt(FCONV_RECIPE, lr=FCONV_PARITY_LR)
    rng = np.random.default_rng(42)
    parity, _ = phase_train_parity(
        zoo_model_cfg(FCONV_RECIPE, dropout=0.0, **FCONV_REF), FConvModel, "fconv train",
        criterion=crit,
        per_step=NO_KERNEL, batches=[text_batch(rng, **MT_PARITY) for _ in range(2)],
        forward_fn=text_forward, opt=opt)
    speed, _ = phase_train_speed(
        zoo_model_cfg(FCONV_RECIPE, dtype="bfloat16"), FConvModel, "fconv train speed",
        n_timed=ZOO_TIMED, criterion=crit, per_step=NO_KERNEL,
        batch=text_batch(np.random.default_rng(0), **MT_BENCH), forward_fn=text_forward, opt=opt)
    speed["tokens_per_s"] = speed["steps_per_s"] * MT_BENCH["B"] * MT_BENCH["U"]
    cli, cli_launches = zoo_cli(root, "fconv", FCONV_RECIPE, lr=FCONV_PARITY_LR)
    beam = mt_beam_card_vs_cpu(zoo_model_cfg(FCONV_RECIPE, **FCONV_REF), FConvModel, 0,
                               "fconv beam")
    return {"parity": parity, "speed": speed, "cli": cli, "beam": beam}, cli_launches


def lm_cli(root: Path):
    """cli.train 2 updates of adaptive_lm.yaml at full width and depth under ``cosine``
    on a seeded text file over wikitext-103's vocabulary size."""
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict

    data = root / "lm_data"
    data.mkdir()
    rng = np.random.default_rng(43)
    (data / "dict.txt").write_text("".join(f"w{i} 1\n" for i in range(WIKI103_V - 4)))
    for split, n in LM_CORPUS.items():
        ids = rng.integers(0, WIKI103_V - 4, size=n)
        lines = [" ".join(f"w{i}" for i in ids[j:j + 64]) for j in range(0, n, 64)]
        (data / f"{split}.txt").write_text("\n".join(lines) + "\n")
    d = {k: (dict(v) if isinstance(v, dict) else v) for k, v in ADAPTIVE_LM_RECIPE.items()}
    d["optimization"] = {**d["optimization"], "max_update": 2}
    d.update(dataset={"data": str(data), "max_tokens": LM_BENCH["B"] * LM_BENCH["L"]},
             common={"log_interval": 1},
             checkpoint={"save_dir": str(root / "lm_ckpt"), "no_save": True,
                         "best_checkpoint_metric": "loss"})
    cfg = from_dict(TrainConfig, d)
    reset_counts()
    t0 = time.perf_counter()
    out = cli_train.main(cfg, device="cuda")
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts(counts, {k: 0 for k in counters()}, "adaptive LM cli.train")
    if out["trainer"].step != 2 or not all(math.isfinite(r["loss"]) for r in out["train_log"]):
        raise AssertionError(f"adaptive LM cli.train: {out['trainer'].step} steps, "
                             f"{out['train_log']}")
    res = {"train_s": time.perf_counter() - t0, "train_log": out["train_log"],
           "valid": out["history"][-1],
           "lr": [float(out["trainer"].schedule(s)) for s in (0, 1, 2)]}
    log(f"[adaptive lm cli] {json.dumps(res)}")
    return res


def phase_adaptive_lm(root: Path):
    """Phase 43: egs/wikitext103/lm/adaptive_lm.yaml (transformer_lm_wiki103: 16 x 1024,
    adaptive input and softmax at 20000 / 60000 over 267,744 words): fp32 card vs CPU at
    full width cut to REF_LAYERS layers (the CPU reference), bf16 steps at 8 blocks
    of 512 at full depth under the recipe's ``cosine``, cli.train.  The causal LM runs no
    kernel, in JAX neither."""
    from s2t_tpu_torch.models.transformer_lm import TransformerLM
    from s2t_tpu_torch.tasks.language_modeling import lm_forward

    crit = (ADAPTIVE_LM_RECIPE["criterion"], {})
    opt = recipe_opt(ADAPTIVE_LM_RECIPE)
    rng = np.random.default_rng(43)
    parity, _ = phase_train_parity(
        zoo_model_cfg(ADAPTIVE_LM_RECIPE, vocab=WIKI103_V, decoder_layers=REF_LAYERS,
                      **NO_DROPOUT),
        TransformerLM, "adaptive lm train", criterion=crit, per_step=NO_KERNEL,
        batches=[lm_batch(rng, **LM_PARITY) for _ in range(2)], forward_fn=lm_forward, opt=opt)
    speed, _ = phase_train_speed(
        zoo_model_cfg(ADAPTIVE_LM_RECIPE, dtype="bfloat16", vocab=WIKI103_V), TransformerLM,
        "adaptive lm train speed", n_timed=ZOO_TIMED, criterion=crit, per_step=NO_KERNEL,
        batch=lm_batch(np.random.default_rng(0), **LM_BENCH), forward_fn=lm_forward, opt=opt)
    speed["tokens_per_s"] = speed["steps_per_s"] * LM_BENCH["B"] * LM_BENCH["L"]
    cli = lm_cli(root)
    return {"parity": parity, "speed": speed, "cli": cli}, {k: 0 for k in counters()}


def phase_align(root: Path):
    """Phase 44: egs/wmt16/align/transformer_align.yaml (transformer_align: post-norm 512
    / 2048, 6 + 6 layers, the alignment on layer 4's first head): 2 fp32 steps card vs
    CPU with seeded alignments (alignment_loss held beside the loss), bf16 steps at phase
    37's shape, cli.train with load_alignments -> cli.generate; the text encoder runs K1f
    / K1b (6 a pass), the decoder's attentions are dense."""
    from s2t_tpu_torch.models.transformer import text_forward
    from s2t_tpu_torch.models.transformer_align import TransformerAlignModel

    crit = (ALIGN_RECIPE["criterion"], ALIGN_RECIPE["criterion_cfg"])
    per_step = {"attention_fwd": MT_LAYERS, "attention_bwd": MT_LAYERS}
    opt = recipe_opt(ALIGN_RECIPE)
    rng = np.random.default_rng(44)
    parity, parity_launches = phase_train_parity(
        zoo_model_cfg(ALIGN_RECIPE, **NO_DROPOUT), TransformerAlignModel, "align train",
        criterion=crit, per_step=per_step, log_keys=("alignment_loss",),
        batches=[align_pairs(text_batch(rng, **MT_PARITY), rng) for _ in range(2)],
        forward_fn=text_forward, opt=recipe_opt(ALIGN_RECIPE, warmup_updates=PARITY_WARMUP))
    speed, speed_launches = phase_train_speed(
        zoo_model_cfg(ALIGN_RECIPE, dtype="bfloat16"), TransformerAlignModel, "align train speed",
        n_timed=ZOO_TIMED, criterion=crit, per_step=per_step,
        batch=align_pairs(text_batch(np.random.default_rng(0), **MT_BENCH),
                          np.random.default_rng(1)), forward_fn=text_forward, opt=opt)
    speed["tokens_per_s"] = speed["steps_per_s"] * MT_BENCH["B"] * MT_BENCH["U"]
    cli, cli_launches = zoo_cli(root, "align", ALIGN_RECIPE, MT_LAYERS, align=True)
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] + cli_launches[k]
                for k in counters()}
    return {"parity": parity, "speed": speed, "cli": cli}, launches


def nat_heads(model, feats):
    """The logits every argmax of a refinement round reads from decoder features."""
    from s2t_tpu_torch.models.insertion_transformer import InsertionTransformerModel
    from s2t_tpu_torch.models.levenshtein_transformer import LevenshteinTransformerModel

    if isinstance(model, InsertionTransformerModel):
        return {"slot": model.slot_head(feats)}
    heads = {"word": model.decoder._output(feats)}
    if isinstance(model, LevenshteinTransformerModel):
        heads.update(delete=model.del_head(feats), insert=model._ins_logits(feats))
    return heads


def argmax_gaps(card, host):
    """(largest |card - CPU|, argmax positions that differ, the CPU's largest logit gap
    between the two picks), computed on the card."""
    card, host = card.float(), host.float().to(card.device)
    a, b = card.argmax(-1), host.argmax(-1)
    diff = a != b
    gaps = (host.gather(-1, a[..., None]) - host.gather(-1, b[..., None])).abs()[..., 0][diff]
    return (card - host).abs().max().item(), int(diff.sum()), \
        gaps.max().item() if gaps.numel() else 0.0


def is_prefix(valid: torch.Tensor) -> torch.Tensor:
    """(B,) whether each row of a (B, T) mask is a True prefix."""
    pos = torch.arange(valid.shape[1], device=valid.device)[None, :]
    return (valid == (pos < valid.sum(dim=1, keepdim=True))).all(dim=1)


def most_filled(tokens) -> int:
    """The token other than pad that a decode's fills pick most often."""
    t = np.asarray(tokens).ravel()
    return int(np.bincount(t[t != 1]).argmax())


def plant_pad(model, tok: int):
    """Set the pad row of the decoder's (tied) embedding to PAD_PLANT x token ``tok``'s:
    an argmax fill then picks pad where it would pick ``tok``, leaving pad inside a
    canvas, which the kernel reads as lengths (the decoder puts the keys valid-first)."""
    w = model.decoder.embed_tokens.weight
    with torch.no_grad():
        w[1] = PAD_PLANT * w[tok]


def nat_decode_card_vs_cpu(name, task, cfg32, model_cls, plant=None, layers=NAT_LAYERS):
    """fp32 seeded weights on both devices (``plant``: with ``plant_pad`` of that token):
    the task's refinement decode of NAT_SENTENCES sentences on the card, its K1f
    launches counted per decoder pass, and the passes whose canvas holds pad between
    tokens (at least one when planted); then every decoder pass of the card's decode is
    replayed on the CPU from the card's canvas and each argmax it decides (words,
    deletions, insertions, slots; the predicted length) must agree or be a near-tie
    (the CPU's two logits within 2 x the largest card error).  The replay checks every
    decision of the decode, so the CPU does not decode on its own."""
    batch = text_batch(np.random.default_rng(45), NAT_SENTENCES, 48, 4)
    src = {"src_tokens": batch["src_tokens"], "src_lengths": batch["src_lengths"]}
    models = seeded_pair(lambda d: model_cls(cfg32, device=d, seed=0))
    if plant is not None:
        for m in models.values():
            plant_pad(m, plant)
    card_dec = models["cuda"].decoder
    passes = []

    def recorded(prev_tokens, encoder_out, encoder_valid_mask, *a, **kw):
        feats = type(card_dec).forward_features(card_dec, prev_tokens, encoder_out,
                                                encoder_valid_mask, *a, **kw)
        passes.append((prev_tokens.clone(), encoder_valid_mask.clone(), feats))
        return feats

    out = {}
    gen = task.build_generator(models["cuda"])
    card_dec.forward_features = recorded
    reset_counts()  # the main path: one encode and the rounds' decoder passes
    card_s = synced_s(lambda: out.__setitem__("cuda", gen.generate(src)))
    del card_dec.forward_features
    check_counts(read_counts(), {**{k: 0 for k in counters()},
                                 "attention_fwd": layers * (1 + len(passes))},
                 f"{name} refinement decode")
    host = models["cpu"]
    with torch.inference_mode():
        enc = {d: models[d].encode(torch.as_tensor(src["src_tokens"]).to(d),
                                   torch.as_tensor(src["src_lengths"]).to(d))
               for d in ("cuda", "cpu")}
        checks = []
        if hasattr(host, "predict_length"):
            checks.append(("length", *(models[d]._length_logits(
                enc[d]["encoder_out"], host.encoder_valid(enc[d])) for d in ("cuda", "cpu"))))
        host_valid = host.encoder_valid(enc["cpu"])
        for tokens, _, feats in passes:
            host_feats = host.decoder.forward_features(tokens.cpu(), enc["cpu"]["encoder_out"],
                                                       host_valid)
            card_heads, host_heads = nat_heads(models["cuda"], feats), nat_heads(host, host_feats)
            checks += [(k, card_heads[k], host_heads[k]) for k in card_heads]
        worst = {"max_abs_err": 0.0, "differing": 0, "largest_gap": 0.0, "decisions": 0}
        for head, card, cpu in checks:
            err, differing, gap = argmax_gaps(card, cpu)
            worst["decisions"] += card.shape[:-1].numel()
            worst["differing"] += differing
            worst["max_abs_err"] = max(worst["max_abs_err"], err)
            worst["largest_gap"] = max(worst["largest_gap"], gap)
            if differing and not gap <= 2 * err:
                raise AssertionError(f"{name}: a {head} argmax differs off a near-tie "
                                     f"(gap {gap:.3e}, card error {err:.3e})")
    inner = sum(int((~is_prefix(tokens != 1)).any()) for tokens, _, _ in passes)
    if plant is not None and not inner:
        raise AssertionError(f"{name}: planting pad ({plant}) left no pad inside a canvas")
    tok = out["cuda"][0][:, 0].cpu().numpy()
    res = {"sentences": NAT_SENTENCES, "decoder_passes": len(passes),
           "planted": plant, "passes_with_inner_pads": inner, "card_s": card_s,
           "argmax_replay": worst, "hyp_tokens_mean": float((tok != 1).sum(axis=1).mean())}
    tag = name if plant is None else f"{name} pad-fill"
    log(f"[{tag} decode] fp32 card vs CPU: {json.dumps(res)}")
    return res, layers * (1 + len(passes)), tok


def nat_roll_in_pad_fill(task, recipe, model_cls, crit, step, batch):
    """One fp32 Levenshtein step card vs CPU whose roll-in fill picks pad: the token its
    fill picks most often on the card (an evaluation forward on the step's draws) is
    planted (``plant_pad``) on both devices; the deletion pass of the card's step must
    read pad between tokens."""
    cfg = zoo_model_cfg(recipe, **NO_DROPOUT, **REF_DEPTH)
    forward = task.forward_fn()
    probe = model_cls(cfg, device="cuda", seed=0)

    def on_card(b):
        return {k: on_card(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v)).cuda()
                for k, v in b.items()}

    with torch.no_grad():
        out = forward(probe, on_card(batch), train=True,
                      generator=torch.Generator("cuda").manual_seed(0))
    tok = most_filled(out["word_ins_logits"].argmax(-1)[out["word_ins_mask"]].cpu())
    del probe, out
    inner = []

    def counted(model, b, *a, **kw):
        o = forward(model, b, *a, **kw)
        if o["del_mask"].is_cuda:
            inner.append(int((~is_prefix(o["del_mask"])).sum()))
        return o

    parity, launches = phase_train_parity(
        cfg, model_cls, "levenshtein pad-fill train", criterion=crit, per_step=step,
        batches=[batch], forward_fn=counted,
        opt=recipe_opt(recipe, warmup_updates=PARITY_WARMUP),
        prepare=lambda m: plant_pad(m, tok))
    if not sum(inner):
        raise AssertionError(f"levenshtein roll-in: planting pad ({tok}) left no pad inside "
                             f"the deletion pass's canvas")
    return {**parity, "planted": tok, "rows_with_inner_pads": inner}, launches


def phase_nat(root: Path):
    """Phase 45: egs/wmt16/nat/{cmlm,levenshtein,insertion,nacrf}.yaml at preset width
    (post-norm 512 / 2048, 6 + 6 layers, 8 heads, dictionaries of 10,000) through the
    translation_lev task's forward adapter: fp32 steps card vs CPU on handed-over noise
    (2 for CMLM, 1 for the others), each recipe's refinement decode card vs CPU
    (``nat_decode_card_vs_cpu``), and bf16 CMLM steps at phase 37's shape.  The encoder
    and the non-causal decoder run K1f / K1b: 12 / 12 a CMLM, NACRF or insertion step,
    24 / 24 a Levenshtein step (its three decoder passes)."""
    from s2t_tpu_torch.models import build  # noqa: F401  (registers every preset)
    from s2t_tpu_torch.registry import MODELS

    passes = {"cmlm": 2, "levenshtein": 4, "insertion": 2, "nacrf": 2}  # encoder + decoders
    res, launches = {}, {k: 0 for k in counters()}
    for name, recipe in NAT_RECIPES.items():
        task = recipe_task(root / "nat", recipe)
        model_cls = MODELS.get(ARCHS.get(recipe["arch"])[0])
        crit = (recipe["criterion"], recipe.get("criterion_cfg", {}))
        # the fp32 references at REF_LAYERS a side, the bf16 steps at the preset's depth
        step = {k: passes[name] * REF_LAYERS for k in ("attention_fwd", "attention_bwd")}
        full_step = {k: passes[name] * NAT_LAYERS for k in ("attention_fwd", "attention_bwd")}
        rng = np.random.default_rng(45)
        batches = []
        for _ in range(2):
            b = text_batch(rng, **MT_PARITY)
            batches.append({**b, "draws": nat_draws(rng, name, b)})
        parity, parity_launches = phase_train_parity(
            zoo_model_cfg(recipe, **NO_DROPOUT, **REF_DEPTH), model_cls, f"{name} train",
            criterion=crit, per_step=step, batches=batches, forward_fn=task.forward_fn(),
            opt=recipe_opt(recipe, warmup_updates=PARITY_WARMUP))
        decode, decode_launches, card_tokens = nat_decode_card_vs_cpu(
            name, task, zoo_model_cfg(recipe, **REF_DEPTH), model_cls, layers=REF_LAYERS)
        res[name] = {"parity": parity, "decode": decode}
        for k in counters():
            launches[k] += parity_launches.get(k, 0)
        launches["attention_fwd"] += decode_launches
        if name in ("cmlm", "levenshtein"):  # a fill that picks pad, on the card
            res[name]["pad_fill_decode"], decode_launches, _ = nat_decode_card_vs_cpu(
                name, task, zoo_model_cfg(recipe, **REF_DEPTH), model_cls,
                plant=most_filled(card_tokens), layers=REF_LAYERS)
            launches["attention_fwd"] += decode_launches
        if name == "levenshtein":
            res[name]["pad_fill_roll_in"], roll_in_launches = nat_roll_in_pad_fill(
                task, recipe, model_cls, crit, step, batches[0])
            for k in counters():
                launches[k] += roll_in_launches.get(k, 0)
        if name == "cmlm":
            speed, speed_launches = phase_train_speed(
                zoo_model_cfg(recipe, dtype="bfloat16"), model_cls, "cmlm train speed",
                n_timed=ZOO_TIMED, criterion=crit, per_step=full_step,
                batch=text_batch(np.random.default_rng(0), **MT_BENCH),
                forward_fn=task.forward_fn(), opt=recipe_opt(recipe))
            speed["tokens_per_s"] = speed["steps_per_s"] * MT_BENCH["B"] * MT_BENCH["U"]
            res[name]["speed"] = speed
            for k in counters():
                launches[k] += speed_launches[k]
    return res, launches


# --------------------------------------------------------------------------- #
# phases 46-48: BART / mBART, the LSTM and conv models (ROADMAP item 11 step 5)
BART_RECIPE = {  # egs/cnn_dm/bart/denoising_pretrain.yaml
    "task": "denoising", "arch": "bart_base", "criterion": "label_smoothed_cross_entropy",
    "criterion_cfg": {"label_smoothing": 0.1},
    "task_cfg": {"mask_ratio": 0.3, "poisson_lambda": 3.5, "permute_sentence_ratio": 1.0},
    "optimization": {"lr": 0.0004, "lr_scheduler": "polynomial", "warmup_updates": 10000,
                     "max_update": 500000},
    "dataset": {"max_tokens": 8192}}
MBART_RECIPE = {  # egs/cnn_dm/bart/mbart_ft_mt.yaml
    "task": "translation_from_pretrained_bart", "arch": "mbart_large",
    "criterion": "label_smoothed_cross_entropy", "criterion_cfg": {"label_smoothing": 0.2},
    "task_cfg": {"langs": "en,de,fr"}, "checkpoint": {"finetune_from_model": "mbart/model.pt"},
    "optimization": {"lr": 0.00003, "warmup_updates": 2500, "max_update": 40000}}
# the recipe's ``polynomial`` is no scheduler of either package (JAX raises KeyError at
# build_lr_schedule); the phase runs its settings under polynomial_decay (a logged cut)
BART_SCHEDULER = "polynomial_decay"
BART_WORDS = 50260  # the size of fairseq's bart.base dictionary: with the 4 specials and
V_BART = BART_WORDS + 4 + 1  # <mask>, the denoising task's table
MBART_WORDS = 250000  # mBART's own table's scale: with the specials, <mask> and the 3 tags
V_MBART = MBART_WORDS + 4 + 1 + 3
MBART_SMALL_V = MT_V  # the checkpoint and the fp32 parity's 10,000-word table
BART_LAYERS, MBART_LAYERS = 6, 12  # each side's; K1f / K1b each an encoder layer
BART_SENTENCES = 16  # beam-5 card-vs-CPU lines (20 tokens: GEN_SHORT)
RNN_CONV_ARCHS = ("lstm_wiseman_iwslt_de_en", "lightconv_iwslt_de_en", "dynamicconv_iwslt_de_en")
RNN_CONV_TIMED = 2
NEW_PHASES = ("phase_parallel", "phase_item16")  # the last slice's, timed apart
BART_CORPUS = {"train": 32, "dev": 8, "test": 8}  # lines of the denoising CLIs' splits


def bart_batch(rng, B, S, V, noise=None):
    """B seeded lines of S - 1 word ids (a full stop every ~8) and EOS as targets; the
    sources are their BART noise (the recipe's knobs; ``noise`` replaces them), collated
    as the denoising task collates (prev tokens: the target shifted right, EOS first)."""
    from s2t_tpu_torch.data.denoising_dataset import bart_noise
    from s2t_tpu_torch.data.text_dataset import TranslationDataset

    stop, mask = 4, V - 1  # the dictionary's first word is ".", <mask> is its last symbol
    samples = []
    for i in range(B):
        clean = rng.integers(5, V - 1, size=S).astype(np.int32)
        clean[rng.random(S) < 0.125] = stop
        clean[-1] = 2
        src = bart_noise(clean, rng, mask, V, full_stop_id=stop,
                         **(noise or BART_RECIPE["task_cfg"]))
        samples.append({"id": i, "source": src, "target": clean})
    batch = TranslationDataset.collater(None, samples)
    return {k: v for k, v in batch.items() if k not in ("ids", "nsentences")}


def bart_opt(recipe, **kw):
    o = {**recipe["optimization"], **kw}
    if o.get("lr_scheduler") == "polynomial":
        o["lr_scheduler"] = BART_SCHEDULER
    return OptimizationConfig(**o)


def bart_cfg(preset, vocab, dtype="float32", layers=0, **kw):
    from s2t_tpu_torch.models import bart  # noqa: F401  (registers the presets)

    depth = {"encoder_layers": layers, "decoder_layers": layers} if layers else {}
    return ARCHS.get(preset)[1](vocab_size=vocab, dtype_str=dtype, max_source_positions=1024,
                                max_target_positions=1024, **depth, **kw)


def bart_head_card_vs_cpu(vocab):
    """The classification head (3 classes) of bart_base at REF_LAYERS a side, fp32,
    seeded: the logits of 16 noised lines card vs CPU (one encode: K1f a layer)."""
    from s2t_tpu_torch.models.bart import BARTModel

    batch = bart_batch(np.random.default_rng(461), BART_SENTENCES, 48, vocab)
    cfg = bart_cfg("bart_base", vocab, layers=REF_LAYERS, num_classes=3, dropout=0.0)
    out = {}
    models = seeded_pair(lambda d: BARTModel(cfg, device=d, seed=0))
    for device in ("cuda", "cpu"):
        model = models[device]
        reset_counts()  # the main path: one encode and the decoder over the sources
        with torch.inference_mode():
            out[device] = model.classify(torch.as_tensor(batch["src_tokens"]).to(device),
                                         torch.as_tensor(batch["src_lengths"]).to(device)).cpu()
        if device == "cuda":
            check_counts(read_counts(), {**{k: 0 for k in counters()},
                                         "attention_fwd": REF_LAYERS}, "bart classify")
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    tol = FORWARD_RTOL * max(1.0, out["cpu"].abs().max().item())
    res = {"logits_shape": list(out["cpu"].shape), "max_abs_err": err, "tol": tol,
           "argmax_equal": bool(torch.equal(out["cuda"].argmax(-1), out["cpu"].argmax(-1)))}
    log(f"[bart head] fp32 classify card vs CPU: {json.dumps(res)}")
    if not err <= tol:
        raise AssertionError(f"bart classification logits differ by {err:.3e} > {tol:.3e}")
    return res


def write_denoising_corpus(root: Path, langs=(None,), seed=46):
    """Seeded lines over a dictionary of BART_WORDS words ("." first) for the denoising
    CLIs; per language in ``root/<lang>`` where ``langs`` names them."""
    rng = np.random.default_rng(seed)
    words = ["."] + [f"w{i}" for i in range(BART_WORDS - 1)]
    root.mkdir(parents=True, exist_ok=True)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    for lang in langs:
        d = root if lang is None else root / lang
        d.mkdir(exist_ok=True)
        for split, n in BART_CORPUS.items():
            lines = []
            for _ in range(n):
                toks = list(rng.choice(words[1:3000], size=int(rng.integers(12, 48))))
                for i in range(7, len(toks), 8):
                    toks[i] = "."
                lines.append(" ".join(toks))
            (d / f"{split}.txt").write_text("\n".join(lines) + "\n")


def bart_cli(root: Path, task: str, langs=(None,), updates=2):
    """cli.train ``updates`` updates of the denoising recipe (``task``: denoising or
    multilingual_denoising) at REF_LAYERS a side, then cli.generate (beam 5, 20
    tokens) of its test split; every loss and gradient norm finite."""
    data = root / f"{task}_data"
    write_denoising_corpus(data, langs)
    save = root / f"{task}_ckpt"
    d = {k: (dict(v) if isinstance(v, dict) else v) for k, v in BART_RECIPE.items()}
    d["task"] = task
    d["optimization"] = {**d["optimization"], "lr_scheduler": BART_SCHEDULER,
                         "max_update": updates}
    d["model"] = {"encoder_layers": REF_LAYERS, "decoder_layers": REF_LAYERS}
    if task == "multilingual_denoising":
        d["task_cfg"] = {**d["task_cfg"], "langs": ",".join(langs)}
    d.update(dataset={**d["dataset"], "data": str(data), "max_source_positions": 1024,
                      "max_target_positions": 1024, "valid_subset": "dev",
                      "gen_subset": "test"},
             common={"log_interval": 1},
             checkpoint={"save_dir": str(save), "no_save": True, "best_checkpoint_metric": "loss"},
             eval={"eval_bleu": False},
             generation={"beam": 5, "max_len_b": 20, "scoring": "wer",
                         "results_path": str(save / "gen")})
    n_test = BART_CORPUS["test"] * len(langs)
    out, gen, counts, train_s, gen_s = text_cli(d, task, REF_LAYERS, n_test, updates)
    res = {"train_s": train_s, "generate_s": gen_s, "train_log": out["train_log"],
           "valid": out["history"][-1], "score": gen["score_str"],
           "dictionary": len(out["task"].dictionary)}
    log(f"[{task} cli] {json.dumps(res)}")
    if not all(math.isfinite(r[k]) for r in out["train_log"] for k in ("loss", "gnorm")) \
            or not math.isfinite(res["valid"]["loss"]):
        raise AssertionError(f"{task} cli.train: a loss or gradient norm is not finite")
    return res, counts


def add_counts(*runs):
    return {k: sum(r.get(k, 0) for r in runs) for k in counters()}


def phase_bart(root: Path):
    """Phase 46: egs/cnn_dm/bart/denoising_pretrain.yaml (bart_base: 768 / 3072, 6 + 6
    post-norm layers, 12 heads, GELU, learned positions, one table of V_BART) on
    ``bart_noise``d seeded lines under the recipe's settings but its scheduler
    (polynomial_decay): 2 fp32 steps card vs CPU at REF_LAYERS a side, 3 timed bf16
    steps at the recipe's max_tokens 8192 (128 x 64) with K1f / K1b 6 / 6 a step,
    cli.train on denoising (2 updates) and multilingual_denoising over 2 languages (1) at
    REF_LAYERS, beam-5 tokens of BART_SENTENCES noised lines card vs CPU at full
    depth, the classification head's logits card vs CPU."""
    from s2t_tpu_torch.models.bart import BARTModel
    from s2t_tpu_torch.models.transformer import text_forward

    log(f"[bart] cut: the recipe's lr_scheduler 'polynomial' (no scheduler of JAX or the port) "
        f"runs as {BART_SCHEDULER!r}")
    crit = (BART_RECIPE["criterion"], BART_RECIPE["criterion_cfg"])
    opt = bart_opt(BART_RECIPE)
    rng = np.random.default_rng(46)
    parity, parity_launches = phase_train_parity(
        bart_cfg("bart_base", V_BART, layers=REF_LAYERS, **NO_DROPOUT), BARTModel,
        "bart train", criterion=crit,
        per_step={"attention_fwd": REF_LAYERS, "attention_bwd": REF_LAYERS},
        batches=[bart_batch(rng, **MT_PARITY_TEXT, V=V_BART) for _ in range(2)],
        forward_fn=text_forward, opt=opt)
    speed, speed_launches = phase_train_speed(
        bart_cfg("bart_base", V_BART, "bfloat16"), BARTModel, "bart train speed",
        n_timed=BART_TIMED, criterion=crit,
        per_step={"attention_fwd": BART_LAYERS, "attention_bwd": BART_LAYERS},
        batch=bart_batch(np.random.default_rng(0), MT_BENCH["B"], MT_BENCH["U"], V_BART),
        forward_fn=text_forward, opt=opt)
    speed["tokens_per_s"] = speed["steps_per_s"] * MT_BENCH["B"] * MT_BENCH["U"]
    cli, cli_launches = bart_cli(root, "denoising")
    ml_cli, ml_launches = bart_cli(root, "multilingual_denoising", ("de", "en"), updates=1)
    beam = mt_beam_card_vs_cpu(bart_cfg("bart_base", V_BART), BARTModel, BART_LAYERS,
                               "bart beam", bart_batch(np.random.default_rng(462),
                                                       BART_SENTENCES, 48, V_BART))
    head = bart_head_card_vs_cpu(V_BART)
    launches = add_counts(parity_launches, speed_launches, cli_launches, ml_launches)
    launches["attention_fwd"] += BART_LAYERS + REF_LAYERS  # the beam's and head's encodes
    return {"parity": parity, "speed": speed, "cli": cli, "multilingual_cli": ml_cli,
            "beam": beam, "head": head, "vocab": V_BART,
            "cut": f"lr_scheduler polynomial -> {BART_SCHEDULER}"}, launches


def mbart_cli(root: Path):
    """A seeded mbart_large checkpoint at REF_LAYERS a side over MBART_SMALL_V, then
    cli.train 2 updates of mbart_ft_mt.yaml's translation_from_pretrained_bart from it
    (``finetune_from_model``) on a seeded corpus and cli.generate of its test split."""
    from s2t_tpu_torch.models.bart import BARTModel
    from s2t_tpu_torch.utils.checkpoint import save_tree

    data = root / "mbart_data"
    data.mkdir()
    words = [f"w{i}" for i in range(MBART_SMALL_V - 8)]  # + 4 specials, <mask>, 3 tags
    write_text_corpus(data, ZOO_CORPUS)
    (data / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    ckpt = root / "mbart_model.pt"
    model = BARTModel(bart_cfg("mbart_large", MBART_SMALL_V, layers=REF_LAYERS),
                      device="cuda", seed=3, for_training=True)
    save_tree(ckpt, {"params": model.state_dict()})
    save = root / "mbart_ckpt"
    d = {k: (dict(v) if isinstance(v, dict) else v) for k, v in MBART_RECIPE.items()}
    d["optimization"] = {**d["optimization"], "max_update": 2}
    d["model"] = {"encoder_layers": REF_LAYERS, "decoder_layers": REF_LAYERS}
    d.update(dataset={"data": str(data), "max_tokens": 4096, "max_source_positions": 1024,
                      "max_target_positions": 1024, "valid_subset": "dev",
                      "gen_subset": "test"},
             common={"log_interval": 1},
             checkpoint={"save_dir": str(save), "no_save": True, "best_checkpoint_metric": "loss",
                         "finetune_from_model": str(ckpt)},
             eval={"eval_bleu": False},
             generation={"beam": 5, "max_len_b": 20, "scoring": "wer",
                         "results_path": str(save / "gen")})
    out, gen, counts, train_s, gen_s = text_cli(d, "mbart", REF_LAYERS, ZOO_CORPUS["test"])
    tuned = out["model"].state_dict()
    moved = max((tuned[k].float().cpu() - v.float().cpu()).abs().max().item()
                for k, v in model.state_dict().items())
    res = {"train_s": train_s, "generate_s": gen_s, "train_log": out["train_log"],
           "valid": out["history"][-1], "score": gen["score_str"],
           "dictionary": len(out["task"].tgt_dict), "checkpoint_mb": ckpt.stat().st_size / 1e6,
           "max_weight_move_from_checkpoint": moved}
    log(f"[mbart cli] {json.dumps(res)}")
    # loaded, 2 updates at a warm-up lr of ~1e-8 move no weight by 1e-3; another seed's
    # weights differ by ~0.1
    if res["dictionary"] != MBART_SMALL_V or not moved < 1e-3 or \
            not all(math.isfinite(r[k]) for r in out["train_log"] for k in ("loss", "gnorm")):
        raise AssertionError(f"mbart fine-tuning: {res}")
    return res, counts


def phase_mbart(root: Path):
    """Phase 47: egs/cnn_dm/bart/mbart_ft_mt.yaml (mbart_large: 1024 / 4096, 12 + 12
    pre-norm layers, 16 heads, the embedding scaled): 3 timed bf16 steps at full depth
    over a table of V_MBART (128 x 64 / 64 tokens; K1f / K1b 12 / 12 a step, peak memory),
    2 fp32 steps card vs CPU and beam-5 tokens of BART_SENTENCES sentences card vs CPU at
    REF_LAYERS a side over MBART_SMALL_V, cli.train of translation_from_pretrained_bart
    from a seeded checkpoint of that size."""
    from s2t_tpu_torch.models.bart import BARTModel
    from s2t_tpu_torch.models.transformer import text_forward

    crit = (MBART_RECIPE["criterion"], MBART_RECIPE["criterion_cfg"])
    opt = bart_opt(MBART_RECIPE)
    speed, speed_launches = phase_train_speed(
        bart_cfg("mbart_large", V_MBART, "bfloat16"), BARTModel, "mbart train speed",
        n_timed=BART_TIMED, criterion=crit,
        per_step={"attention_fwd": MBART_LAYERS, "attention_bwd": MBART_LAYERS},
        batch=text_batch(np.random.default_rng(0), **MT_BENCH, V=V_MBART),
        forward_fn=text_forward, opt=opt)
    speed["tokens_per_s"] = speed["steps_per_s"] * MT_BENCH["B"] * MT_BENCH["U"]
    rng = np.random.default_rng(47)
    parity, parity_launches = phase_train_parity(
        bart_cfg("mbart_large", MBART_SMALL_V, layers=REF_LAYERS, **NO_DROPOUT),
        BARTModel, "mbart train", criterion=crit,
        per_step={"attention_fwd": REF_LAYERS, "attention_bwd": REF_LAYERS},
        batches=[text_batch(rng, **MT_PARITY, V=MBART_SMALL_V) for _ in range(2)],
        forward_fn=text_forward, opt=bart_opt(MBART_RECIPE, warmup_updates=PARITY_WARMUP))
    cli, cli_launches = mbart_cli(root)
    beam = mt_beam_card_vs_cpu(
        bart_cfg("mbart_large", MBART_SMALL_V, layers=REF_LAYERS), BARTModel,
        REF_LAYERS, "mbart beam",
        text_batch(np.random.default_rng(472), BART_SENTENCES, 48, 4, V=MBART_SMALL_V))
    launches = add_counts(speed_launches, parity_launches, cli_launches)
    launches["attention_fwd"] += REF_LAYERS  # the beam's encode
    return {"speed": speed, "parity": parity, "cli": cli, "beam": beam,
            "vocab": V_MBART}, launches


def phase_rnn_conv():
    """Phase 48: lstm_wiseman_iwslt_de_en (under ``cross_entropy``), lstm_lm,
    lightconv_iwslt_de_en and dynamicconv_iwslt_de_en at their presets' widths and depths
    on phase 37's dictionaries and shapes: 2 fp32 steps card vs CPU each, 2 timed bf16
    steps each, beam-5 tokens of BART_SENTENCES sentences card vs CPU for the three
    encoder-decoders.  No kernel runs: the recurrences and convolutions are outside Pallas
    in JAX too, and the conv decoders' cross-attention attends densely."""
    from s2t_tpu_torch.models import build  # noqa: F401  (registers every preset)
    from s2t_tpu_torch.models.transformer import text_forward
    from s2t_tpu_torch.registry import MODELS
    from s2t_tpu_torch.tasks.language_modeling import lm_forward

    out = {}
    for i, arch in enumerate((*RNN_CONV_ARCHS, "lstm_lm")):
        model_name, preset = ARCHS.get(arch)
        model_cls = MODELS.get(model_name)
        lm = arch == "lstm_lm"
        ctx = {"vocab_size": MT_V} if lm else {"vocab_size": MT_V, "src_vocab_size": MT_V}
        crit = ("cross_entropy", {}) if arch.startswith("lstm_w") else (
            "label_smoothed_cross_entropy", {"label_smoothing": 0.1})
        rng = np.random.default_rng(48 + i)
        if lm:
            batches = [lm_batch(rng, MT_PARITY["B"], MT_PARITY["U"], MT_V) for _ in range(2)]
            bench = lm_batch(np.random.default_rng(0), MT_BENCH["B"], MT_BENCH["U"], MT_V)
        else:
            batches = [text_batch(rng, **MT_PARITY) for _ in range(2)]
            bench = text_batch(np.random.default_rng(0), **MT_BENCH)
        fwd = lm_forward if lm else text_forward
        parity, _ = phase_train_parity(
            preset(**ctx, dropout=0.0, **({} if arch.startswith("lstm") else
                                           {"attention_dropout": 0.0, "weight_dropout": 0.0})),
            model_cls, f"{arch} train", criterion=crit, per_step=NO_KERNEL, batches=batches,
            forward_fn=fwd)
        speed, _ = phase_train_speed(
            preset(**ctx, dtype_str="bfloat16"), model_cls, f"{arch} train speed",
            n_timed=RNN_CONV_TIMED, criterion=crit, per_step=NO_KERNEL, batch=bench,
            forward_fn=fwd, opt=mt_opt())
        speed["tokens_per_s"] = speed["steps_per_s"] * MT_BENCH["B"] * MT_BENCH["U"]
        out[arch] = {"parity": parity, "speed": speed}
        if not lm:
            out[arch]["beam"] = mt_beam_card_vs_cpu(
                preset(**ctx), model_cls, 0, f"{arch} beam",
                text_batch(np.random.default_rng(480 + i), BART_SENTENCES, 48, 4))
    return out, {k: 0 for k in counters()}


# --------------------------------------------------------------------------- #
# phases 49-51: the multilingual Transformer, RoBERTa / BERT and their tasks, GPT-2
ML_RECIPE = {  # fairseq examples/translation/README.md, "Multilingual Translation" (IWSLT'17)
    "task": "multilingual_translation", "arch": "multilingual_transformer_iwslt_de_en",
    "task_cfg": {"lang_pairs": ["de-en", "fr-en"]},
    "model": {"share_decoders": True, "share_decoder_input_output_embed": True, "dropout": 0.3},
    "criterion": "label_smoothed_cross_entropy", "criterion_cfg": {"label_smoothing": 0.1},
    "optimization": {"optimizer": "adam", "adam_betas": [0.9, 0.98], "lr": 0.0005,
                     "lr_scheduler": "inverse_sqrt", "warmup_updates": 4000},
    "dataset": {"max_tokens": 4000}}
ML_PAIRS = ("de-en", "fr-en")
ML_EVAL_PAIR = "de-en"
ML_V = 16000  # the seeded joint dictionary's entries, specials and <lang:en> included
ML_LAYERS = 6  # each encoder's: K1f / K1b once a layer a pair, 12 / 12 a step
ML_CORPUS = {"train": 160, "dev": 8, "test": 8}  # lines a pair
ML_SENTENCES = 8  # beam-5 card-vs-CPU sentences through pair_view (20 tokens: GEN_SHORT)
ROBERTA_RECIPE = {  # fairseq examples/roberta/README.pretraining.md
    "task": "masked_lm", "arch": "roberta_base", "criterion": "masked_lm",
    "optimization": {"optimizer": "adam", "adam_betas": [0.9, 0.98], "adam_eps": 1e-6,
                     "clip_norm": 0.0, "lr_scheduler": "polynomial_decay", "lr": 0.0005,
                     "warmup_updates": 10000, "max_update": 125000, "weight_decay": 0.01},
    "dataset": {"max_target_positions": 512, "batch_size": 16}}  # tokens per sample, sentences
ROBERTA_BENCH = dict(B=16, L=512)
ROBERTA_PARITY = dict(B=4, L=64)
ROBERTA_LAYERS = 12
HEAD_WORDS = 996  # the sentence-task CLIs' small dictionaries: 1000 entries with the specials
HEAD_CORPUS = {"train": 24, "dev": 8}
GPT2_V = 50257
GPT2_BENCH = dict(B=8, L=1024)
GPT2_PROMPTS = dict(B=4, L=8)  # greedy card-vs-CPU prompts, GPT2_NEW tokens each
GPT2_NEW = 24
GPT2_CRIT = ("cross_entropy", {"label_smoothing": 0.0})  # fairseq's LM criterion
GPT2_NO_DROPOUT = {"dropout": 0.0, "attention_dropout": 0.0}
MODEL_TIMED = 2  # timed bf16 steps of phases 49-51


def ml_cfg(dtype="float32", layers=0, **kw):
    from s2t_tpu_torch.models.multilingual_transformer import multilingual_transformer_iwslt

    depth = {"encoder_layers": layers, "decoder_layers": layers} if layers else {}
    return multilingual_transformer_iwslt(
        **{**ML_RECIPE["model"], **depth, **kw}, lang_pairs=ML_PAIRS, vocab_size=ML_V,
        src_vocab_size=ML_V, dtype_str=dtype, max_source_positions=1024,
        max_target_positions=1024)


def ml_criterion():
    from s2t_tpu_torch.criterions.multilingual import MultilingualCriterion

    return MultilingualCriterion(build_criterion(ML_RECIPE["criterion"],
                                                 ML_RECIPE["criterion_cfg"]))


def zip_batch(rng, B, S, U):
    """A round-robin batch: ``text_batch`` a pair over ML_V."""
    pairs = {p: text_batch(rng, B, S, U, ML_V) for p in ML_PAIRS}
    return {"pairs": pairs, "ntokens": np.float32(sum(b["ntokens"] for b in pairs.values()))}


def write_ml_corpus(root: Path, seed=49):
    """Each pair's splits over one seeded dictionary of ML_V entries (its last word the
    shared regime's <lang:en>), sources of 5-40 words, IWSLT's spread."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(ML_V - 5)]
    root.mkdir(parents=True, exist_ok=True)
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words + ["<lang:en>"]))
    for split, n in ML_CORPUS.items():
        for pair in ML_PAIRS:
            for lang in pair.split("-"):
                lines = [" ".join(rng.choice(words[:4000], size=int(rng.integers(5, 41))))
                         for _ in range(n)]
                (root / f"{split}.{pair}.{lang}").write_text("\n".join(lines) + "\n")


def ml_cfg_dict(data: Path, save: Path, task, arch, layers, updates):
    d = {k: (dict(v) if isinstance(v, dict) else v) for k, v in ML_RECIPE.items()}
    d.update(task=task, arch=arch, model={**d["model"], "encoder_layers": layers,
                                          "decoder_layers": layers},
             task_cfg={**d["task_cfg"], "eval_lang_pair": ML_EVAL_PAIR},
             optimization={**d["optimization"], "max_update": updates},
             dataset={**d["dataset"], "data": str(data), "max_source_positions": 1024,
                      "max_target_positions": 1024, "valid_subset": "dev", "gen_subset": "test"},
             common={"log_interval": 1},
             checkpoint={"save_dir": str(save), "no_save": True, "best_checkpoint_metric": "loss"},
             eval={"eval_bleu": False},
             generation={"beam": 5, "max_len_b": 20, "scoring": "wer",
                         "results_path": str(save / "gen")})
    if arch != ML_RECIPE["arch"]:  # one shared model: no per-language modules to share
        d["model"] = {k: v for k, v in d["model"].items() if k != "share_decoders"}
    return d


def ml_cli(data: Path, root: Path):
    """cli.train 2 updates of the recipe at REF_LAYERS a side (each update both pairs:
    K1f / K1b 2 REF_LAYERS), validation on the zipped dev split, cli.generate (beam 5,
    20 tokens) of ML_EVAL_PAIR's test split through pair_view; then
    translation_multi_simple_epoch over transformer_iwslt_de_en (one shared model, every
    target tagged <lang:en>) 1 update with validation."""
    from s2t_tpu_torch.cli import generate as cli_generate
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict

    cfg = from_dict(TrainConfig, ml_cfg_dict(data, root / "ml_ckpt", ML_RECIPE["task"],
                                             ML_RECIPE["arch"], REF_LAYERS, 2))
    reset_counts()  # the main path: cli.train (2 round-robin steps, validation), cli.generate
    t0 = time.perf_counter()
    out = cli_train.main(cfg, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen = cli_generate.main(cfg, out["model"].state_dict(), device="cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = read_counts()
    task, steps = out["task"], out["trainer"].step
    batches = lambda ds: len(task.get_batch_iterator(  # noqa: E731
        ds, max_tokens=cfg.dataset.max_tokens, shuffle=False))
    n_valid, n_test = batches(task.datasets["dev"]), batches(
        task.load_pair_dataset("test", ML_EVAL_PAIR))
    pairs = len(ML_PAIRS)
    check_counts(counts, {**{k: 0 for k in counters()},
                          "attention_fwd": REF_LAYERS * (pairs * steps + pairs * n_valid * len(
                              out["history"]) + n_test),
                          "attention_bwd": REF_LAYERS * pairs * steps},
                 "multilingual cli.train + cli.generate")
    if steps != 2 or gen["n_utts"] != ML_CORPUS["test"] or not all(
            math.isfinite(r[k]) for r in out["train_log"] for k in ("loss", "gnorm")):
        raise AssertionError(f"multilingual CLIs: {steps} steps, {gen['n_utts']} decoded, "
                             f"{out['train_log']}")
    valid = out["history"][-1]
    res = {"train_s": train_s, "generate_s": gen_s, "train_log": out["train_log"],
           "valid": valid, "score": gen["score_str"],
           "pair_logs": sorted(k for k in valid if ":" in k)}
    if not {f"{p}:nll_loss" for p in ML_PAIRS} <= set(valid):
        raise AssertionError(f"multilingual validation logs no pair: {sorted(valid)}")

    cfg = from_dict(TrainConfig, ml_cfg_dict(data, root / "ms_ckpt",
                                             "translation_multi_simple_epoch",
                                             "transformer_iwslt_de_en", REF_LAYERS, 1))
    reset_counts()  # the main path: the shared model's cli.train
    t0 = time.perf_counter()
    shared = cli_train.main(cfg, device="cuda")
    torch.cuda.synchronize()
    res["simple_epoch_train_s"] = time.perf_counter() - t0
    shared_counts = read_counts()
    stask, ssteps = shared["task"], shared["trainer"].step
    n_valid = len(stask.get_batch_iterator(stask.datasets["dev"],
                                           max_tokens=cfg.dataset.max_tokens, shuffle=False))
    check_counts(shared_counts, {**{k: 0 for k in counters()},
                                 "attention_fwd": REF_LAYERS * (ssteps + n_valid * len(
                                     shared["history"])),
                                 "attention_bwd": REF_LAYERS * ssteps},
                 "translation_multi_simple_epoch cli.train")
    tag = stask.tgt_dict.index("<lang:en>")
    train_ds = stask.datasets["train"]
    if ssteps != 1 or not all(train_ds[i]["target"][0] == tag for i in range(len(train_ds))):
        raise AssertionError(f"translation_multi_simple_epoch: {ssteps} steps, or a target "
                             "without its <lang:en> tag")
    res.update(simple_epoch_train_log=shared["train_log"],
               simple_epoch_valid=shared["history"][-1])
    log(f"[multilingual cli] {json.dumps(res)}")
    return res, add_counts(counts, shared_counts)


def phase_multilingual(root: Path):
    """Phase 49: fairseq's IWSLT'17 multilingual recipe (multilingual_transformer_iwslt_de_en:
    512 / 1024, 4 heads, 6 + 6 layers, a de and an fr encoder, one shared decoder with its
    input and output tied; label-smoothed CE 0.1, Adam (0.9, 0.98), lr 5e-4 inverse_sqrt
    over 4000 warm-up updates, dropout 0.3, max_tokens 4000) over a seeded joint dictionary
    of ML_V entries: 2 fp32 round-robin steps card vs CPU at REF_LAYERS a side, 2 timed
    bf16 steps on the first batch the task's batcher builds at max_tokens 4000 (both
    pairs: K1f / K1b 12 / 12 a step), the CLIs (``ml_cli``), beam-5 tokens of ML_SENTENCES
    sentences through pair_view card vs CPU at full depth."""
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.models.multilingual_transformer import MultilingualTransformerModel
    from s2t_tpu_torch.tasks import setup_task
    from s2t_tpu_torch.tasks.multilingual_translation import zip_forward

    opt = recipe_opt(ML_RECIPE)
    two = len(ML_PAIRS)
    rng = np.random.default_rng(49)
    parity, parity_launches = phase_train_parity(
        ml_cfg(layers=REF_LAYERS, **NO_DROPOUT), MultilingualTransformerModel,
        "multilingual train", criterion=ml_criterion(),
        per_step={"attention_fwd": two * REF_LAYERS, "attention_bwd": two * REF_LAYERS},
        batches=[zip_batch(rng, **MT_PARITY) for _ in range(2)], forward_fn=zip_forward,
        opt=recipe_opt(ML_RECIPE, warmup_updates=PARITY_WARMUP))
    data = root / "ml_data"
    write_ml_corpus(data)
    task = setup_task(from_dict(TrainConfig, {
        **{k: ML_RECIPE[k] for k in ("task", "arch", "task_cfg", "model")},
        "dataset": {"data": str(data), "max_tokens": ML_RECIPE["dataset"]["max_tokens"],
                    "max_source_positions": 1024, "max_target_positions": 1024}}))
    train_ds = task.load_dataset("train", is_train=True)
    batch = step_batch(next(iter(task.get_batch_iterator(
        train_ds, max_tokens=ML_RECIPE["dataset"]["max_tokens"], seed=1).next_epoch_itr())))
    shape = {p: list(b["src_tokens"].shape) for p, b in batch["pairs"].items()}
    src_tokens = {p: int(b["src_lengths"].sum()) for p, b in batch["pairs"].items()}
    speed, speed_launches = phase_train_speed(
        ml_cfg("bfloat16"), MultilingualTransformerModel, "multilingual train speed",
        n_timed=MODEL_TIMED, criterion=ml_criterion(),
        per_step={"attention_fwd": two * ML_LAYERS, "attention_bwd": two * ML_LAYERS},
        batch=batch, forward_fn=zip_forward, opt=opt)
    speed.update(batch_shapes=shape, source_tokens=src_tokens, target_tokens=float(
        batch["ntokens"]), tokens_per_s=speed["steps_per_s"] * float(batch["ntokens"]))
    cli, cli_launches = ml_cli(data, root)
    beam = mt_beam_card_vs_cpu(
        ml_cfg(), MultilingualTransformerModel, ML_LAYERS, "multilingual beam",
        text_batch(np.random.default_rng(491), ML_SENTENCES, 48, 4, V=ML_V),
        view=lambda m: m.pair_view(ML_EVAL_PAIR))
    launches = add_counts(parity_launches, speed_launches, cli_launches)
    launches["attention_fwd"] += ML_LAYERS  # the beam's one encode
    return {"parity": parity, "speed": speed, "cli": cli, "beam": beam, "vocab": ML_V}, launches


def write_head_corpora(root: Path, seed=50):
    """The sentence tasks' small corpora over one dictionary of HEAD_WORDS words: labelled
    sentences (3 labels), 4-candidate rankings, sentence pairs, two languages' text."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(HEAD_WORDS)]

    def sent():
        return " ".join(rng.choice(words, size=int(rng.integers(4, 30))))

    for name in ("cls", "rank", "pairs", "xlm"):
        (root / name).mkdir(parents=True)
        (root / name / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    (root / "cls" / "labels.txt").write_text("pos neg neutral\n")
    for split, n in HEAD_CORPUS.items():
        (root / "cls" / f"{split}.tsv").write_text("".join(
            f"{sent()}\t{rng.choice(['pos', 'neg', 'neutral'])}\n" for _ in range(n)))
        (root / "rank" / f"{split}.tsv").write_text("".join(
            "\t".join([sent() for _ in range(4)] + [str(rng.integers(0, 4))]) + "\n"
            for _ in range(n)))
        (root / "pairs" / f"{split}.txt").write_text("".join(f"{sent()}\n" for _ in range(n)))
        for lang in ("de", "fr"):
            (root / "xlm" / lang).mkdir(exist_ok=True)
            (root / "xlm" / lang / f"{split}.txt").write_text(
                "".join(f"{sent()}\n" for _ in range(3 * n)))


HEAD_CLIS = {  # task -> (data directory, arch, criterion, task_cfg)
    "sentence_prediction": ("cls", "roberta_base", "sentence_prediction", {}),
    "sentence_ranking": ("rank", "roberta_base", "sentence_ranking", {}),
    "legacy_masked_lm": ("pairs", "bert_base", "legacy_masked_lm", {}),
    "cross_lingual_lm": ("xlm", "roberta_base", "masked_lm", {"langs": "de,fr"}),
}


def head_clis(root: Path):
    """cli.train one update (with validation) of each of HEAD_CLIS at full width and
    REF_LAYERS layers: K1f REF_LAYERS a forward, K1b REF_LAYERS a step."""
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict

    write_head_corpora(root / "heads")
    out, counts = {}, {k: 0 for k in counters()}
    for task, (data, arch, crit, task_cfg) in HEAD_CLIS.items():
        cfg = from_dict(TrainConfig, {
            "task": task, "arch": arch, "criterion": crit, "task_cfg": task_cfg,
            "model": {"encoder_layers": REF_LAYERS},
            "optimization": {**ROBERTA_RECIPE["optimization"], "max_update": 1},
            "dataset": {"data": str(root / "heads" / data), "max_tokens": 4096,
                        "batch_size": 16, "max_target_positions": 128, "valid_subset": "dev"},
            "common": {"log_interval": 1},
            "checkpoint": {"save_dir": str(root / f"{task}_ckpt"), "no_save": True,
                           "best_checkpoint_metric": "loss"}})
        reset_counts()  # the main path: one update and the validation
        t0 = time.perf_counter()
        run = cli_train.main(cfg, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read_counts()
        t = run["task"]
        n_valid = len(t.get_batch_iterator(t.datasets["dev"], max_tokens=cfg.dataset.max_tokens,
                                           shuffle=False))
        steps = run["trainer"].step
        check_counts(got, {**{k: 0 for k in counters()},
                           "attention_fwd": REF_LAYERS * (steps + n_valid * len(run["history"])),
                           "attention_bwd": REF_LAYERS * steps}, f"{task} cli.train")
        valid = run["history"][-1]
        if steps != 1 or not all(math.isfinite(r[k]) for r in run["train_log"]
                                 for k in ("loss", "gnorm")) or not math.isfinite(valid["loss"]):
            raise AssertionError(f"{task} cli.train: {steps} steps, {run['train_log']}, {valid}")
        out[task] = {"train_s": secs, "train_log": run["train_log"], "valid": valid,
                     "dictionary": len(t.dictionary)}
        counts = add_counts(counts, got)
    if "nsp_loss" not in out["legacy_masked_lm"]["valid"]:
        raise AssertionError("legacy_masked_lm validated without its NSP term")
    log(f"[roberta heads cli] {json.dumps(out)}")
    return out, counts


def roberta_head_card_vs_cpu():
    """roberta_base's 2-class head at REF_LAYERS, fp32, seeded: the logits of 16 ragged
    rows card vs CPU (one encode: K1f REF_LAYERS)."""
    from s2t_tpu_torch.models.roberta import RobertaModel, roberta_base

    toks = text_batch(np.random.default_rng(501), 16, 64, 2, V=V_BART)["src_tokens"]
    cfg = roberta_base(vocab_size=V_BART, encoder_layers=REF_LAYERS, num_classes=2,
                       **NO_DROPOUT)
    out = {}
    models = seeded_pair(lambda d: RobertaModel(cfg, device=d, seed=0))
    for device in ("cuda", "cpu"):
        model = models[device]
        reset_counts()  # the main path: one encode
        with torch.inference_mode():
            out[device] = model(torch.as_tensor(toks).to(device),
                                classification=True)["cls_logits"].cpu()
        if device == "cuda":
            check_counts(read_counts(), {**{k: 0 for k in counters()},
                                         "attention_fwd": REF_LAYERS}, "roberta head")
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    tol = FORWARD_RTOL * max(1.0, out["cpu"].abs().max().item())
    res = {"logits_shape": list(out["cpu"].shape), "max_abs_err": err, "tol": tol,
           "argmax_equal": bool(torch.equal(out["cuda"].argmax(-1), out["cpu"].argmax(-1)))}
    log(f"[roberta head] fp32 card vs CPU: {json.dumps(res)}")
    if not err <= tol:
        raise AssertionError(f"roberta head logits differ by {err:.3e} > {tol:.3e}")
    return res


def mlm_batch(rng, B, L, draws=True):
    """Seeded blocks of L tokens over V_BART (no pad: MonolingualDataset's), their masking
    draws handed over where ``draws`` (the same on both devices)."""
    V = V_BART
    target = rng.integers(4, V - 1, size=(B, L)).astype(np.int64)
    batch = {"target": target, "ntokens": np.float32(B * L)}
    if draws:
        batch["draws"] = {"mask_uniforms": rng.random((B, L), dtype=np.float32),
                          "kind_uniforms": rng.random((B, L), dtype=np.float32),
                          "random_tokens": rng.integers(4, V, size=(B, L))}
    return batch


def phase_roberta(root: Path):
    """Phase 50: fairseq's RoBERTa pretraining recipe (README.pretraining.md: roberta_base,
    768 / 3072, 12 post-norm layers, 12 heads, GELU, over a table of 50,265 entries (the
    denoising corpus's dictionary and <mask>); masked_lm at 512 tokens a sample, 16
    samples; Adam (0.9, 0.98), eps 1e-6, lr 5e-4 polynomial_decay, weight decay 0.01;
    its update_freq 16 cut to one batch a step): 2 fp32 steps card vs CPU at REF_LAYERS on
    handed-over masks, 2 timed bf16 steps at 16 x 512 (K1f / K1b 12 / 12 a step, the last
    step profiled), the 2-class head's logits card vs CPU, one cli.train update each of
    sentence_prediction, sentence_ranking, legacy_masked_lm (bert_base: segments and the
    NSP head) and cross_lingual_lm over 2 languages (``head_clis``)."""
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.models.roberta import RobertaModel, roberta_base
    from s2t_tpu_torch.tasks import setup_task

    log("[roberta] cut: the recipe's update_freq 16 runs as one batch a step")
    data = root / "roberta_data"
    write_denoising_corpus(data)
    task = setup_task(from_dict(TrainConfig, {
        "task": ROBERTA_RECIPE["task"], "arch": ROBERTA_RECIPE["arch"],
        "dataset": {"data": str(data), **ROBERTA_RECIPE["dataset"]}}))
    if len(task.dictionary) != V_BART or task.block_size != ROBERTA_BENCH["L"]:
        raise AssertionError(f"masked_lm: {len(task.dictionary)} entries, blocks of "
                             f"{task.block_size}")
    crit = (ROBERTA_RECIPE["criterion"], {})
    rng = np.random.default_rng(50)
    parity, parity_launches = phase_train_parity(
        roberta_base(vocab_size=V_BART, encoder_layers=REF_LAYERS, **NO_DROPOUT), RobertaModel,
        "roberta train", criterion=crit,
        per_step={"attention_fwd": REF_LAYERS, "attention_bwd": REF_LAYERS},
        batches=[mlm_batch(rng, **ROBERTA_PARITY) for _ in range(2)],
        forward_fn=task.forward_fn(), opt=recipe_opt(ROBERTA_RECIPE,
                                                     warmup_updates=PARITY_WARMUP))
    speed, speed_launches = phase_train_speed(
        roberta_base(vocab_size=V_BART, dtype_str="bfloat16"), RobertaModel,
        "roberta train speed", n_timed=MODEL_TIMED, criterion=crit,
        per_step={"attention_fwd": ROBERTA_LAYERS, "attention_bwd": ROBERTA_LAYERS},
        batch=mlm_batch(np.random.default_rng(0), **ROBERTA_BENCH, draws=False),
        forward_fn=task.forward_fn(), opt=recipe_opt(ROBERTA_RECIPE), profile=True)
    speed["tokens_per_s"] = speed["steps_per_s"] * ROBERTA_BENCH["B"] * ROBERTA_BENCH["L"]
    head = roberta_head_card_vs_cpu()
    clis, cli_launches = head_clis(root)
    launches = add_counts(parity_launches, speed_launches, cli_launches)
    launches["attention_fwd"] += REF_LAYERS  # the head's encode
    return {"parity": parity, "speed": speed, "head": head, "clis": clis,
            "vocab": V_BART, "cut": "update_freq 16 -> 1"}, launches


def greedy_lm(model, prompts, n_new):
    """Greedy continuation of (B, P) prompts by ``decode_step``: the prompt fed a token a
    step, then n_new argmax tokens.  Returns (tokens (B, n_new), the step log-probs)."""
    B, P = prompts.shape
    dev = model.device
    cache = model.init_cache(B, P + n_new)
    tok = torch.as_tensor(prompts).to(dev)
    out, lps = [], []
    with torch.inference_mode():
        for i in range(P + n_new - 1):
            step = tok[:, i:i + 1] if i < P else out[-1][:, None]
            logits, cache = model.decode_step(step, cache, i)
            if i >= P - 1:
                lp = torch.log_softmax(logits.float(), dim=-1)
                lps.append(lp.cpu())
                out.append(lp.argmax(-1))
    return torch.stack(out, 1).cpu().numpy(), lps


def gpt2_decode_checks():
    """hf_gpt2 at full width and depth, fp32, seeded: incremental decoding's logits equal
    the full forward's at every position of 2 x 64 tokens on the card (within FORWARD_RTOL
    of their largest magnitude), and greedy continuations of GPT2_PROMPTS card vs CPU:
    identical, or a printed near-tie."""
    from s2t_tpu_torch.models.hf_gpt2 import HFGPT2Model, hf_gpt2

    cfg = hf_gpt2(vocab_size=GPT2_V, **GPT2_NO_DROPOUT)
    card, host = seeded_pair(lambda d: HFGPT2Model(cfg, device=d, seed=0)).values()
    prev = torch.as_tensor(lm_batch(np.random.default_rng(511), 2, 64, GPT2_V)["prev_tokens"])
    reset_counts()  # the main path: the full forward and the steps
    with torch.inference_mode():
        full = card(prev.cuda())["decoder_logits"].float()
        cache = card.init_cache(2, 64)
        steps = []
        for i in range(64):
            logits, cache = card.decode_step(prev[:, i:i + 1].cuda(), cache, i)
            steps.append(logits.float())
    step_err = (torch.stack(steps, 1) - full).abs().max().item()
    step_tol = FORWARD_RTOL * max(1.0, full.abs().max().item())
    prompts = lm_batch(np.random.default_rng(512), **GPT2_PROMPTS, V=GPT2_V)["target"]
    t0 = time.perf_counter()
    card_tok, card_lp = greedy_lm(card, prompts, GPT2_NEW)
    card_s = time.perf_counter() - t0
    check_counts(read_counts(), {k: 0 for k in counters()}, "gpt2 decoding")
    t0 = time.perf_counter()
    host_tok, host_lp = greedy_lm(host, prompts, GPT2_NEW)
    host_s = time.perf_counter() - t0
    for b in range(len(prompts)):  # a differing row must diverge at a near-tie
        diff = np.flatnonzero(card_tok[b] != host_tok[b])
        if len(diff):
            i = int(diff[0])
            gaps = [abs(lp[i][b, card_tok[b, i]] - lp[i][b, host_tok[b, i]]).item()
                    for lp in (card_lp, host_lp)]
            log(f"[gpt2 greedy] row {b} diverges at token {i}: gaps {gaps}")
            if not max(gaps) <= ENC_ATOL:
                raise AssertionError(f"gpt2 greedy row {b} differs with a gap {max(gaps):.3e}")
    res = {"incremental_max_abs_err": step_err, "incremental_tol": step_tol,
           "greedy_identical": bool(np.array_equal(card_tok, host_tok)), "greedy_card_s": card_s,
           "greedy_cpu_s": host_s, "prompts": list(prompts.shape), "new_tokens": GPT2_NEW}
    log(f"[gpt2 decode] {json.dumps(res)}")
    if not step_err <= step_tol:
        raise AssertionError(f"gpt2 incremental logits differ from the forward by {step_err:.3e}")
    return res


def phase_gpt2():
    """Phase 51: hf_gpt2 at GPT-2 small's published widths (768, 12 layers, 12 heads, 50,257
    entries, 1024 positions) through language_modeling (plain cross-entropy): 2 fp32 steps
    card vs CPU at REF_LAYERS, 2 timed bf16 steps at 8 blocks of 1024, the decode checks
    (``gpt2_decode_checks``).  No kernel of the port runs: the causal self-attention is
    dense, in JAX too."""
    from s2t_tpu_torch.models.hf_gpt2 import HFGPT2Model, hf_gpt2
    from s2t_tpu_torch.tasks.language_modeling import lm_forward

    rng = np.random.default_rng(51)
    parity, _ = phase_train_parity(
        hf_gpt2(vocab_size=GPT2_V, decoder_layers=REF_LAYERS, **GPT2_NO_DROPOUT), HFGPT2Model,
        "gpt2 train", criterion=GPT2_CRIT, per_step=NO_KERNEL,
        batches=[lm_batch(rng, **LM_PARITY, V=GPT2_V) for _ in range(2)], forward_fn=lm_forward)
    speed, _ = phase_train_speed(
        hf_gpt2(vocab_size=GPT2_V, dtype_str="bfloat16"), HFGPT2Model, "gpt2 train speed",
        n_timed=MODEL_TIMED, criterion=GPT2_CRIT, per_step=NO_KERNEL,
        batch=lm_batch(np.random.default_rng(0), **GPT2_BENCH, V=GPT2_V), forward_fn=lm_forward,
        opt=mt_opt())
    speed["tokens_per_s"] = speed["steps_per_s"] * GPT2_BENCH["B"] * GPT2_BENCH["L"]
    decode = gpt2_decode_checks()
    return {"parity": parity, "speed": speed, "decode": decode,
            "vocab": GPT2_V}, {k: 0 for k in counters()}


# --------------------------------------------------------------------------- #
# phases 52-54: item 11's tail (online backtranslation, the latency-augmented CE, the
# composite criteria, the legacy modules) and item 12's single-device training breadth
BT_LINES = 32  # bitext, monolingual and denoising lines: one batch of each origin
BT_TASK = {"bt_arch": "transformer", "lambda_denoising": 1.0, "word_shuffle": 3,
           "word_dropout_prob": 0.1, "word_blanking_prob": 0.1}
BT_PARITY_LINES = 8  # the cut-depth reverse model's card-vs-CPU beam
# the source positions (basis.yaml: 512), so the BT beam's cap: seeded weights emit no
# EOS and generate to the cap, 4x the longest monolingual line here
BT_MAX_SOURCE = 128
LATENCY = ("latency_augmented_label_smoothed_cross_entropy", {
    "label_smoothing": 0.1, "latency_weight_avg": 0.1, "latency_weight_var": 0.1,
    "average_method": "weighted_average",
    "latency_weight_avg_type": "differentiable_average_lagging"})
ST_CE = ("label_smoothed_cross_entropy", {"label_smoothing": 0.1})
NEW_OPTIMIZERS = ("adafactor", "adagrad", "sgd", "nag", "adadelta", "adamax", "lamb")
OPTIM_GROUPS = {"encoder": 0.0, "decoder": 0.5}
OPTIM_STEPS, OPTIM_BAD_STEP = 3, 1
OPTIM_ATOL = 1e-6  # parameters card vs CPU after 3 updates (updates ~ lr = 1e-3)
SMALL_ATOL = 1e-4  # the criteria and legacy modules card vs CPU, of each output's scale
REMAT_VARIANTS = {"plain": {}, "layerdrop": {"encoder_layerdrop": 0.2},
                  "remat_full": {"checkpoint_activations": True, "remat_policy": "full"},
                  "remat_dots": {"checkpoint_activations": True, "remat_policy": "dots"}}
REMAT_GRAD_B = 8  # the fp32 remat-vs-plain gradients' batch (T' = 250)
PLATEAU_CORPUS = {"train": 16, "dev": 8}


def st_s_cfg(dtype="float32", **kw):
    """egs/mustc/st/conf/base.yaml's model: s2t_transformer_s with the ST phases' V."""
    return s2t_transformer_s(**{"vocab_size": 10000, "max_target_positions": 1024, **kw,
                                "dtype_str": dtype})


def phase_bt(root: Path):
    """Phase 52: semisupervised_translation over egs/mustc/mt/conf/base.yaml at full width
    and depth for both directions, bf16: cli.train on a seeded corpus of BT_LINES bitext
    and BT_LINES monolingual lines (batches of BT_LINES sentences: one bitext, one
    backtranslation, one denoising batch, 3 updates) with the reverse model from a seeded
    port checkpoint, every origin trained once, the source positions (so the BT beam's
    cap) BT_MAX_SOURCE; then one BT step timed with its generation; the reverse model's
    synthetic sources card vs CPU at REF_LAYERS, fp32."""
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict
    from s2t_tpu_torch.data.backtranslation_dataset import (
        BacktranslationDataset, make_backtranslator)
    from s2t_tpu_torch.data.dictionary import Dictionary
    from s2t_tpu_torch.inference.generator import SequenceGenerator
    from s2t_tpu_torch.models.transformer import TransformerModel
    from s2t_tpu_torch.utils.checkpoint import save_tree

    data = root / "bt_data"
    data.mkdir()
    write_text_corpus(data, {"train": BT_LINES, "dev": 8})
    rng = np.random.default_rng(52)
    words = [f"w{i}" for i in range(2000)]
    mono = [" ".join(rng.choice(words, size=int(rng.integers(8, 30)))) for _ in range(BT_LINES)]
    (data / "mono.de").write_text("\n".join(mono) + "\n")
    model = {**MUSTC_MT_BASE["model"], "dtype_str": "bfloat16"}
    ckpt = root / "bt_reverse.pt"  # the reverse (de -> en) model, seeded
    save_tree(ckpt, {"params": TransformerModel(mt_cfg(MUSTC_MT_BASE, dtype="bfloat16"),
                                                device="cpu", seed=52).state_dict()})
    d = mt_cfg_dict(data, root / "bt_ckpt", MUSTC_MT_BASE)
    d["task"] = "semisupervised_translation"
    d["model"] = model
    d["task_cfg"] = {**BT_TASK, "bt_checkpoint": str(ckpt), "bt_model": model}
    d["dataset"].update(batch_size=BT_LINES, max_tokens=1_000_000,
                        max_source_positions=BT_MAX_SOURCE)
    d["optimization"].update(max_update=3, max_epoch=1)
    cfg = from_dict(TrainConfig, d)
    reset_counts()  # the main path: cli.train, the BT batch's generation in its collate
    t0 = time.perf_counter()
    out = cli_train.main(cfg, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    task, trainer = out["task"], out["trainer"]
    origins = [row["origin"] for row in out["train_log"]]
    n_valid = len(task.get_batch_iterator(task.datasets["dev"], max_tokens=1_000_000,
                                          shuffle=False))
    steps = trainer.step
    cli_counts = read_counts()  # the reverse model encodes once, in the BT batch's collate
    check_counts(cli_counts, {**{k: 0 for k in counters()},
                              "attention_fwd": MT_LAYERS * (steps + n_valid + 1),
                              "attention_bwd": MT_LAYERS * steps}, "bt cli.train")
    if sorted(origins) != [0, 1, 2]:
        raise AssertionError(f"bt cli.train trained origins {origins}, expected each once")
    # one BT step timed with its generation (the collate's beam on the card)
    bt = task.datasets["train"].datasets[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batch = bt.collater([bt[i] for i in range(len(bt))], batch_multiple=8)
    t1 = time.perf_counter()
    m = trainer.train_step(step_batch(batch))
    loss = float(m["loss"])
    t2 = time.perf_counter()
    step_counts = read_counts()
    check_counts(step_counts, {**{k: 0 for k in counters()}, "attention_fwd": 2 * MT_LAYERS,
                               "attention_bwd": MT_LAYERS}, "bt timed step")
    timed = {"sentences": len(bt), "source_tokens": list(batch["src_tokens"].shape),
             "step_ms": (t2 - t0) * 1e3, "generation_ms": (t1 - t0) * 1e3,
             "generation_share": (t1 - t0) / (t2 - t0),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "loss": loss}
    # the synthetic sources card vs CPU at the cut depth, fp32
    models = seeded_pair(lambda dev: TransformerModel(mt_cfg(MUSTC_MT_BASE, **REF_DEPTH),
                                                      device=dev, seed=52))
    dictionary = Dictionary.load(data / "dict.txt")
    src = {}
    for dev in ("cuda", "cpu"):
        gen = SequenceGenerator(models[dev], beam_size=1, max_len_b=20, max_target_positions=512,
                                input_keys=("src_tokens", "src_lengths"))
        ds = BacktranslationDataset(mono[:BT_PARITY_LINES], dictionary,
                                    make_backtranslator(models[dev], gen))
        reset_counts()
        src[dev] = ds.collater([ds[i] for i in range(len(ds))])["src_tokens"]
        if dev == "cuda":
            check_counts(read_counts(), {**{k: 0 for k in counters()},
                                         "attention_fwd": REF_LAYERS}, "bt beam")
    parity = {"sentences": BT_PARITY_LINES, "identical": bool(np.array_equal(src["cuda"],
                                                                          src["cpu"])),
              "source_tokens": list(src["cuda"].shape)}
    res = {"train_s": train_s, "train_log": out["train_log"], "origins": origins,
           "valid": out["history"][-1], "timed_bt_step": timed, "bt_card_vs_cpu": parity}
    log(f"[bt] semisupervised_translation: {json.dumps(res)}")
    if not parity["identical"]:
        raise AssertionError(f"the BT sources differ between the card and the CPU: {src}")
    launches = {k: cli_counts[k] + step_counts[k] for k in counters()}
    launches["attention_fwd"] += REF_LAYERS
    return res, launches


def small_card_vs_cpu():
    """composite_loss / model and the legacy modules on the card and on the CPU from the
    same seeded inputs and weights: outputs within SMALL_ATOL of each one's scale."""
    from s2t_tpu_torch.modules.legacy import (
        CharacterTokenEmbedder, Highway, LocationAttention, VGGBlock)

    g = torch.Generator().manual_seed(53)
    logits = [torch.randn(4, 16, 1000, generator=g) for _ in range(2)]
    targets = torch.randint(4, 1000, (2, 4, 16), generator=g)
    targets[:, 1, 12:] = 1
    enc, dec_h = torch.randn(4, 250, 256, generator=g), torch.randn(4, 256, generator=g)
    valid = torch.arange(250)[None] < torch.tensor([250, 200, 120, 31])[:, None]
    state = torch.softmax(torch.randn(4, 1, 250, generator=g), -1)
    chars = torch.randint(3, 257, (4, 16, 12), generator=g)
    chars[0, 3] = 0
    chars[0, 3, 0] = 1
    torch.manual_seed(53)
    cases = {
        "composite_loss": (build_criterion("composite_loss", {
            "underlying_criterion": "label_smoothed_cross_entropy"}),
            lambda f, dev: f({"outputs": tuple({"decoder_logits": x.to(dev)} for x in logits)},
                             {"targets": targets.to(dev)})[0]),
        "model": (build_criterion("model", {"loss_weights": {"a": 2.0, "b": 0.5}}),
                  lambda f, dev: f({"losses": {"a": logits[0].to(dev).square().mean(),
                                               "b": logits[1].to(dev).abs().mean()}},
                                   {"ntokens": 64.0})[0]),
        "vgg_block": (VGGBlock(1, 64, input_dim=80, layer_norm=True),
                      lambda f, dev: f(enc[..., :80, None].to(dev))),
        "location_attention": (LocationAttention(256, 256, 256),
                               lambda f, dev: f(enc.to(dev), valid.to(dev), dec_h.to(dev),
                                                state.to(dev))[0]),
        "highway": (Highway(256), lambda f, dev: f(enc.to(dev))),
        "char_embedder": (CharacterTokenEmbedder(256), lambda f, dev: f(chars.to(dev))),
    }
    res = {}
    for name, (mod, run) in cases.items():
        card_mod = copy.deepcopy(mod).to("cuda") if isinstance(mod, torch.nn.Module) else mod
        with torch.no_grad():
            host, card = run(mod, "cpu"), run(card_mod, "cuda").cpu()
        res[name] = (card - host).abs().max().item() / max(host.abs().max().item(), 1.0)
    log(f"[latency] composite / model criteria and legacy modules card vs CPU: "
        f"{json.dumps(res)} (limit {SMALL_ATOL} of each output's scale)")
    if not all(e <= SMALL_ATOL for e in res.values()):
        raise AssertionError(f"criteria or legacy modules disagree card vs CPU: {res}")
    return res


def phase_latency():
    """Phase 53: s2t_transformer_s (egs/mustc/st/conf/base.yaml's widths) under
    latency_augmented_label_smoothed_cross_entropy (weighted_average / DAL, both weights
    0.1): 2 fp32 steps card vs CPU at REF_LAYERS (loss, latency_loss, gnorm); 2 timed bf16
    steps at full depth beside the same model under the plain label-smoothed CE (the
    cross-attention capture's cost); one bf16 step of the MT base under the criterion;
    composite_loss / model and the legacy modules card vs CPU."""
    from s2t_tpu_torch.criterions.latency import with_cross_attn
    from s2t_tpu_torch.models.transformer import TransformerModel, text_forward

    fwd = with_cross_attn(stack_forward)
    ref = shallow(st_s_cfg(**NO_DROPOUT))
    layers = {"attention_fwd": 12, "attention_bwd": 12}
    parity, parity_launches = phase_train_parity(
        ref, tag="latency train", criterion=LATENCY, log_keys=("latency_loss",),
        per_step={k: encoder_layers(ref) for k in layers}, forward_fn=fwd)
    if not all(m["latency_loss"] > 0 for m in parity["card"]):
        raise AssertionError(f"no latency penalty: {parity['card']}")
    speed, speed_launches = phase_train_speed(
        st_s_cfg("bfloat16"), tag="latency train speed", n_timed=MODEL_TIMED, criterion=LATENCY,
        per_step=layers, forward_fn=fwd)
    plain, plain_launches = phase_train_speed(
        st_s_cfg("bfloat16"), tag="plain CE train speed", n_timed=MODEL_TIMED, criterion=ST_CE,
        per_step=layers)
    mt_layers = {k: MT_LAYERS for k in layers}
    mt, mt_launches = phase_train_speed(
        mt_cfg(MUSTC_MT_BASE, dtype="bfloat16"), TransformerModel, "latency mt step",
        n_timed=1, criterion=LATENCY, per_step=mt_layers,
        batch=text_batch(np.random.default_rng(53), **MT_BENCH),
        forward_fn=with_cross_attn(text_forward), opt=mt_opt())
    small = small_card_vs_cpu()
    capture = {"extra_step_ms": speed["step_ms"] - plain["step_ms"],
               "extra_peak_gb": speed["peak_memory_gb"] - plain["peak_memory_gb"]}
    log(f"[latency] capture cost at B=40 x T=1000 (bf16): {json.dumps(capture)}")
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] + plain_launches[k]
                + mt_launches[k] for k in counters()}
    return {"parity": parity, "speed": speed, "plain_ce_speed": plain, "capture": capture,
            "mt_step": mt, "small_card_vs_cpu": small}, launches


def optimizers_card_vs_cpu():
    """Each new optimizer: OPTIM_STEPS updates of s2t_transformer_s's whole parameter set
    (seeded, float32) from seeded gradients (step OPTIM_BAD_STEP's non-finite, so skipped)
    through SkipNonFiniteChain with clipping and lr_groups (encoder frozen, decoder
    halved), on the card and on the CPU: every parameter within OPTIM_ATOL."""
    from s2t_tpu_torch.optim.builders import SkipNonFiniteChain, build_lr_schedule, group_scales
    from s2t_tpu_torch.trainer import flax_top_key

    host = S2TTransformerModel(st_s_cfg(), device="cpu", seed=0, for_training=True)
    names = [n for n, _ in host.named_parameters()]
    base = [p.detach().clone() for _, p in host.named_parameters()]
    scales = group_scales(names, OPTIM_GROUPS, flax_top_key(host))
    g = torch.Generator().manual_seed(54)
    grads = {"cpu": [[torch.randn(p.shape, generator=g) for p in base]
                     for _ in range(OPTIM_STEPS)]}
    grads["cpu"][OPTIM_BAD_STEP][0].view(-1)[0] = float("nan")
    grads["cuda"] = [[x.to("cuda") for x in step] for step in grads["cpu"]]
    frozen = [i for i, s in enumerate(scales) if s == 0.0]
    res = {}
    for name in NEW_OPTIMIZERS:
        cfg = OptimizationConfig(optimizer=name, lr=1e-3, lr_scheduler="fixed", clip_norm=10.0,
                                 weight_decay=0.01,
                                 lr_groups=dict(OPTIM_GROUPS))
        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            params = [torch.nn.Parameter(p.to(dev, copy=True)) for p in base]
            opt = SkipNonFiniteChain(params, cfg, build_lr_schedule(cfg), scales)

            def run():
                for step in grads[dev]:
                    for p, gr in zip(params, step):
                        p.grad = gr
                    opt.step()
            secs[dev] = synced_s(run)
            if int(opt.count) != OPTIM_STEPS - 1:
                raise AssertionError(f"{name} on {dev}: {int(opt.count)} applied updates")
            out[dev] = [p.detach().cpu() for p in params]
        err = max((a - b).abs().max().item() for a, b in zip(out["cuda"], out["cpu"]))
        moved = max((a - b).abs().max().item() for a, b in zip(out["cuda"], base))
        still = all(torch.equal(out["cuda"][i], base[i]) for i in frozen)
        res[name] = {"max_abs_err": err, "largest_move": moved, "frozen_unchanged": still,
                     "card_s": secs["cuda"], "cpu_s": secs["cpu"]}
        if not (err <= OPTIM_ATOL and moved > 0 and still):
            raise AssertionError(f"{name} card vs CPU: {res[name]}")
    log(f"[optim] {len(names)} parameters ({sum(p.numel() for p in base):,} entries), "
        f"{OPTIM_STEPS} updates card vs CPU: {json.dumps(res)} (limit {OPTIM_ATOL})")
    return res


def remat_speed(tag, kw, n_timed=MODEL_TIMED):
    """bf16 steps of s2t_transformer_s at phase 8's shape with ``kw`` set: 1 warm-up and
    ``n_timed`` timed steps, each step's K1f / K1b launches checked against what it ran
    (LayerDrop's keep bits from the step generator's seed; a checkpointed layer runs K1f
    twice)."""
    from s2t_tpu_torch.models.s2t_transformer import draw_layer_keep
    from s2t_tpu_torch.trainer import fold_in

    cfg = st_s_cfg("bfloat16", **kw)
    model = S2TTransformerModel(cfg, device="cuda", seed=0, for_training=True)
    trainer = Trainer(model, make_criterion(CRITERION),
                      OptimizationConfig(lr=2e-3, warmup_updates=10000, clip_norm=10.0),
                      device="cuda", seed=1, forward_fn=stack_forward)
    batch = nested_to(train_batch(np.random.default_rng(0), 40, 1000, 30, 10000, [1000] * 40),
                      "cuda")

    def want(step):
        kept = cfg.encoder_layers
        if cfg.encoder_layerdrop > 0:
            kept = sum(draw_layer_keep(cfg.encoder_layers, cfg.encoder_layerdrop,
                                       fold_in(trainer.seed, step)))
        return {**{k: 0 for k in counters()}, "ctc_alpha": 1, "ctc_beta_grad": 1,
                "attention_fwd": kept * (2 if cfg.checkpoint_activations else 1),
                "attention_bwd": kept}

    launches, total = [], {k: 0 for k in counters()}
    losses = []

    def step():
        w = want(trainer.step)
        reset_counts()
        losses.append(trainer.train_step(batch)["loss"])
        counts = read_counts()
        check_counts(counts, w, f"{tag} step {trainer.step - 1}")
        launches.append({"attention_fwd": counts["attention_fwd"],
                         "attention_bwd": counts["attention_bwd"]})
        for k in total:
            total[k] += counts[k]
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = synced_s(lambda: [step() for _ in range(n_timed)])
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{tag}: bf16 loss not finite: {losses}")
    res = {"step_ms": secs / n_timed * 1e3, "peak_memory_gb": torch.cuda.max_memory_allocated()
           / 1e9, "launches_per_step": launches, "loss_first_last": [losses[0].item(),
                                                                      losses[-1].item()]}
    del trainer, model
    return res, total


def remat_grads_card():
    """fp32 on the card, dropout 0.1, torch's deterministic algorithms on (the CTC
    gradient's and the embeddings' scatter-adds accumulate in any order otherwise): one
    seeded s2t_transformer_s's gradients of one batch under the same step generator,
    plain twice (the run-to-run spread) and under each remat policy: equal bit for bit,
    or within the plain repeat's spread."""
    from s2t_tpu_torch.models.s2t_transformer import REMAT_POLICIES

    model = S2TTransformerModel(st_s_cfg(), device="cuda", seed=0, for_training=True)
    batch = nested_to(train_batch(np.random.default_rng(1), REMAT_GRAD_B, 1000, 30, 10000,
                                  [1000, 950, 900, 700, 640, 512, 400, 260]), "cuda")
    crit = make_criterion(CRITERION)
    base_cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]

    def grads(**kw):
        model.cfg = model.encoder.cfg = base_cfg.replace(**kw)
        model.zero_grad(set_to_none=True)
        out = stack_forward(model, batch, train=True,
                            generator=torch.Generator(device="cuda").manual_seed(5))
        crit(out, batch)[0].backward()
        return [p.grad.detach().clone() for p in model.parameters()]

    def diff(a, b):
        d = [(x - y).abs().max().item() for x, y in zip(a, b)]
        worst = sorted(range(len(d)), key=lambda i: -d[i])[:3]
        return max(d), {names[i]: d[i] for i in worst if d[i] > 0}

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reset_counts()  # the main path: 5 training forwards / backwards, 3 checkpointed
        plain = grads()
        spread, spread_at = diff(plain, grads())
        res = {"plain_repeat_max_abs_diff": spread, "plain_repeat_worst": spread_at}
        for policy in REMAT_POLICIES:
            d, at = diff(plain, grads(checkpoint_activations=True, remat_policy=policy))
            res[policy] = {"max_abs_diff": d, "bitwise": d == 0.0, "worst": at}
    finally:
        torch.use_deterministic_algorithms(deterministic)
        model.cfg = model.encoder.cfg = base_cfg
    counts = read_counts()
    n = 2 + len(REMAT_POLICIES)
    check_counts(counts, {**{k: 0 for k in counters()}, "ctc_alpha": n, "ctc_beta_grad": n,
                          "attention_fwd": 12 * (n + len(REMAT_POLICIES)),
                          "attention_bwd": 12 * n}, "remat gradients")
    log(f"[optim] fp32 gradients with remat vs without at dropout 0.1: {json.dumps(res)}")
    if not all(res[p]["max_abs_diff"] <= spread for p in REMAT_POLICIES):
        raise AssertionError(f"remat gradients differ from the plain ones beyond the plain "
                             f"repeat's spread: {res}")
    return res, counts


def plateau_cli(root: Path):
    """cli.train of the MT base at REF_LAYERS a side, 2 epochs under reduce_lr_on_plateau
    at a base lr of 0 (the validation loss cannot improve; at 1e-7 Adam's sign-like
    updates of every entry still moved it by 2e-3): the second validation shrinks the lr
    scale to lr_shrink and logs it."""
    from s2t_tpu_torch.cli import train as cli_train
    from s2t_tpu_torch.config import TrainConfig, from_dict

    data = root / "plateau_data"
    data.mkdir()
    write_text_corpus(data, PLATEAU_CORPUS, seed=54)
    d = mt_cfg_dict(data, root / "plateau_ckpt", MUSTC_MT_BASE)
    d["model"] = {**d["model"], **REF_DEPTH, **NO_DROPOUT}
    d["optimization"] = {**d["optimization"], "lr_scheduler": "reduce_lr_on_plateau",
                         "lr": 0.0, "lr_shrink": 0.5, "lr_patience": 0, "max_epoch": 2,
                         "max_update": 1000}
    reset_counts()
    out = cli_train.main(from_dict(TrainConfig, d), device="cuda")
    counts = read_counts()
    scales = [h["lr_scale"] for h in out["history"]]
    steps, task = out["trainer"].step, out["task"]
    n_valid = len(task.get_batch_iterator(task.datasets["dev"], max_tokens=8192, shuffle=False))
    check_counts(counts, {**{k: 0 for k in counters()},
                          "attention_fwd": REF_LAYERS * (steps + 2 * n_valid),
                          "attention_bwd": REF_LAYERS * steps}, "plateau cli.train")
    res = {"lr_scale_by_epoch": scales, "steps": steps,
           "valid_loss": [h["loss"] for h in out["history"]]}
    log(f"[optim] reduce_lr_on_plateau cli.train: {json.dumps(res)}")
    if scales != [1.0, 0.5]:
        raise AssertionError(f"the plateau scale did not change: {res}")
    return res, counts


def phase_optim(root: Path):
    """Phase 54: item 12 on one card.  The seven new optimizers card vs CPU on
    s2t_transformer_s's parameters; bf16 steps of s2t_transformer_s at phase 8's shape
    plain, with encoder_layerdrop 0.2, and with remat full and dots (ms, peak GB, each
    step's K1f / K1b); fp32 gradients with remat equal those without; cli.train under
    reduce_lr_on_plateau."""
    optim = optimizers_card_vs_cpu()
    speed, launches = {}, {k: 0 for k in counters()}
    for tag, kw in REMAT_VARIANTS.items():
        speed[tag], counts = remat_speed(f"optim {tag}", kw)
        launches = {k: launches[k] + counts[k] for k in launches}
    remat = {tag: {"extra_step_ms": speed[tag]["step_ms"] - speed["plain"]["step_ms"],
                   "peak_gb_saved": speed["plain"]["peak_memory_gb"]
                   - speed[tag]["peak_memory_gb"]} for tag in REMAT_VARIANTS if tag != "plain"}
    log(f"[optim] bf16 s2t_transformer_s at B=40 x T=1000: {json.dumps(speed)}; against "
        f"plain: {json.dumps(remat)}")
    grads, grad_launches = remat_grads_card()
    plateau, plateau_launches = plateau_cli(root)
    launches = {k: launches[k] + grad_launches[k] + plateau_launches[k] for k in launches}
    return {"optimizers": optim, "speed": speed, "against_plain": remat, "remat_grads": grads,
            "plateau": plateau}, launches


# --------------------------------------------------------------------------- #
# phases 55-56: item 12's parallelism and BMUF, item 16's settings
PARALLEL_BATCH = dict(B=8, T=600, U=30, lengths=[600, 580, 520, 480, 440, 400, 360, 300])
PARALLEL_OPT = dict(lr=2e-3, warmup_updates=3, clip_norm=10.0, adam_eps=1e-6)
# BMUF with SGD, a sync every update and no clip: when the replicas' sample sizes are
# equal, their average after an update is SGD's update on the whole batch (JAX's
# tests/test_bmuf_trainer.py::test_matches_dp_with_sgd_and_every_step_sync), so the
# reference is that update followed by the block update (``optim/bmuf.py``); block
# momentum 0.5 and the NBM lookahead move the parameters off plain data parallelism
PARALLEL_SGD = dict(optimizer="sgd", lr=2e-3, warmup_updates=3, clip_norm=0.0)
PARALLEL_BMUF = dict(active=True, sync_interval=1, warmup_iterations=0, block_momentum=0.5,
                     block_lr=1.0, use_nbm=True)
# SGD moves each entry in proportion to its gradient: float noise stays far below this
BMUF_PARAM_BOUND = 1e-5
# mode -> (distributed fields, BMUF fields or None, the reference it is held to); two
# ranks over gloo, both on cuda:0 (NCCL refuses two ranks on one device; gloo's
# point-to-point refuses CUDA tensors, so the pipeline and the ring run at world size 1)
PARALLEL_GLOO_MODES = {"dp": (dict(data_parallel=2), None, "adam"),
                       "tp": (dict(model_parallel=2), None, "adam"),
                       "fsdp": (dict(data_parallel=2, fsdp=True), None, "adam"),
                       "bmuf": (dict(data_parallel=2), PARALLEL_BMUF, "bmuf")}
PARALLEL_STEPS = 2
PDS_192 = dict(decoder_embed_dim=192, decoder_ffn_embed_dim=768, decoder_attention_heads=4,
               decoder_learned_pos=True, vocab_size=10000, max_target_positions=1024)


def parallel_cfg(**kw):
    """s2t_transformer_s at full width and depth with CTC, fp32, dropout 0."""
    return st_s_cfg(**NO_DROPOUT, **kw)


def parallel_batch():
    b = PARALLEL_BATCH
    return train_batch(np.random.default_rng(55), b["B"], b["T"], b["U"], 10000, b["lengths"])


def parallel_steps(trainer, batch, per_step, tag, after=None):
    """PARALLEL_STEPS fp32 steps, the launches checked per step, ``after(trainer)`` (if
    given) after each, untimed; the second step's ms and the peak GB of the process."""
    torch.cuda.reset_peak_memory_stats()
    metrics, launches, ms = [], {k: 0 for k in counters()}, 0.0
    for i in range(PARALLEL_STEPS):
        reset_counts()  # the main path: one step of the mode
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        check_counts(counts, {**{k: 0 for k in counters()}, **per_step}, f"{tag} step {i}")
        launches = {k: launches[k] + counts[k] for k in launches}
        metrics.append({k: float(m[k]) for k in ("loss", "ctc_loss", "gnorm", "lr")})
        if after is not None:
            after(trainer)
    return {"steps": metrics, "step_ms": ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}, launches


def parallel_agreement(got, ref_metrics, got_params, ref_params, tag, param_bound,
                       keys=tuple(TRAIN_RTOL)):
    """``keys`` of each step (the loss, CTC loss and norm) at TRAIN_RTOL and every
    parameter within ``param_bound`` of the reference's."""
    errs = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in keys} for a, b in
            zip(got["steps"], ref_metrics)]
    worst = max((got_params[n].float() - ref_params[n].float()).abs().max().item()
                for n in ref_params)
    got.update(rel_err=errs, max_param_diff=worst, param_bound=param_bound)
    if any(not e[k] <= TRAIN_RTOL[k] for e in errs for k in keys) or \
            not worst <= param_bound:
        raise AssertionError(f"{tag} disagrees with its one-device reference: {errs}, "
                             f"max param difference {worst:.3e} (bound {param_bound:.3e})")
    return got


def adam_bound(ref_metrics) -> float:
    """Adam's first updates are ~lr sign(g): an entry whose gradient is float noise
    around 0 moves up to 2 lr a step apart, the steps' own lr (``phase_train_parity``)."""
    return 2 * sum(m["lr"] for m in ref_metrics)


def bmuf_reference(model):
    """The one-device reference of the BMUF mode, as ``parallel_steps``' ``after``: SGD's
    update on the whole batch (the replicas' average), then the block update from
    ``model``'s parameters now and the NBM restart, in place."""
    from s2t_tpu_torch.config import BMUFConfig
    from s2t_tpu_torch.optim.bmuf import bmuf_init, bmuf_restart_point, bmuf_sync

    cfg = BMUFConfig(**PARALLEL_BMUF)
    block = list(bmuf_init(dict(model.named_parameters())))

    @torch.no_grad()
    def after(trainer):
        named = dict(zip(trainer.param_names, trainer.optimizer.params))
        block[:] = bmuf_sync(cfg, block[0], {n: p.detach().clone() for n, p in named.items()},
                             block[1])
        for n, p in bmuf_restart_point(cfg, *block).items():
            named[n].copy_(p)

    return after


def parallel_trainer(model, opt, dist_kw=None, bmuf_kw=None):
    from s2t_tpu_torch.config import BMUFConfig, DistributedConfig

    return Trainer(model, make_criterion(CRITERION), OptimizationConfig(**opt), device="cuda",
                   seed=1, forward_fn=stack_forward,
                   dist_cfg=None if dist_kw is None else DistributedConfig(**dist_kw),
                   bmuf_cfg=None if bmuf_kw is None else BMUFConfig(**bmuf_kw))


def stacked_state(sd, S, L):
    """A plain encoder's state dict in the pipelined layout: layer i -> stage i // (L / S)."""
    per = L // S
    out = {}
    for k, v in sd.items():
        m = re.match(r"encoder\.layers\.(\d+)\.(.*)", k)
        out[f"encoder.pipe_stages.{int(m.group(1)) // per}.layers.{int(m.group(1)) % per}."
            f"{m.group(2)}" if m else k] = v
    return out


def parallel_rank_main(in_path: str, out_path: str) -> int:
    """One of phase 55's two ranks over gloo on cuda:0 (RANK / WORLD_SIZE / MASTER_* in
    the environment): every mode of PARALLEL_GLOO_MODES from the seeded weights, held to
    the one-device references that the parent wrote; the results to ``out_path``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo")
    refs = torch.load(in_path, map_location="cpu", weights_only=False)
    host = S2TTransformerModel(parallel_cfg(), device="cpu", seed=0, for_training=True)
    batch = nested_to(parallel_batch(), "cuda")
    out, launches = {}, {k: 0 for k in counters()}
    for mode, (dist_kw, bmuf_kw, ref) in PARALLEL_GLOO_MODES.items():
        opt = PARALLEL_SGD if bmuf_kw else PARALLEL_OPT
        trainer = parallel_trainer(copy.deepcopy(host).to("cuda"), opt, dist_kw, bmuf_kw)
        res, counts = parallel_steps(trainer, batch, TRAIN_LAUNCHES, f"parallel {mode}")
        params = trainer.state_dict()["params"]  # every rank: a sharded Trainer gathers
        res["mesh"] = trainer.mesh.shape
        # BMUF's norm is the mean of the replicas' own (s2t_tpu/trainer.py:503-511)
        keys = ("loss", "ctc_loss") if bmuf_kw else tuple(TRAIN_RTOL)
        bound = BMUF_PARAM_BOUND if bmuf_kw else adam_bound(refs[ref]["metrics"])
        out[mode] = parallel_agreement(res, refs[ref]["metrics"], params, refs[ref]["params"],
                                       f"{mode} over 2 gloo ranks", bound, keys)
        launches = {k: launches[k] + counts[k] for k in launches}
        del trainer, params
        torch.cuda.empty_cache()
    torch.save({"modes": out, "launches": launches}, out_path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_parallel(root: Path):
    """Phase 55: item 12 on the card, s2t_transformer_s at full width and depth with CTC,
    fp32, dropout 0, PARALLEL_STEPS steps at B=8 x T=600.  The one-device Trainer's steps
    are the references: Adam, and SGD followed by the block update (``bmuf_reference``).
    The pipelined model (pipeline_parallel=2, M=4 microbatches, its stages in order on
    one rank) from the same weights restacked.  Then, with nothing else on the card, two
    ranks over gloo, both on cuda:0: DP, TP (H / 2 heads a rank through K1f / K1b), FSDP
    and BMUF, each held to its reference on the whole batch.  Each mode's second step's
    ms and its process's peak GB (the two ranks' ms are read beside each other)."""
    host = S2TTransformerModel(parallel_cfg(), device="cpu", seed=0, for_training=True)
    batch = nested_to(parallel_batch(), "cuda")
    refs, results, launches = {}, {}, {k: 0 for k in counters()}

    def run(tag, model, opt, per_step=TRAIN_LAUNCHES, after=None):
        trainer = parallel_trainer(model, opt)
        res, counts = parallel_steps(trainer, batch, per_step, f"parallel {tag}", after)
        for k in launches:
            launches[k] += counts[k]
        params = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
        return res, params

    res, params = run("one device adam", copy.deepcopy(host).to("cuda"), PARALLEL_OPT)
    refs["adam"] = {"metrics": res["steps"], "params": params}
    results["one_device_adam"] = res
    model = copy.deepcopy(host).to("cuda")
    res, params = run("one device sgd + block update", model, PARALLEL_SGD,
                      after=bmuf_reference(model))
    refs["bmuf"] = {"metrics": res["steps"], "params": params}
    results["one_device_bmuf"] = res
    del model  # nothing of a reference on the card beside the modes measured after it
    torch.cuda.empty_cache()
    pipe = S2TTransformerModel(parallel_cfg(pipeline_parallel=2), device="cpu", seed=0,
                               for_training=True)
    pipe.load_state_dict(stacked_state(host.state_dict(), 2, 12))
    M = 4  # pipeline_microbatches 0: 2 S
    res, params = run("pipeline 2 stages one rank", pipe.to("cuda"), PARALLEL_OPT,
                      per_step={**TRAIN_LAUNCHES, "attention_fwd": 12 * M,
                                "attention_bwd": 12 * M})
    want = stacked_state(refs["adam"]["params"], 2, 12)
    results["pipeline_one_rank"] = parallel_agreement(
        res, refs["adam"]["metrics"], params, want, "the pipelined model",
        adam_bound(refs["adam"]["metrics"]))
    del host, pipe
    torch.cuda.empty_cache()
    # the gloo ranks only now: nothing of this process runs beside them
    ref_path = root / "parallel_refs.pt"
    torch.save(refs, ref_path)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-rank", str(ref_path),
         str(root / f"parallel_rank{r}.pt")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
             "MASTER_PORT": str(port)}) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(text[-6000:])
            raise AssertionError(f"phase 55's gloo rank {r} exited {p.returncode}")
    for r in range(2):
        got = torch.load(root / f"parallel_rank{r}.pt", weights_only=False)
        for mode, res in got["modes"].items():
            results[f"{mode}_gloo_rank{r}"] = res
        for k in launches:
            launches[k] += got["launches"][k]
    log(f"[parallel] s2t_transformer_s fp32 at B=8 x T=600, {PARALLEL_STEPS} steps: "
        f"{json.dumps(results)}")
    return results, launches


def phase_item16():
    """Phase 56: item 16 on the card, pdss2t_transformer_s_8 (egs/mustc/st's PDS widths)
    under a 192-wide decoder with learned positions over its 256-wide encoder: 2 fp32
    steps card vs CPU at the cut depth and one timed bf16 step at full depth."""
    cfg = pdss2t_transformer_s_8(**PDS_192, **NO_DROPOUT)
    parity, parity_launches = phase_train_parity(shallow(cfg), PDSS2TTransformerModel,
                                                 "pds 192 decoder train")
    speed, speed_launches = phase_train_speed(
        pdss2t_transformer_s_8(**PDS_192, dtype_str="bfloat16"), PDSS2TTransformerModel,
        "pds 192 decoder train speed", n_timed=1)
    launches = {k: parity_launches.get(k, 0) + speed_launches[k] for k in counters()}
    return {"parity": parity, "speed": speed}, launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--parallel-rank", nargs=2, help=argparse.SUPPRESS)  # phase 55's ranks
    args = ap.parse_args(argv)
    if args.parallel_rank:
        return parallel_rank_main(*args.parallel_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA H100", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_s, last = {}, [t_start]

    def mark(name):  # the seconds each phase took, logged and kept for the JSON
        now = time.perf_counter()
        phase_s[name] = phase_s.get(name, 0.0) + now - last[0]
        last[0] = now
        log(f"[phase time] {name}: {now - t_start:.1f} s in, {phase_s[name]:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"{torch.get_num_threads()} CPU threads of {os.cpu_count()}")

    # every nvcc starts at once; the phases that launch no kernel of the port run while
    # they compile
    _build.start()
    berard, berard_launches = phase_berard()
    mark("phase_berard")
    w2v1, w2v1_launches = phase_w2v1()
    mark("phase_w2v1")
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_zoo_") as tmp:
        fconv, fconv_launches = phase_fconv(Path(tmp))
        mark("phase_fconv")
        adaptive_lm, adaptive_lm_launches = phase_adaptive_lm(Path(tmp))
        mark("phase_adaptive_lm")
    rnn_conv, rnn_conv_launches = phase_rnn_conv()
    mark("phase_rnn_conv")
    gpt2, gpt2_launches = phase_gpt2()
    mark("phase_gpt2")
    sass = phase_build()  # waits for the compilers
    mark("phase_build")
    cases, main_shape, fwd_by_dim, fwd_pds0 = phase_kernel()
    mark("phase_kernel")
    grad_cases, kept_share, grad_main, bwd_by_dim, bwd_pds0 = phase_attention_grad()
    mark("phase_attention_grad")
    ctc_cases = phase_ctc()
    mark("phase_ctc")
    w2v_attention = phase_w2v2_attention()  # phase 36: K1f / K1b at the wav2vec2 shape
    mark("phase_w2v2_attention")
    mt_kernels = mt_kernel_rows()  # phases 37-38's K1f / K1b / K3 / K4 shapes
    mark("mt_kernel_rows")

    reset_counts()
    encodes = phase_serve_parity()
    mark("phase_serve_parity")
    more, speed = phase_speed()
    mark("phase_speed")
    encodes += more
    serve_launches = fused_attention.launches
    if serve_launches != 12 * encodes:
        raise AssertionError(f"serving launched the attention kernel {serve_launches} times for "
                             f"{encodes} encodes, expected {12 * encodes}")
    log(f"[main path] serving: attention_fwd launches {serve_launches} over {encodes} encodes "
        f"({serve_launches // encodes} per encode)")
    parity, parity_launches = phase_train_parity()
    mark("phase_train_parity")
    train_speed, speed_launches = phase_train_speed(n_timed=EARLIER_TIMED)
    mark("phase_train_speed")
    train_launches = {k: parity_launches[k] + speed_launches[k] for k in TRAIN_LAUNCHES}
    steps = train_launches["ctc_alpha"]
    log(f"[main path] training: {json.dumps(train_launches)} over {steps} steps "
        f"({json.dumps(TRAIN_LAUNCHES)} per step)")

    fbank_main = phase_fbank()
    mark("phase_fbank")
    nast, nast_launches = phase_nast()
    mark("phase_nast")
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_") as tmp:
        audio, audio_launches = phase_train_audio(Path(tmp))
        mark("phase_train_audio")
        generate, gen_launches = phase_generate(Path(tmp))
        mark("phase_generate")
        train_ctc, ctc_launches = phase_train_ctc(Path(tmp))
        mark("phase_train_ctc")
        sanity, sanity_launches = phase_wer_sanity()
        mark("phase_wer_sanity")
        # phase 18 trains through the CLI on phase 14's feature splits
        pds_train, pds_train_launches = phase_pds_train(Path(tmp))
        mark("phase_pds_train")
        # phases 20-21 train from phase 11's wavs and decode phase 14's feature split
        sate_train, sate_train_launches = phase_sate_train(Path(tmp))
        mark("phase_sate_train")
        conformer, conformer_launches = phase_conformer(Path(tmp))
        mark("phase_conformer")
        # phases 22-24: the CTC research stack; 24 trains from phase 11's wavs
        nast_stack, nast_stack_launches = phase_stack_nast()
        mark("phase_stack_nast")
        bil_ctc, bil_ctc_launches = phase_stack_bil_ctc()
        mark("phase_stack_bil_ctc")
        aipa, aipa_launches = phase_stack_aipa(Path(tmp))
        mark("phase_stack_aipa")
    # phases 25-27: the rest of the CTC research stack
    ctc_aug, ctc_aug_launches = phase_ctc_aug()
    mark("phase_ctc_aug")
    nast_pds, nast_pds_launches = phase_nast_pds_big()
    mark("phase_nast_pds_big")
    pds_taps, pds_taps_launches = phase_pds_taps()
    mark("phase_pds_taps")
    # phases 28-29: the encoder variants
    variants, variant_launches = phase_variants()
    mark("phase_variants")
    efficient, efficient_launches = phase_efficient_conformer()
    mark("phase_efficient_conformer")
    # phase 30: the generator's full breadth
    generator, generator_launches = phase_generator()
    mark("phase_generator")
    # phases 31-36: the wav2vec 2.0 family, the dual / multibranch models, quant noise and
    # multilingual training, K1f / K1b at the wav2vec2 shape
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_w2v_") as tmp:
        w2v_pretrain, w2v_pretrain_launches = phase_w2v2_pretrain(Path(tmp))
        mark("phase_w2v2_pretrain")
        w2v_st, w2v_st_launches = phase_w2v2_st(Path(tmp))
        mark("phase_w2v2_st")
        item15, item15_launches = phase_item15(Path(tmp))
        mark("phase_item15")
    w2v_ctc, w2v_ctc_launches = phase_w2v_ctc()
    mark("phase_w2v_ctc")
    league, league_launches = phase_league()
    mark("phase_league")
    # phases 37-41: the text Transformer MT path, Berard, the Emformer, wav2vec v1
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_mt_") as tmp:
        mt, mt_launches = phase_mt(Path(tmp))
        mark("phase_mt")
    mt_ctc, mt_ctc_launches = phase_mt_ctc()
    mark("phase_mt_ctc")
    emformer, emformer_launches = phase_emformer()
    mark("phase_emformer")
    # phases 44-45: the rest of the text zoo's recipes (42-43 ran during the build)
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_zoo_") as tmp:
        align, align_launches = phase_align(Path(tmp))
        mark("phase_align")
        nat, nat_launches = phase_nat(Path(tmp))
        mark("phase_nat")
    # phases 46-47: BART / mBART (48, the LSTM and conv models, ran during the build)
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_bart_") as tmp:
        bart, bart_launches = phase_bart(Path(tmp))
        mark("phase_bart")
        mbart, mbart_launches = phase_mbart(Path(tmp))
        mark("phase_mbart")
    # phases 49-50 (51, GPT-2, ran during the build)
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_ml_") as tmp:
        multilingual, multilingual_launches = phase_multilingual(Path(tmp))
        mark("phase_multilingual")
        roberta, roberta_launches = phase_roberta(Path(tmp))
        mark("phase_roberta")
    # phases 52-54: online backtranslation, the latency-augmented CE, item 12 on one card
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_bt_") as tmp:
        bt, bt_launches = phase_bt(Path(tmp))
        mark("phase_bt")
        latency, latency_launches = phase_latency()
        mark("phase_latency")
        optim, optim_launches = phase_optim(Path(tmp))
        mark("phase_optim")
    # phases 55-56: parallelism and BMUF, item 16's settings
    with tempfile.TemporaryDirectory(prefix="s2t_chip_smoke_parallel_") as tmp:
        parallel, parallel_launches = phase_parallel(Path(tmp))
        mark("phase_parallel")
    item16, item16_launches = phase_item16()
    mark("phase_item16")
    log(f"[main path] parallelism (references, pipeline, two gloo ranks) "
        f"{json.dumps(parallel_launches)}; PDS under a 192-wide decoder (parity, speed) "
        f"{json.dumps(item16_launches)}")
    log(f"[main path] semisupervised MT (CLI with BT in the collate, timed BT step, BT beam) "
        f"{json.dumps(bt_launches)}; latency CE (parity, speed, plain CE, MT step) "
        f"{json.dumps(latency_launches)}; optimizers, layerdrop / remat (speed, gradients), "
        f"plateau CLI {json.dumps(optim_launches)}")
    log(f"[main path] multilingual Transformer (parity, speed, CLIs, beam) "
        f"{json.dumps(multilingual_launches)}; RoBERTa (parity, speed, head, sentence-task CLIs) "
        f"{json.dumps(roberta_launches)}; GPT-2 {json.dumps(gpt2_launches)}")
    log(f"[main path] BART (parity, speed, CLIs, beam, head) {json.dumps(bart_launches)}; "
        f"mBART (speed, parity, CLI, beam) {json.dumps(mbart_launches)}; LSTM / conv models "
        f"{json.dumps(rnn_conv_launches)}")
    log(f"[main path] fconv (CLIs) {json.dumps(fconv_launches)}; adaptive LM "
        f"{json.dumps(adaptive_lm_launches)}; transformer_align (parity, speed, CLIs) "
        f"{json.dumps(align_launches)}; NAT (parity, decodes, CMLM speed) "
        f"{json.dumps(nat_launches)}")
    log(f"[main path] MT (parity, speed, CLIs, beam) {json.dumps(mt_launches)}; transformer_ctc "
        f"(parity, speed) {json.dumps(mt_ctc_launches)}; Berard {json.dumps(berard_launches)}; "
        f"Emformer (parity) {json.dumps(emformer_launches)}; wav2vec v1 "
        f"{json.dumps(w2v1_launches)}")
    log(f"[main path] wav2vec2_base pretraining (parity, speed, CLI) "
        f"{json.dumps(w2v_pretrain_launches)}; w2v2.yaml (decode, hub, parity) "
        f"{json.dumps(w2v_st_launches)}; wav2vec_ctc (parity, greedy) "
        f"{json.dumps(w2v_ctc_launches)}; dual and multibranch (parity, speed, encode) "
        f"{json.dumps(league_launches)}; quant noise and multilingual (CLI) "
        f"{json.dumps(item15_launches)}")
    log(f"[main path] the rest of the CTC research stack: CTC-Aug (serving, parity, speed) "
        f"{json.dumps(ctc_aug_launches)}; nast_pds_big and ctc_aug_pds_big (serving, parity) "
        f"{json.dumps(nast_pds_launches)}; PDS stage taps (parity) and Jacobi "
        f"{json.dumps(pds_taps_launches)}")
    log(f"[main path] the CTC research stack: s2t_nast (serving, parity, speed) "
        f"{json.dumps(nast_stack_launches)}; BiL-CTC (parity, speed, serving) "
        f"{json.dumps(bil_ctc_launches)}; AIPA (parity, speed, CLI, generate, hub) "
        f"{json.dumps(aipa_launches)}")
    log(f"[main path] raw-audio training (2 runs): {json.dumps(audio_launches)}; generate: "
        f"{json.dumps(gen_launches)}; NAST serving: {json.dumps(nast_launches)}; CTC training, "
        f"generate and hub: {json.dumps(ctc_launches)}; wer_sanity: {json.dumps(sanity_launches)}"
        f"; PDS training (parity, speed, CLI): {json.dumps(pds_train_launches)}; SATE training "
        f"(parity, speed, CLI, generate, hub): {json.dumps(sate_train_launches)}; Conformer "
        f"(serving, CTC parity, CLI, CTC serving): {json.dumps(conformer_launches)}")

    fused_attention.launches = 0
    pds_encodes, pds_speed = phase_pds_serve()
    mark("phase_pds_serve")
    pds_serve_launches = fused_attention.launches
    if pds_serve_launches != 12 * pds_encodes:
        raise AssertionError(f"PDS serving launched the attention kernel {pds_serve_launches} "
                             f"times for {pds_encodes} encodes, expected {12 * pds_encodes}")
    from s2t_tpu_torch.models.s2t_ctc import s2t_ctc_pds

    pds_ctc, pds_ctc_launches = phase_nast(s2t_ctc_pds, fields(GROWTH360_MODEL), "pds ctc")
    mark("phase_nast")
    log(f"[main path] PDS serving: attention_fwd launches {pds_serve_launches} over "
        f"{pds_encodes} encodes (12 per encode); PDS CTC serving: {json.dumps(pds_ctc_launches)} "
        f"(16 per encode)")
    sate_serve, sate_serve_launches = phase_sate_serve()
    mark("phase_sate_serve")
    log(f"[main path] SATE serving: attention_fwd launches {sate_serve_launches} (18 per encode)")
    path_launches = {k: train_launches.get(k, 0) + sum(run[k] for run in (
        audio_launches, gen_launches, nast_launches, ctc_launches, sanity_launches,
        pds_train_launches, pds_ctc_launches, sate_train_launches, conformer_launches,
        nast_stack_launches, bil_ctc_launches, aipa_launches, ctc_aug_launches,
        nast_pds_launches, pds_taps_launches, variant_launches, efficient_launches,
        generator_launches, w2v_pretrain_launches, w2v_st_launches, w2v_ctc_launches,
        league_launches, item15_launches, mt_launches, mt_ctc_launches, berard_launches,
        emformer_launches, w2v1_launches, fconv_launches, adaptive_lm_launches, align_launches,
        nat_launches, bart_launches, mbart_launches, rnn_conv_launches, multilingual_launches,
        roberta_launches, gpt2_launches, bt_launches, latency_launches, optim_launches,
        parallel_launches, item16_launches))
        for k in counters()}
    path_launches["attention_fwd"] += serve_launches + pds_serve_launches + sate_serve_launches

    ctc_main = ctc_cases[0]
    kernels = [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "s2t_tpu/ops/attention_pallas.py:100",
        "launches": path_launches["attention_fwd"],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "device_ms": main_shape["device_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "library_device_ms": main_shape["library_device_ms"],
    }, {
        "name": "attention_bwd",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "s2t_tpu/ops/attention_pallas.py:116",
        "launches": path_launches["attention_bwd"],
        "max_abs_err": grad_main["grad_max_abs_err"],
        "ms": grad_main["ms"],
        "device_ms": grad_main["device_ms"],
        "plain_ms": grad_main["plain_ms"],
        "bound_ms": grad_main["bound_ms"],
        "bound_by": grad_main["bound_by"],
        "library_ms": grad_main["library_ms"],  # its backward at p = 0; K1b at p = 0 in the JSON
        "library_device_ms": grad_main["library_device_ms"],
    }, {
        "name": "ctc_alpha",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "s2t_tpu/ops/ctc_pallas.py:59",
        "launches": path_launches["ctc_alpha"],
        "max_abs_err": ctc_main["alpha_err"],
        "ms": ctc_main["alpha_ms"],
        "device_ms": ctc_main["alpha_device_ms"],
        "plain_ms": ctc_main["alpha_plain_ms"],
        "bound_ms": ctc_main["alpha_bound_ms"],
        "bound_by": ctc_main["alpha_bound_by"],
        "library_ms": ctc_main["library_fwd_ms"],
        "library_device_ms": ctc_main["library_fwd_device_ms"],
    }, {
        "name": "ctc_beta_grad",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/ctc_lattice.cu",
        "replaces": "s2t_tpu/ops/ctc_pallas.py:82",
        "launches": path_launches["ctc_beta_grad"],
        "max_abs_err": ctc_main["demit_err"],
        "ms": ctc_main["beta_ms"],
        "device_ms": ctc_main["beta_device_ms"],
        "plain_ms": ctc_main["beta_plain_ms"],
        "bound_ms": ctc_main["beta_bound_ms"],
        "bound_by": ctc_main["beta_bound_by"],
        "library_ms": ctc_main["library_bwd_ms"],
        "library_device_ms": ctc_main["library_bwd_device_ms"],
    }, {
        "name": "fbank",
        "route": "cuda",
        "source": "s2t_tpu_torch/csrc/fbank.cu",
        "replaces": "s2t_tpu/ops/fbank_pallas.py:64",
        "launches": path_launches["fbank"],
        "max_abs_err": fbank_main["max_abs_err"],
        "ms": fbank_main["ms"],
        "device_ms": fbank_main["device_ms"],
        "plain_ms": fbank_main["plain_ms"],
        "bound_ms": fbank_main["bound_ms"],
        "bound_by": fbank_main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the Kaldi fbank
        "library_device_ms": None,
    }]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "kernels": kernels, "sass": sass, "kernel_cases": cases, "serving_shape": main_shape,
            "grad_cases": grad_cases, "kept_share": kept_share, "training_shape": grad_main,
            "serving_shape_by_head_dim": fwd_by_dim, "training_shape_by_head_dim": bwd_by_dim,
            "ctc_cases": ctc_cases, "speed": speed, "train_parity": parity,
            "train_speed": train_speed, "train_launches": train_launches, "fbank": fbank_main,
            "train_audio": audio, "generate": generate, "nast": nast, "train_ctc": train_ctc,
            "wer_sanity": sanity, "pds_stage0_serving_shape": fwd_pds0,
            "pds_stage0_training_shape": bwd_pds0, "pds_serve": pds_speed, "pds_ctc": pds_ctc,
            "pds_train": pds_train, "sate_serve": sate_serve, "sate_train": sate_train,
            "conformer": conformer, "nast_stack": nast_stack, "bil_ctc": bil_ctc, "aipa": aipa,
            "ctc_aug": ctc_aug, "nast_pds_big": nast_pds, "pds_taps": pds_taps,
            "variants": variants, "efficient_conformer": efficient, "generator": generator,
            "w2v2_pretrain": w2v_pretrain, "w2v2_st": w2v_st, "w2v_ctc": w2v_ctc,
            "league": league, "item15": item15, "w2v2_attention_shape": w2v_attention,
            "mt_kernel_shapes": mt_kernels, "mt": mt, "mt_ctc": mt_ctc, "berard": berard,
            "emformer": emformer, "w2v1": w2v1, "fconv": fconv, "adaptive_lm": adaptive_lm,
            "align": align, "nat": nat, "bart": bart, "mbart": mbart, "rnn_conv": rnn_conv,
            "multilingual": multilingual, "roberta": roberta, "gpt2": gpt2, "bt": bt,
            "latency": latency, "optim": optim, "parallel": parallel, "item16": item16,
            "path_launches": path_launches, "phase_s": phase_s,
            "nvidia_smi": smi.stdout.strip(), "wall_s": time.perf_counter() - t_start},
            indent=1))
    wall = time.perf_counter() - t_start
    slowest = sorted(phase_s.items(), key=lambda kv: -kv[1])[:10]
    print(f"[slowest phases] {json.dumps({k: round(v, 1) for k, v in slowest})}; phases 1-54 "
          f"{sum(v for k, v in phase_s.items() if k not in NEW_PHASES):.1f} s, 55-56 "
          f"{sum(phase_s.get(k, 0.0) for k in NEW_PHASES):.1f} s, total {wall:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
