#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--steps N] [--seed S] [--profile OUT.json] [--parent DIR]

Phases, each printing one JSON line:
  1. build   -- builds every CUDA kernel of the port from saspa_tpu_torch/csrc
                (one nvcc per source, in parallel) and reports the registers
                and spills (ptxas) of K1's, K2's, K5's and K6's wgmma kernels
                and K3's two kernels, requiring no spills;
  2. kernels -- each kernel against its plain PyTorch version on the card at
                every main-path shape, from the same seeded bf16 inputs, with
                kernel / plain / library times from CUDA events (K1's and K6's
                rows also carry kernel / library and bound / kernel; K2's,
                K3's, K4's and K5's rows also the kernels' own device time
                from torch.profiler (device_ms; K2's by stage, K3's by launch,
                K5's by phase; from CUDA events, without the breakdown, where
                the profiler records no device time, counted in the kernels
                line as device_ms_from_events; K3's and K4's rows carry that
                events time beside it always, as queued_ms), the wrapper's host
                microseconds a call, and their yardsticks' device time:
                F.layer_norm for K4,
                F.group_norm for K3 without act, cuBLAS's two products for K2,
                route (a) for K5 (three cuBLAS projections, K1, the out
                projection and the residual add: route_a_ms); the bound
                of K1, K5 and K6 counts one exp2 a score on the special-
                function units at the card's maximum SM clock).  K1/K2 shapes
                are listed below; the GroupNorm (K3), LayerNorm (K4) and
                self-attention block (K5) shapes are recorded by forward hooks
                during the main path's warm-up, and K3's and K4's also during
                one step at 1024^2 (the gen phase's shapes, among them the
                VAE's 2^31-element GroupNorm).  Tolerances: K1, K2 within 1%
                of the largest output; K3, K4 in bf16 ulps per element
                (require_ulps); K5 within 1% of the largest attention-plus-
                projection term (the output less residual and bias).  K1, K5
                and K6 take q of 3x the unit scale, which peaks each query's
                softmax on a few keys;
  3. main    -- the port's main path: DiffusionPipeline(sd_v1.5, canny, ddim,
                bf16) at full SD1.5 width with seeded weights, batch 8 at
                512^2, through make_fused_generate, in the default kernel
                configuration and in the opt-in one (pallas_group_norm=True,
                attention_megakernel=True); launch counters prove that every
                eligible site ran its kernel;
  4. reference -- both configurations' output against one CPU f32 run of
                the plain path on a small input, and the card's Canny against
                the CPU's, bit for bit;
  5. gen     -- the entry point at 1024^2:  saspa_tpu_torch.cli gen --dataset
                planes --resolution 1024 --skip_filter  on a synthetic
                FGVC-Aircraft tree of 8 seeded 1024x1024 sources (PNG bytes
                under .jpg names, so resizing is the identity), in-process:
                full-width SD1.5 + canny ControlNet, DDIM, CFG 7.5, scale
                0.75, batch 8.  Its launch counts prove that every level-0
                self-attention (16384 tokens, past K1's guard) ran K6; the 8
                PNGs must equal, bit for bit, the fused function's output for
                the same prompts, sources and noise.
  6. filter  -- the filter stage on a synthetic tree of 8 sources in 4
                classes at 512^2:  cli gen  without --skip_filter (two
                batches of 8; launch counts of a 512^2 run) writes the
                recipe's aug-JSON (CLIP RN50 semantic filter, WSDAN-CAL
                ResNet-101 top-10 confidence filter, seeded weights at full
                published widths, batch 64, bf16), which  cli filter  must
                rebuild byte for byte with its log beside it; then  cli
                filter --conf_top_k 2,  --clip_filtering per_class, and
                cli merge-jsons  of those two.  The filter runs none of
                K1-K6.  Four augs scored on the card and through the port in
                f32 on the CPU (same weights, moved by state_dict): CLIP
                image features at cosine >= 0.99, CAL logits within 2% of
                the largest |logit|; every keep decision of the three JSONs
                equals the card's own scores', and the CPU's except where
                the CPU's margin lies within the measured score gap
                (counted and printed); features and logits also at
                cosine >= 0.99 with each side's batch mean taken off.  The
                same weights with every BatchNorm's statistics taken from
                the 16 augs, on the card in f32 (filter_agreement): there
                the card's features and logits must spread over the augs
                by 10x the card-CPU gap, and pass the same cosines.  Then
                256 synthetic 512^2 PNG augs
                through  cli filter  at batch 64: augs/s, host preprocess
                and device seconds apart, peak memory (filter_throughput).
  7. train   -- the train stage on a synthetic FGVC-Aircraft tree of 100
                classes (64 / 16 / 16 seeded sources of about 1000 x 700,
                PNG bytes under .jpg names; an aug-JSON of 2 seeded 512^2
                PNG augs a train image):  cli train --dataset planes
                --aug_json ... --aug_sample_ratio 0.4 --limit_aug_per_image 2
                --special_aug classic --epochs 1 --seed 1  in-process, the
                planes preset at full width (WSDAN-CAL ResNet-101, layer4 at
                stride 1, M 32, 224^2, batch 4, bf16, seeded weights): 16
                steps, validation and test, a checkpoint whose reload
                (--ckpt) gives the same test metrics; the AugSampler's
                substitutions equal a host replay; the launch counters of
                K1-K6 stay 0.  The transforms and attention crop/drop on the
                card equal the CPU's (train_draws).  Three steps of one
                seeded model on the card and through the port on the CPU,
                same batches and injected draws: in f64 the loss within 1e-6,
                running statistics within 1e-4 (norm), feature centers and
                fc's update at cosine >= 0.9999; in f32 (TF32 off), every
                step, the loss within 1e-2, feature centers at cosine >=
                0.99, fc's update at cosine >= 0.98, running statistics
                within 0.1 at the first step and 0.5 after: the seeded net's
                train-mode BatchNorms (fast variance) amplify f32 rounding
                (train_card_vs_cpu).  Ten bf16 steps on one batch lower the
                loss.  Then the input pipeline feeding the step at batch 4
                and 16: s/step, img/s, the host's input wait and load
                seconds, its dispatch seconds and its wait for the card at
                the end, the stream synchronizations in one batch and step
                (required 0), the card's idle share and kernels a step over
                2 profiled steps, peak memory (train_throughput).
  8. blip    -- BLIP-Diffusion + canny ControlNet, the default model of
                every dataset but planes:  cli gen --dataset dtd
                --skip_filter --num_per_image 1 --resolution 512
                --num_inference_steps 30  in-process on a synthetic DTD tree of 8 seeded 512^2
                sources in 4 classes (PNG bytes under .jpg names, named as
                the shipped DTD captions' keys), one batch of 8: CLIP
                ViT-L/14 and the Q-Former (full published widths, seeded)
                once, then the SD1.5 denoise, DDIM 30 steps, CFG 7.5, scale
                0.75, bf16.  K1-K4 launch at one 512^2 main-path batch's
                counts and K5/K6 not at all (the towers run none of them);
                the 8 _subject_ files equal a host replay of the subject
                choice, the resize and the uint8 truncation; the 8 PNGs equal
                the fused function's output bit for bit.  Printed: wall s,
                img/s, s/step, the towers' CUDA-event ms a batch and their
                own device ms and kernel count (torch.profiler), the idle
                share of one profiled batch.  Card bf16 against the port on
                the CPU in f32 (same weights): subject embeddings and the
                spliced text tower's hidden states on the references of two
                classes at row cosine >= 0.99, and >= 0.99 with each side's
                mean over the two taken off; the fused path at 256^2, 2
                steps, within mean |diff| <= 0.02 as in phase 4.
  9. train_recipes -- the paper's best train recipes (saspa_tpu/gen/recipes.py:
                17-23) through  cli train --epochs 1:  --dataset dtd
                --special_aug classic-cutmix --aug_json ... --aug_sample_ratio
                0.4 --limit_aug_per_image 2  on a synthetic 47-class DTD tree
                (64 / 32 / 32 seeded 400^2 PNG sources, 2 augs a train image;
                WSDAN-CAL ResNet-101, M 32, 224^2, batch 16), and  --dataset
                compcars-parts --special_aug randaug-cutmix
                --train_sample_ratio 0.01  on the shipped csv splits' every
                path (hard links to 8 seeded 48^2 PNGs; ResNet-50, batch 8):
                4 steps each, validation, test, a checkpoint, K1-K6 at 0
                launches.  The randaug, autoaug and classic transforms and
                cutmix_batch on the card against the CPU from one key (within
                1e-6, the CPU tests' bound against JAX; CutMix's images and
                soft labels equal), with their host and device ms a batch of
                16; three f64 soft-label steps, card against CPU, within the
                train phase's f64 bounds; then the input pipeline feeding the
                step at each preset: s/step, img/s over 10 steps, stream
                syncs of a batch and step (required 0), peak memory.
 10. xl     -- SDXL-Turbo + canny ControlNet-XL, cub's default recipe:  cli
                gen --dataset cub --skip_filter --num_per_image 1  in-process
                on a synthetic CUB-200-2011 tree of 8 seeded 512^2 sources
                in 4 classes (PNG bytes under .jpg names outside the val
                carve-out), one batch of 8.  The recipe must resolve to
                sd_xl-turbo + canny, 2 trailing DDIM steps (999, 499),
                guidance 0, no negative prompt; full published widths
                (UNet 320/640/1280, depth 1/2/10, heads of d 64;
                ControlNet-XL; CLIP ViT-L and OpenCLIP bigG towers; the VAE;
                about 4.5 B parameters), seeded, bf16.  Launch counts as
                expected_xl_counts; the 8 PNGs equal the fused function's
                output bit for bit.  The K3, K4 and K5 sites of one hooked
                XL step that the kernels phase did not check are checked
                there (rows with "cell": "xl").  Card bf16 against the port
                on the CPU in f32 (same weights): both towers on one prompt
                (hidden states at row cosine >= 0.99, pooled >= 0.99) and
                one UNet + ControlNet-XL step at B1 on the same inputs (eps
                cosine >= 0.99).  Then sd_xl + canny (init_pipeline's
                "sd_xl") under CFG 7.5 at 2 of its 30 steps: every
                self-attention at B16, launch counts as the turbo batch's.
                Printed: init s, wall s, img/s, s/step (the time of 4 more
                steps, over 4), the towers' ms and device ms, the profiled
                batch's device time by kernel and idle share, peak memory
                and what earlier phases still held.
 11. weights -- the public checkpoint files through --weights_dir: a tree
                in tools/weights_day.py's --src_dir layout written from
                tools/synth_checkpoints.py's key layouts with seeded values
                at full published width (SD1.5's UNet, VAE and text tower
                and the canny ControlNet as F16 safetensors, OpenAI's
                RN50.pt as a TorchScript archive, lpips' alex .pth, the
                released WSDAN-CAL ResNet-101 .pth of planes with
                feature_center under checkpoints/planes/; 1.55 G values,
                3.5 GB), then  cli gen --dataset planes --skip_filter
                --weights_dir TREE  at 512^2 (one batch of 8, 2 steps),
                cli filter --weights_dir TREE --lpips_min 1e-06
                --lpips_max 1000  (semantic and top-10 confidence filters;
                the planes split widened to the baseline's 100 classes),
                and  cli train --ckpt <the CAL .pth>  for 2 steps.  Every
                model loads strictly (every key of its file taken, every
                parameter from the file), its element count and f64 sum
                equal the file's, its state after the load the file's values
                rounded to its dtypes (1e-6); K1-K4 at (a)'s counts for the
                steps run, K5/K6 0; the PNGs equal the fused output; card
                bf16 vs the port on the CPU in f32 loaded from the same tree
                (256^2, 2 steps, mean |diff| <= 0.02); LPIPS on the card
                within 2% of the CPU's; the aug-JSON's log lists both LPIPS
                counters; train --ckpt restores every parameter and the
                feature centers.  Printed: the tree's seconds and bytes,
                each file's load seconds and GB/s, the host's peak RSS
                during gen's load, gen's img/s with and without the load,
                LPIPS pairs/s (64 pairs, batch 64).
 12. sdedit -- the generation families of the VAE encoder, in-process on
                synthetic trees of 8 seeded 512^2 sources (full published
                widths, seeded bf16 weights, batch 8, --num_per_image 1):
                cli gen --preset real_guidance --dataset cars  (a Stanford
                Cars tree with the devkit's .mat files: SD1.5 SDEdit at
                strength 0.15 of 50 steps, 7 run, txt2sentence prompts, CFG
                7.5, no ControlNet; the CLIP per-class aug-JSON),  cli gen
                --preset alia --dataset planes  (SDEdit 0.5 of 30 steps, 15
                run, ALIA's prompts; the semantic + ALIA-confidence aug-JSON,
                thresholds from the seeded WSDAN-CAL),  cli gen --dataset
                planes --sdedit --sdedit_strength 0.5 --num_inference_steps 4
                --skip_filter  (SDEdit with the canny ControlNet, 2 steps run),
                cli gen --preset alia --dataset cub  (SDXL-Turbo + SDEdit: 1
                trailing step from t = 499, guidance 0; on a synthetic CUB
                tree), and  cli gen --dataset dtd --base_model
                blip_diffusion-edit --skip_filter  (49 DDIM inversion calls up
                50 steps, then 30 CFG steps under the subject embeddings).
                Launch counts as expected_sdedit_counts; the PNGs equal
                pipe.generate's / pipe.edit's output for the same prompts,
                sources and noise bit for bit; the _subject_ files a host
                replay.  K1 at the encoder's mid attention on the
                encoder's own activations, and the encoder's K3 sites the
                kernels phase did not check (rows with "cell": "sdedit").
                Card bf16 against the port on the CPU in f32 (same
                weights): the encoder's mean on one 256^2 source at cosine
                >= 0.99, and one SDEdit batch there (2 denoise steps) within
                mean |diff| <= 0.02.  Printed: each run's wall s, img/s and
                peak memory, s/step (15 steps against 7), the encode's ms by
                CUDA events and its device ms (torch.profiler), the idle
                share of one profiled Real-Guidance batch, the inversion's
                s/call.
 13. planes_biased -- the contextual-bias path and the soft-CE teacher, in
                its own temporary root, on a synthetic FGVC-Aircraft tree
                with a PNG (under its .jpg name) for every row of the
                planes_biased split csv (409 train, 715 val, 707 test; the
                first 8 train rows' at 512^2, the rest 64^2):  cli gen
                --preset alia --dataset planes_biased --weights_dir TREE
                --max_items 8  (InstructPix2Pix from seeded F16 safetensors
                of its unet/vae/text_encoder at full SD1.5 width, the UNet's
                conv_in 8 channels; one batch: 100 DDIM steps of 3-way
                guidance, text 7.5 and image 1.3, the UNet at B24; then the
                semantic + ALIA-confidence aug-JSON).  Launch counts as
                expected_sdedit_counts(100) (K1 1502, K2 1600, K3 6152 calls,
                K4 3200); every file loads strictly; the PNGs equal
                pipe.generate's for the same prompts, sources and noise bit
                for bit; the ip2p UNet's K3 and K4 sites at B24 that earlier
                phases did not check (rows with "cell": "ip2p"; K1's and
                K2's B24 shapes are in the kernels phase's lists).  Then
                cli filter  with ALIA's recipe rebuilds the aug-JSON byte for
                byte,  cli train --dataset planes_biased  runs 4 steps at
                batch 4 on it,  cli train --dataset planes
                --use_target_soft_cross_entropy  4 steps with the CLIP RN50
                teacher's logits (finite loss; the planes split of the same
                images, 2 variants), each saving a checkpoint, and  cli
                eval-biased --ckpt_folder  scores both on the whole test
                split (n_id 552, n_ood 155).  Printed: gen's wall s
                and img/s, generate's s/step at B24, each run's seconds,
                eval-biased's accuracies, the phase's seconds.
 14. unipc  -- the main path's batch (SD1.5 + canny, B8, 512^2, full width,
                the default kernels) with the sampler set to UniPC
                (--sampler unipcmultistep: bh2, order 2, on the multistep
                grid), the main path's seeded weights: K1-K6 launch as DDIM's
                at the same steps; the fused function's uint8 images equal
                `generate`'s on the same ids, noise and control image, bit
                for bit.  Printed: s/step beside DDIM's from the same call.
 15. jpeg   -- JPEG sources without PIL: every tests/fixtures/jpeg/*.jpg
                (written by PIL: baseline, progressive, restart markers,
                optimised tables, grey, 4:2:0 / 4:2:2 / 4:4:4, 1x1 to
                1000x667) decoded by gen/jpeg.py bit-equal to PIL's pixels in
                the .pil.png beside it (read with read_png: there is no PIL on
                this machine); decode ms a JPEG at 512^2 (baseline and
                progressive) and 1000x667 beside read_png of the same pixels,
                and with the train pipeline's 8 threads.  Then a synthetic
                FGVC-Aircraft tree whose sources are those JPEG bytes (train:
                8 copies of the 512^2 baseline and progressive files; val and
                test: 8 files of other sizes and kinds):  cli gen --dataset
                planes --num_inference_steps 2  (the default recipe: SD1.5 +
                canny, then the semantic and top-10 confidence filters' aug-
                JSON; K1-K4 at (a)'s counts for 2 steps),  cli filter
                rebuilding that JSON byte for byte, and  cli train --epochs 1
                on it (2 steps at batch 4, validation and test): every source
                and every val and test original read through decode_jpeg.
 16. refiner -- the SDXL refiner:  cli gen --dataset planes --base_model sd_xl
                --sdedit --sdedit_strength 0.5 --controlnet none
                --num_inference_steps 4 --skip_filter  in-process on 8 seeded
                512^2 sources (init_pipeline maps sd_xl + SDEdit without a
                ControlNet to the refiner, as the JAX package does: UNet
                384/768/1536/1536, depth 4, heads of d 64, the bigG tower
                alone, the SDXL VAE; about 3 B seeded bf16 parameters); 2
                denoise steps under CFG 7.5 at B16 with the aesthetic score
                6.0 / 2.5 in the time ids.  Launch counts as
                expected_sdedit_counts(2, refiner=True); the PNGs equal
                `generate`'s bit for bit; its self-attention sites the
                expected three; its K1 (H12 L1024, H24 L256) and K2 (C768,
                C1536) shapes are in the kernels phase's lists, its K3
                (C384, 12 channels a group) and K4 sites no earlier phase
                checked are checked here (rows with "cell": "refiner").
                Printed: init s, wall s, s/step, peak memory.
 17. sd21   -- SD2.1 + canny:  cli gen --dataset planes --base_model sd_v2.1
                --skip_filter --num_inference_steps 2  in-process on 8 seeded
                512^2 sources (UNet 865,910,724 parameters, heads of d 64 at
                5/10/20/20, context 1024, linear projections; OpenCLIP-H's
                23-layer tower; seeded bf16): launch counts as one main-path
                batch's at 2 steps (43 / 46 / 206 / 92: the levels hold
                SD1.5's transformers, the mid block's 64 tokens run plain);
                the PNGs equal the fused function's and generate's output
                bit for bit.  K1's four SD2.1 shapes (H5 L4096 before and
                after the CFG fork, H10 L1024, H20 L256) are in the kernels
                phase's list.  Printed: init s, wall s, s/step, the
                parameter counts.
 18. hed    -- the HED ControlNet:  cli gen --dataset planes --controlnet hed
                --skip_filter  (SD1.5, the fused path, HED inside it),  the
                same with  --sdedit --sdedit_strength 0.5
                --num_inference_steps 4  (generate, 2 denoise steps), and
                cli gen --dataset dtd --controlnet hed  (BLIP-Diffusion), 2
                steps each on 8 seeded 512^2 sources: HED adds no kernel
                launch (counts as canny's); the SD1.5 and SDEdit PNGs equal
                the fused function's and generate's bit for bit.  HED's
                CUDA-event and device ms at B8 512^2, and the card's bf16 HED
                against an f32 CPU run of the same weights on 2 sources at
                256^2, calibrated on them (the seeded edge map saturates at
                0): mean |diff| <= 0.01 of the [0, 1] edge map, whose spread
                (std) must reach 0.05.
 19. xl_vae_f32 -- SASPA_XL_VAE_FP32=1:  cli gen --dataset cub --skip_filter
                (SDXL-Turbo + ControlNet-XL, the decode in f32) and  cli gen
                --preset alia --dataset cub  (SDEdit, the encode and the
                decode in f32; then the preset's semantic and ALIA-confidence
                filters, seeded, in the phase's temporary root): the f32 K1
                and K3 launches
                counted apart from the bf16 ones (1 and 30 a decode, 1 and 22
                an encode); the PNGs equal the fused function's and
                generate's bit for bit.  K1 in f32 at both mid attentions on
                their own activations (1e-4 of the largest output), K3 in
                f32 at every GroupNorm site of one encode and decode, both
                epilogues (2e-5 of the largest output), with times, bounds
                (f32 at 67 TFLOP/s) and SDPA / F.group_norm in f32 beside
                them; the PNGs' mean |f32 - bf16| in uint8 levels against the
                same latents through the bf16 VAE of the same weights.
 20. captions -- the prompt and caption tools, in-process from a temporary
                root:  cli prep-captions --dataset planes  over 8 sources (4
                seeded PNGs of 300-900 px a side, 4 of tests/fixtures/jpeg's
                JPEGs) with two --questions, and  cli prep-prompts
                --dataset planes --num 16, on full-width seeded public
                files written to a --weights_dir tree: LAVIS's BLIP caption
                and VQA .pth (tools/synth_checkpoints.py's layouts, norm
                weights near 1), the keytotext T5's pytorch_model.bin and a
                30522-line vocab.txt; everything in f32.  Gates: the load
                reports (every key taken, element counts and f64 sums equal
                to the files'), the captions JSON's and the LE JSON's
                schemas, the first-step logits of the captioner, the VQA
                decoder and the T5 on the card against the port's CPU f32
                within 1e-4 of the largest logit, and the ids (greedy
                captions of a PNG and a JPEG, greedy answers to both
                questions, sampled T5 sentences of 2 prompts under one key)
                equal to the CPU's up to the first step whose CPU top-2
                margin is below 1e-3 (reported); K1-K6 launch 0 times.
                The decode loops replay from CUDA graphs; a caption and a
                greedy T5 decode launched eagerly give the same ids.
                Printed: write, load s and GB/s, captions/s, answers/s,
                sentences/s, s a decode step (graphed and eager), the
                host's noise draw a T5 call, peak memory.
 21. backbones -- the Inception-v3 and CBAM backbones of WS-DAN/CAL and CLIP
                ViT-B/16, in-process from a temporary root on phase 7's
                tree:  cli train --net inception_mixed_6e  (the planes
                recipe, batch 4 at 224^2, M 32, bf16, one epoch: 16 steps,
                validation, test, checkpoint; with --plot_per_class_acc
                where matplotlib is installed, which must write the val and
                test PNGs, else that flag must fail before the first step
                with an error naming matplotlib);  cli train --ckpt  from
                seeded reference-layout WSDAN-CAL .pth files of mixed_6e
                and mixed_7c (torchvision's Inception layout under the
                reference Sequential's index names, 100 classes, with
                feature_center), 2 steps each, every key read but 7c's
                attention head (reported skipped), and  --net resnet50_cbam
                for 2 steps;  cli filter --alia_conf_filtering  with the 6e
                file as the planes baseline (--weights_dir) on a train
                split of 100 variants; s/step fed by the input pipeline for
                6e at batch 4 (profiled: idle share) and 16, 7c and
                resnet50_cbam at 4, with peak memory; one f32 step of each
                net card vs CPU (the train phase's f32 bounds) and one f64
                step of each Inception net (its f64 bounds); and
                CLIPScorer("vit-b-16") (seeded) on 4 images, card bf16 vs
                CPU f32 (cosines >= 0.99).  K1-K6 launch 0 times.
The kernels phase also holds K6 (streamed flash attention on unpadded heads)
against its plain version at the 1024^2 level-0 shapes and a capped
960x1280 bucket.
With --parent DIR, the kernels phase also times another checkout's K3 and
K5 (its own wrappers and kernels, built from DIR) on the same inputs
(parent_ms, parent_device_ms, parent_host_us).
With --profile, one more main-path run of each configuration under
torch.profiler writes the device time by kernel to OUT.json and
OUT_opt_in.json, one 1024^2 batch to OUT_gen_1024.json and the filter's
scoring of its 256 augs to OUT_filter.json, the train phase's 2
profiled steps at batch 4 and 16 to OUT_train.json and OUT_train_b16.json,
the blip phase's profiled batch to OUT_blip.json, the xl phase's to
OUT_xl.json and the sdedit phase's Real-Guidance batch to OUT_sdedit.json,
and prints a summary line each.
Then the kernels line, the card's name and power limit (nvidia-smi) and, as
the last line, {"ok": true, "device": {...}}.  Any failure exits non-zero
before the last line.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM at 700 W
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores (norm arithmetic)
H100_HBM_BYTES = 3.35e12  # HBM3 bytes/s
EXP_PER_CLOCK = 16  # exp2 results a clock per SM on the special-function unit (compute capability 9.0)
SM_CLOCK_HZ = 1.98e9  # replaced in main() by the card's clocks.max.sm (nvidia-smi)

# K1 shapes on the main path at 512^2 and the gen path at 1024^2: (what, B, L, H, d, d_pad)
K1_SHAPES = [
    ("unet/cn level 0, before the CFG fork", 8, 4096, 8, 40, 64),
    ("unet/cn level 0", 16, 4096, 8, 40, 64),
    ("unet/cn level 1", 16, 1024, 8, 80, 128),
    ("unet/cn level 2", 16, 256, 8, 160, 192),
    ("vae mid attention", 8, 4096, 1, 512, 512),
    ("1024^2 level 1", 16, 4096, 8, 80, 128),  # the gen phase's K1 sites (its mid block is level 2's shape)
    ("1024^2 level 2", 16, 1024, 8, 160, 192),
    # the xl phase's: SDXL at 512^2, heads of d 64 (no padding); sd_xl-turbo
    # at B8, sd_xl's CFG at B16 (XL has no shared prefix)
    ("xl level 1", 8, 1024, 10, 64, 64),
    ("xl level 2 and mid", 8, 256, 20, 64, 64),
    ("xl CFG level 1", 16, 1024, 10, 64, 64),
    ("xl CFG level 2 and mid", 16, 256, 20, 64, 64),
    # the planes_biased phase's: ip2p's 3-way guidance runs the UNet at B24 (no shared prefix)
    ("ip2p level 0", 24, 4096, 8, 40, 64),
    ("ip2p level 1", 24, 1024, 8, 80, 128),
    ("ip2p level 2", 24, 256, 8, 160, 192),
    # the refiner phase's: the SDXL refiner's UNet under CFG at B16 (no
    # shared prefix), heads of d 64; its mid block (64 tokens) runs plain
    ("refiner level 1", 16, 1024, 12, 64, 64),
    ("refiner level 2", 16, 256, 24, 64, 64),
    # the sd21 phase's: SD2.1's UNet and ControlNet at 512^2, heads of d 64
    # (5/10/20); level 0 runs before the CFG fork at B8 (its mid block's 64
    # tokens run plain)
    ("sd21 level 0, before the CFG fork", 8, 4096, 5, 64, 64),
    ("sd21 level 0", 16, 4096, 5, 64, 64),
    ("sd21 level 1", 16, 1024, 10, 64, 64),
    ("sd21 level 2", 16, 256, 20, 64, 64),
]
# K6 shapes: (what, B, L, H, d); d pads to 64 in shared memory
K6_SHAPES = [
    ("1024^2 level 0, before the CFG fork", 8, 16384, 8, 40),
    ("1024^2 level 0", 16, 16384, 8, 40),
    ("capped 960x1280 bucket, level 0", 16, 19200, 8, 40),
]
GEN_RESOLUTION = 1024
# K2 shapes: (what, B, L, C); F = 4C; levels at 512^2, then at 1024^2 (its mid
# block is level 2's shape at 512^2)
K2_SHAPES = [
    ("level 0", 16, 4096, 320),
    ("level 1", 16, 1024, 640),
    ("level 2", 16, 256, 1280),
    ("mid", 16, 64, 1280),
    ("1024^2 level 0", 16, 16384, 320),
    ("1024^2 level 1", 16, 4096, 640),
    ("1024^2 level 2", 16, 1024, 1280),
    ("xl level 1", 8, 1024, 640),  # sd_xl-turbo at 512^2; sd_xl's CFG B16 shapes are levels 1 and 2 above
    ("xl level 2 and mid", 8, 256, 1280),
    ("ip2p level 0", 24, 4096, 320),  # the planes_biased phase's UNet at B24
    ("ip2p level 1", 24, 1024, 640),
    ("ip2p level 2", 24, 256, 1280),
    ("ip2p mid", 24, 64, 1280),
    ("refiner level 1", 16, 1024, 768),  # the refiner's UNet at B16: 64-column down tiles (768, 1536 % 160 != 0)
    ("refiner level 2", 16, 256, 1536),
    ("refiner mid", 16, 64, 1536),
]


class SmokeFailure(RuntimeError):
    pass


def require(ok, *what) -> None:
    """A check that holds under python -O too."""
    if not ok:
        raise SmokeFailure(" ".join(str(w) for w in what))


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; t_s is the seconds since the script started."""
    print(json.dumps({**obj, "t_s": time.perf_counter() - T0}), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILER_MISSES = []  # device_ms calls whose profiles held no device record


def queued_ms(fn, iters: int) -> float:
    """Device ms per call of fn from CUDA events, with the calls queued
    behind a spin kernel (torch.cuda._sleep) that outlasts the host's
    enqueueing of them, so that they run back to back: no host time falls
    between them, only the card's own gaps between launches."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for spin_s in (2.0 * host_s + 1e-3, 8.0 * host_s + 1e-2):
        torch.cuda._sleep(int(spin_s * SM_CLOCK_HZ))  # at the maximum clock: spins at least spin_s
        start.record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        queued_s = time.perf_counter() - t
        torch.cuda.synchronize()
        if queued_s < spin_s:
            break
    require(queued_s < spin_s, "queued_ms: the host took", queued_s, "s to queue the calls, past the spin's", spin_s)
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10, warmup: int = 2, floor_ms: float = 0.0):
    """The device time per call of the CUDA kernels that fn launches: their
    self device time under torch.profiler (CUPTI), summed over iters calls,
    over iters.  Unlike cuda_ms, no host dispatch between the launches counts.
    Returns (ms, {kernel name: ms per call}).  On the H100 a profile of the
    ctypes kernels has now and then come back with the host's launch calls
    and no device record at all, up to three in a row, and late in a long
    run with a share of the records (a K5 row at a quarter of its events
    time, below its bound); a profile with no device record, or one whose
    time lies below floor_ms (the caller's bound), counts as missed.  After
    two such, the time is taken from CUDA events instead (queued_ms), the
    call is noted in PROFILER_MISSES, and the kernel breakdown is None."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.key_averages():  # kernels only, as in profile_main
            dev_us = getattr(e, "self_device_time_total", 0) or 0
            if str(e.device_type).endswith("CUDA") and dev_us > 0:
                by[e.key] = by.get(e.key, 0.0) + dev_us / 1e3 / iters
        if by and sum(by.values()) >= floor_ms:
            return sum(by.values()), by
    events = [(e.key, str(e.device_type)) for e in prof.key_averages()][:12]
    PROFILER_MISSES.append(events)
    print(f"device_ms: the profiler recorded no device time, or less than the bound {floor_ms} ms, in 2 "
          f"profiles ({sum(by.values())} ms); CUDA events instead. Its events:", events, file=sys.stderr, flush=True)
    return queued_ms(fn, iters), None


def breakdown(by, dev_ms: float, pattern: str, parts, what: str):
    """{part: device ms} of the kernels whose names hold pattern.format(part),
    requiring that they account for all of dev_ms; None where device_ms had
    no profile to break down."""
    if by is None:
        return None
    out = {k: sum(v for nm, v in by.items() if pattern.format(k) in nm) for k in parts}
    require(abs(sum(out.values()) - dev_ms) <= 1e-6 * dev_ms, what, "kernels outside", pattern, by)
    return out


def host_us(fn, iters: int = 20) -> float:
    """Host microseconds per call of fn (the wrapper's checks, allocation and
    launch), with the card busy behind it."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / iters * 1e6


def bound(flops: float, nbytes: float, peak: float = H100_BF16_FLOPS, exps: float = 0.0):
    """The least time in ms and what sets it: flops at peak ("operations"),
    bytes at the HBM rate ("bytes") or, for a softmax, one exp2 a score on
    the special-function units of every SM at the maximum SM clock ("exp")."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return max((flops / peak * 1e3, "operations"), (nbytes / H100_HBM_BYTES * 1e3, "bytes"),
               (exps / (sms * EXP_PER_CLOCK * SM_CLOCK_HZ) * 1e3, "exp"))


def bf16_ulps(out, ref, mag):
    """|out - ref| per element in bf16 ulps (8 bits of mantissa) of the larger
    of |ref| and mag, the magnitude of the element's terms before they cancel."""
    m = torch.maximum(mag, ref.float().abs()).clamp_min(2.0 ** -126)
    return (out.float() - ref.float()).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


def require_ulps(what, out, ref, mag_of, slices, max_ulps=8, min_equal=0.999):
    """The norms' check: 99.9% of the elements equal, and every element within
    8 ulps of its magnitude.  A correct kernel sums its f32 statistics in
    another order than the plain version, which can flip a bf16 rounding of
    the mean or of a folded scale in a few channels or rows; one flipped bf16
    scale moves x * scale by up to 2^-7 of it (2 ulps), and each of the up to
    six bf16 roundings after it (the product, the shift, the sum, SiLU's exp,
    sigmoid and product) adds at most one.  A wrong kernel changes far more
    than 0.1% of the elements.  (1% of the largest output would not do: one
    ulp near the largest output is 0.39-0.78% of it, and a correct kernel
    gives two.)  Evaluated slice by slice (mag_of(sl): the magnitude of
    out[sl]), so that the VAE's 2^31-element GroupNorm at 1024^2 needs no
    f32 copy of the whole tensor.  Returns (max |out - ref|, max |ref|, max
    ulps, equal share)."""
    err = ref_max = ulps = 0.0
    n_equal = 0
    for sl in slices:
        o, r = out[sl], ref[sl]
        err = max(err, (o.float() - r.float()).abs().max().item())
        ref_max = max(ref_max, r.float().abs().max().item())
        ulps = max(ulps, bf16_ulps(o, r, mag_of(sl)).max().item())
        n_equal += (o == r).sum().item()
    equal = n_equal / out.numel()
    require(ulps <= max_ulps and equal >= min_equal, what, "max ulps", ulps, "equal share", equal)
    return err, ref_max, ulps, equal


def nvidia_smi_line(query: str = "name,power.limit", units: bool = True) -> str:
    fmt = "--format=csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}", fmt],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes per kernel function of an nvcc -Xptxas -v log."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
        elif cur is not None:
            if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
                cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            if m := re.search(r"Used (\d+) registers", ln):
                cur["registers"] = int(m.group(1))
    return out


def k1_ptxas(log: str) -> dict:
    """K1's wgmma kernel per (head dim, warpgroups) instantiation; requires
    all five and no spills (a spilled accumulator would stall every wgmma)."""
    rep = {}
    for fn, r in ptxas_report(log).items():
        if m := re.search(r"attention_packed_wgmma_kernelILi(\d+)ELi(\d+)E", fn):
            rep[f"dp{m.group(1)}_wg{m.group(2)}"] = r
    require(sorted(rep) == ["dp128_wg2", "dp128_wg4", "dp192_wg2", "dp64_wg2", "dp64_wg4"],
            "K1 wgmma instantiations in the ptxas report", sorted(rep))
    require(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 for r in rep.values()),
            "K1 wgmma kernels spill", rep)
    return rep


def k2_ptxas(log: str) -> dict:
    """K2's wgmma kernels (the first product, and the second at both N
    tiles): registers, spills, and wgmma_serialized where ptxas serialised
    their wgmmas (warning C7514); requires all three, no spills and no
    serialisation."""
    pat = r"ln_geglu_(up_kernel|down_kernelILi(\d+)E)"

    def key(m):
        return "up" if m[1] == "up_kernel" else f"down_bn{m[2]}"

    rep = {key(m): r for fn, r in ptxas_report(log).items() if (m := re.search(pat, fn))}
    for ln in log.splitlines():
        if "C7514" in ln and (m := re.search(pat, ln)) and key(m) in rep:
            rep[key(m)]["wgmma_serialized"] = True
    require(sorted(rep) == ["down_bn160", "down_bn64", "up"], "K2 wgmma kernels in the ptxas report", sorted(rep))
    require(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 and not r.get("wgmma_serialized")
                for r in rep.values()), "K2 wgmma kernels spill or serialise", rep)
    return rep


def k5_ptxas(log: str) -> dict:
    """K5's three phases: the Q/K/V product, the attention block per (head
    dim, warpgroups) instantiation and the out product at both N tiles;
    registers, spills, and wgmma_serialized where ptxas serialised their
    wgmmas (warning C7514); requires all eight, no spills and no
    serialisation."""
    pat = r"attention_block_(qkv_kernel|attend_kernelILi(\d+)ELi(\d+)E|out_kernelILi(\d+)E)"

    def key(m):
        if m[1] == "qkv_kernel":
            return "qkv"
        return f"attend_dp{m[2]}_wg{m[3]}" if m[2] else f"out_bn{m[4]}"

    rep = {key(m): r for fn, r in ptxas_report(log).items() if (m := re.search(pat, fn))}
    for ln in log.splitlines():
        if "C7514" in ln and (m := re.search(pat, ln)) and key(m) in rep:
            rep[key(m)]["wgmma_serialized"] = True
    want = ["attend_dp128_wg2", "attend_dp128_wg4", "attend_dp192_wg2", "attend_dp64_wg2", "attend_dp64_wg4",
            "out_bn160", "out_bn64", "qkv"]
    require(sorted(rep) == want, "K5 wgmma kernels in the ptxas report", sorted(rep))
    require(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 and not r.get("wgmma_serialized")
                for r in rep.values()), "K5 wgmma kernels spill or serialise", rep)
    return rep


def k3_ptxas(log: str) -> dict:
    """K3's statistics kernel and its normalize per epilogue (TPU numerics
    or not, SiLU or not), each for bf16 and f32: registers and spills;
    requires all ten and no spills."""
    def key(m):
        t = "bf16" if m[2] == "13__nv_bfloat16" else "f32"
        if m[1] == "stats":
            return f"stats_{t}"
        return f"apply_{t}_{'tpu' if m[3] == '1' else 'xla'}{'_silu' * (m[4] == '1')}"

    pat = r"gn_(stats|apply)_kernelI(13__nv_bfloat16|f)(?:Li(\d)ELi(\d)E)?"
    rep = {key(m): r for fn, r in ptxas_report(log).items() if (m := re.search(pat, fn))}
    want = sorted([f"stats_{t}" for t in ("bf16", "f32")] + [f"apply_{t}_{e}{a}" for t in ("bf16", "f32")
                                                              for e in ("tpu", "xla") for a in ("", "_silu")])
    require(sorted(rep) == want, "K3 kernels in the ptxas report", sorted(rep))
    require(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 for r in rep.values()), "K3 kernels spill",
            rep)
    return rep


def k1_f32_ptxas(log: str) -> dict:
    """K1's f32 kernel (head dim 512): registers and spills; requires no
    spill (its 64 accumulator registers a thread would go to local memory)."""
    rep = {fn: r for fn, r in ptxas_report(log).items() if "attention_packed_f32_kernel" in fn}
    require(len(rep) == 1 and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 for r in rep.values()),
            "K1 f32 kernel in the ptxas report, without spills", rep)
    return next(iter(rep.values()))


K6_INSTANCES = sorted([f"dp64_trim_bn{bn}_wg{wg}" for bn in (128, 64) for wg in (4, 2, 1)]
                      + [f"dp64_bn{bn}_wg{wg}" for bn in (128, 64) for wg in (4, 2, 1)]
                      + [f"dp128_bn64_wg{wg}" for wg in (4, 2, 1)] + ["dp192_bn64_wg2", "dp192_bn64_wg1"])


def k6_ptxas(log: str) -> dict:
    """K6's kernel per (padded head dim, trimmed widths, key tile,
    warpgroups) instantiation: registers, spills, and wgmma_serialized where
    ptxas serialised its wgmmas (warning C7514)."""
    def key(m):
        return f"dp{m[1]}{'_trim' if m[2] == '1' else ''}_bn{m[3]}_wg{m[4]}"

    pat = r"flash_attention_kernelILi(\d+)ELb([01])ELi(\d+)ELi(\d+)E"
    rep = {key(m): r for fn, r in ptxas_report(log).items() if (m := re.search(pat, fn))}
    for ln in log.splitlines():
        if "C7514" in ln and (m := re.search(pat, ln)) and key(m) in rep:
            rep[key(m)]["wgmma_serialized"] = True
    return rep


PARENT = {}  # with --parent: the parent checkout's K3 and K5 wrapper modules, on its own kernels


def load_parent(root: str) -> float:
    """Builds the K3 and K5 libraries of another checkout (root/saspa_tpu_torch/
    csrc, nvcc in parallel, into _build/parent) and loads that checkout's
    wrapper modules (ops/groupnorm.py, ops/attention.py) as they are, their
    `_build` answered by those libraries with that checkout's C signatures,
    into PARENT.  Returns the seconds taken."""
    import ctypes
    import importlib.util
    from pathlib import Path
    from types import SimpleNamespace

    from saspa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    pkg = Path(root) / "saspa_tpu_torch"

    def module(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    sigs = module("parent_build", pkg / "ops" / "_build.py").SIGNATURES
    out = _build.BUILD_DIR / "parent"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {n: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"lib{n}.so"),
                                 str(pkg / "csrc" / f"{n}.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True) for n in ("group_norm", "attention_block")}
    fns = {}
    for n, proc in jobs.items():
        _, err = proc.communicate()
        require(proc.returncode == 0, "parent build of", n, err[-2000:])
        fn = getattr(ctypes.CDLL(str(out / f"lib{n}.so")), sigs[n][0])
        fn.argtypes, fn.restype = sigs[n][1], ctypes.c_int
        fns[n] = fn
    shim = SimpleNamespace(kernel=fns.__getitem__, check=_build.check)
    for key, name in (("group_norm", "groupnorm"), ("attention_block", "attention")):
        mod = module(f"parent_{name}", pkg / "ops" / f"{name}.py")
        mod._build = shim
        PARENT[key] = mod
    return time.perf_counter() - t0


def parent_times(fn) -> dict:
    """The parent's wrapper timed as the change's is: ms, device_ms, host_us."""
    return {"parent_ms": cuda_ms(fn, 10), "parent_device_ms": device_ms(fn)[0], "parent_host_us": host_us(fn)}


def check_k1(gen):
    from saspa_tpu_torch.ops import attention as att

    rows = []
    for what, b, l, h, d, dp in K1_SHAPES:
        def padded(x):
            return torch.nn.functional.pad(x, (0, dp - d)).reshape(b, l, h * dp)

        shape = (b, l, h, d)
        scale = (1.0 / math.sqrt(d)) * att.LOG2E
        # q of std 3 peaks each query's softmax on a few keys (as in check_k6),
        # so a misplaced K/V tile or a wrong swizzle changes the output
        q = padded(3.0 * torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16).contiguous()
        k = padded(torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16).contiguous()
        v = padded(torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16).contiguous()
        out = att.flash_attention_packed(q, k, v, h)
        ref = att.flash_attention_packed_plain(q, k, v, h)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        # bf16 output (relative rounding 2^-9) and bf16 P in the P.V product:
        # the kernel's streamed online softmax sums in another order than the
        # plain one-pass softmax, so allow 1% of the largest output
        require(err <= 1e-2 * ref_max, what, "max |kernel - plain|", err, "> 1% of", ref_max)
        pad_zero = bool((out.reshape(b, l, h, dp)[..., d:] == 0).all().item()) if dp > d else True
        require(pad_zero, what, "padded output columns are not exactly zero")
        qh, kh, vh = (x.reshape(b, l, h, dp).transpose(1, 2) for x in (q, k, v))
        ms = cuda_ms(lambda: att.flash_attention_packed(q, k, v, h), 10)
        plain_ms = cuda_ms(lambda: att.flash_attention_packed_plain(q, k, v, h), 3, warmup=1)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=math.log(2.0)), 10)
        b_ms, b_by = bound(4.0 * b * h * l * l * dp, 4 * b * l * h * dp * 2, exps=b * h * l * l)
        rows.append(dict(shape=what, B=b, L=l, H=h, d=d, d_pad=dp, max_abs_err=err, ref_max=ref_max,
                         pad_cols_zero=pad_zero, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, lib_ratio=ms / lib_ms, bound_share=b_ms / ms))
        del q, k, v, out, ref
    return rows


def check_k6(gen):
    from saspa_tpu_torch.ops import attention as att

    rows = []
    for what, b, l, h, d in K6_SHAPES:
        dp = att.pad_head_dim(d)
        scale = d ** -0.5
        # q of std 3 peaks each query's softmax on a few keys (scores of std
        # ~3), so a dropped or misplaced K/V tile changes the output
        q = (3.0 * torch.randn(b, l, h, d, generator=gen, device="cuda")).to(torch.bfloat16)
        k, v = (torch.randn(b, l, h, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        out = att.flash_attention(q, k, v, scale)
        ref = att.flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        # the same bf16 rounding of q * scale, P and the output; the kernel
        # rounds P against the running max of 128-key tiles, the plain version
        # of 512/256-key chunks: 1% of the largest output, as for K1
        require(err <= 1e-2 * ref_max, what, "max |kernel - plain|", err, "> 1% of", ref_max)
        del ref
        ms = cuda_ms(lambda: att.flash_attention(q, k, v, scale), 3)
        plain_ms = cuda_ms(lambda: att.flash_attention_plain(q, k, v, scale), 1, warmup=1)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's (B, H, L, d)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=scale), 3)
        # the function's work is on d-wide heads (the padding is the kernel's
        # own choice; K1's inputs come padded), and one exp a score
        b_ms, b_by = bound(4.0 * b * h * l * l * d, 4 * b * l * h * d * 2, exps=b * h * l * l)
        rows.append(dict(shape=what, B=b, L=l, H=h, d=d, d_pad=dp, max_abs_err=err, ref_max=ref_max, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                         lib_ratio=ms / lib_ms, bound_share=b_ms / ms))
        del q, k, v, out, qh, kh, vh
        torch.cuda.empty_cache()
    return rows


def check_k2(gen):
    from saspa_tpu_torch.ops import geglu

    rows = []
    bf = torch.bfloat16
    for what, b, l, c in K2_SHAPES:
        f = 4 * c

        def rn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * std

        x = rn(b, l, c).to(bf)
        lns, lnb = 1.0 + rn(c, std=0.1), rn(c, std=0.1)
        w1, b1 = rn(2 * f, c, std=c ** -0.5).to(bf), rn(2 * f, std=0.1).to(bf)
        w2, b2 = rn(c, f, std=f ** -0.5).to(bf), rn(c, std=0.1).to(bf)
        args = (x, lns, lnb, w1, b1, w2, b2)
        out = geglu.fused_ln_geglu(*args)
        ref = geglu.fused_ln_geglu_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        # the kernel reproduces every bf16 rounding point of the plain version;
        # only f32 summation order differs, which can flip the bf16 rounding of
        # hid and of the output's three bf16 steps: allow 1% of the largest output
        require(err <= 1e-2 * ref_max, what, "max |kernel - plain|", err, "> 1% of", ref_max)
        del ref
        m = b * l
        b_ms, b_by = bound(6.0 * m * c * f, 2 * (2 * m * c + 3 * c * f + 2 * f + c) + 8 * c)
        ms = cuda_ms(lambda: geglu.fused_ln_geglu(*args), 10)
        dev_ms, by_kernel = device_ms(lambda: geglu.fused_ln_geglu(*args), floor_ms=b_ms)
        stages = breakdown(by_kernel, dev_ms, "ln_geglu_{}_kernel", ("norm", "up", "down"), what)
        host = host_us(lambda: geglu.fused_ln_geglu(*args))
        plain_ms = cuda_ms(lambda: geglu.fused_ln_geglu_plain(*args), 3, warmup=1)
        # the yardstick of the two products: cuBLAS on the same bf16 operands
        # (xn and hid from the kernel's own stages); not a call the port makes
        xn, hid, _ = geglu.ln_geglu_stages(*args)

        def products():
            torch.matmul(xn, w1.t())
            torch.matmul(hid, w2.t())

        cublas_ms = cuda_ms(products, 10)
        cublas_dev_ms, _ = device_ms(products)
        rows.append(dict(shape=what, rows=m, C=c, F=f, max_abs_err=err, ref_max=ref_max, ms=ms, device_ms=dev_ms,
                         stage_device_ms=stages, host_us=host, plain_ms=plain_ms, library_ms=None,
                         cublas_ms=cublas_ms, cublas_device_ms=cublas_dev_ms, bound_ms=b_ms, bound_by=b_by,
                         bound_share=b_ms / dev_ms))
        del args, x, out, xn, hid
    return rows


def check_k3(gen, sites):
    """sites: {(B, C, H, W, act, eps)} of the main path's GroupNorms (all
    channels-last); both epilogues at each."""
    from saspa_tpu_torch.ops import groupnorm as gn

    rows = []
    for (b, c, h, w, act, eps) in sorted(sites, key=lambda s: (s[0] * s[1] * s[2] * s[3], s[1], str(s[4]))):
        x = torch.randn(b, c, h, w, generator=gen, device="cuda").mul_(3.0).add_(0.5).to(torch.bfloat16)
        x = x.to(memory_format=torch.channels_last)
        gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
        n = x.numel()
        g = gn.groups_for(c, 32)

        def mag_of(sl):
            """The terms' magnitude per element of the batch rows sl:
            (|x| + |mean|) * |gamma * rstd| + |beta|."""
            xs = x[sl].float()
            xg = xs.reshape(xs.shape[0], g, -1)
            mean = xg.mean(-1)
            rstd = torch.rsqrt(((xg * xg).mean(-1) - mean * mean).clamp_min(0.0) + eps)
            sc = (gamma.reshape(1, g, -1) * rstd[:, :, None]).abs().reshape(-1, c, 1, 1)
            return (xs.abs() + mean.abs().repeat_interleave(c // g, 1)[:, :, None, None]) * sc \
                + beta.abs().reshape(1, c, 1, 1)

        lib = {"library_ms": None, "library_device_ms": None}
        if act is None:  # no single PyTorch call computes GroupNorm + SiLU
            gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

            def library():
                return torch.nn.functional.group_norm(x, 32, gb, bb, eps)

            lib = {"library_ms": cuda_ms(library, 10), "library_device_ms": device_ms(library)[0]}
        for tpu in (False, True):
            plain = gn.group_norm_tpu_plain if tpu else gn.group_norm_plain
            out = gn.group_norm(x, gamma, beta, 32, eps, act, tpu_numerics=tpu)
            ref = plain(x, gamma, beta, 32, eps, act)
            what = f"B{b} C{c} {h}x{w} act={act} {'tpu' if tpu else 'xla'}"
            err, ref_max, ulps, equal = require_ulps(what, out, ref, mag_of, [slice(i, i + 1) for i in range(b)])
            del out, ref

            def kernel():
                return gn.group_norm(x, gamma, beta, 32, eps, act, tpu_numerics=tpu)

            b_ms, b_by = bound((10.0 if act else 6.0) * n, 4 * n + 8 * c, H100_F32_FLOPS)
            ms = cuda_ms(kernel, 10)
            dev_ms, by_kernel = device_ms(kernel, floor_ms=b_ms)
            launch_ms = breakdown(by_kernel, dev_ms, "gn_{}_kernel", ("stats", "apply"), what)
            plain_ms = cuda_ms(lambda: plain(x, gamma, beta, 32, eps, act), 3, warmup=1)
            par = {}
            if PARENT:
                pgn = PARENT["group_norm"]
                par = parent_times(lambda: pgn.group_norm(x, gamma, beta, 32, eps, act, tpu_numerics=tpu))
            rows.append(dict(shape=what, B=b, C=c, HW=h * w, act=act, eps=eps, tpu_numerics=tpu,
                             plan=list(gn.gn_plan(b, h * w, c, gn.sm_count(x.device))), max_abs_err=err,
                             ref_max=ref_max, max_ulps=ulps, equal_share=equal, ms=ms, device_ms=dev_ms,
                             launch_device_ms=launch_ms, queued_ms=queued_ms(kernel, 10), host_us=host_us(kernel),
                             plain_ms=plain_ms, **lib,
                             bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / dev_ms, **par))
        del x
        torch.cuda.empty_cache()
    return rows


def check_k4(gen, sites):
    """sites: {(rows, C)} of the main path's norm1/norm2 LayerNorms."""
    from saspa_tpu_torch.ops import layernorm as ln

    rows = []
    for m, c in sorted(sites):
        x = (0.5 + 3.0 * torch.randn(1, m, c, generator=gen, device="cuda")).to(torch.bfloat16)
        s, bias = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda"), 0.2 * torch.randn(c, generator=gen, device="cuda")
        out = ln.layer_norm_one_pass(x, s, bias)
        ref = ln.layer_norm_one_pass_plain(x, s, bias)

        def mag_of(sl):
            """same bf16 rounding points; f32 sum order and rsqrt's last bit
            can flip one.  Terms' magnitude: (|x| + |mean|) * |rstd * s| + |b|"""
            xf = x[sl].float()
            mean = xf.mean(-1, keepdim=True)
            rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mean * mean + 1e-5)
            return (xf.abs() + mean.abs()) * (rstd * s).abs() + bias.abs()

        err, ref_max, ulps, equal = require_ulps(f"rows {m} C {c}", out, ref, mag_of, [slice(None)])
        b_ms, b_by = bound(8.0 * m * c, 4 * m * c + 8 * c, H100_F32_FLOPS)
        ms = cuda_ms(lambda: ln.layer_norm_one_pass(x, s, bias), 10)
        dev_ms, _ = device_ms(lambda: ln.layer_norm_one_pass(x, s, bias), floor_ms=b_ms)
        host = host_us(lambda: ln.layer_norm_one_pass(x, s, bias))
        plain_ms = cuda_ms(lambda: ln.layer_norm_one_pass_plain(x, s, bias), 3, warmup=1)
        sb, bb = s.to(torch.bfloat16), bias.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.nn.functional.layer_norm(x, (c,), sb, bb, 1e-5), 10)
        lib_dev_ms, _ = device_ms(lambda: torch.nn.functional.layer_norm(x, (c,), sb, bb, 1e-5))
        rows.append(dict(shape=f"rows {m}, C{c}", rows=m, C=c, plan=list(ln.ln_plan(m, c, ln.sm_count(x.device))),
                         max_abs_err=err, ref_max=ref_max, max_ulps=ulps, equal_share=equal, ms=ms,
                         device_ms=dev_ms, queued_ms=queued_ms(lambda: ln.layer_norm_one_pass(x, s, bias), 10),
                         host_us=host, plain_ms=plain_ms, library_ms=lib_ms,
                         library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / dev_ms,
                         lib_ratio_device=dev_ms / lib_dev_ms))
        del x, out, ref
    return rows


def check_k5(gen, sites):
    """sites: {(B, L, C, heads)} of the self-attentions the block kernel takes."""
    from saspa_tpu_torch.ops import attention as att

    rows = []
    bf = torch.bfloat16
    for b, l, c, h in sorted(sites):
        d = c // h
        dp = att.pad_head_dim(d)

        def rn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * std

        def pad_rows(w):  # (C, C) -> head-padded (H*dp, C)
            return torch.nn.functional.pad(w.reshape(h, d, c), (0, 0, 0, dp - d)).reshape(h * dp, c)

        # scores of std ~4.3 bits (q three times the unit scale) make each
        # query's softmax peak on a few keys, so the attention term is of
        # order 1 and changes if a K/V tile or the exp2 base goes wrong; the
        # residual and bo are small beside it but not zero
        wq = (pad_rows(rn(c, c, std=3.0 * c ** -0.5)) * (att.LOG2E / math.sqrt(d))).to(bf).contiguous()
        wk, wv = (pad_rows(rn(c, c, std=c ** -0.5)).to(bf).contiguous() for _ in range(2))
        wo = torch.nn.functional.pad(rn(c, c, std=c ** -0.5).reshape(c, h, d), (0, dp - d)).reshape(c, h * dp)
        wo = wo.to(bf).contiguous()
        bo = rn(c, std=0.05)
        x, res = rn(b, l, c).to(bf), rn(b, l, c, std=0.05).to(bf)
        args = (x, res, wq, wk, wv, wo, bo, h)
        out = att.attention_block_fused(*args)
        ref = att.attention_block_fused_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        term_max = (ref.float() - res.float() - bo).abs().max().item()
        # Q/K/V, P and the packed heads are rounded to bf16 at the same points;
        # the online softmax and the product order differ: 1% of the largest
        # attention-plus-projection term, out - residual - bo
        what = f"B{b} L{l} C{c} H{h} d{d}->{dp}"
        require(err <= 1e-2 * term_max, what, "max |kernel - plain|", err, "> 1% of the term's max", term_max)
        equal = (out == ref).float().mean().item()
        del out, ref

        def kernel():
            return att.attention_block_fused(*args)

        m, hd = b * l, h * dp
        b_ms, b_by = bound(8.0 * m * c * hd + 4.0 * b * h * l * l * dp, 2 * 3 * m * c + 2 * 4 * c * hd + 4 * c,
                           exps=b * h * l * l)
        ms = cuda_ms(kernel, 10)
        dev_ms, by_kernel = device_ms(kernel, floor_ms=b_ms)
        phases = breakdown(by_kernel, dev_ms, "attention_block_{}_kernel", ("qkv", "attend", "out"), what)
        plain_ms = cuda_ms(lambda: att.attention_block_fused_plain(*args), 2, warmup=1)
        # the yardstick: the route that configuration (a) takes at the same
        # shape (models/unet.py CrossAttention without the megakernel): three
        # cuBLAS projections, the scale fold, K1, the out projection with its
        # bias, the residual add.  No one PyTorch call computes K5.  Timed
        # only (wq is already scaled, so the fold scales q twice).
        bo_bf = bo.to(bf)

        def route_a():
            q = att.fold_scale(torch.nn.functional.linear(x, wq), att.LOG2E / math.sqrt(d))
            k, v = torch.nn.functional.linear(x, wk), torch.nn.functional.linear(x, wv)
            return res + torch.nn.functional.linear(att.flash_attention_packed(q, k, v, h), wo, bo_bf)

        route_ms = cuda_ms(route_a, 10)
        route_dev_ms, _ = device_ms(route_a, floor_ms=b_ms)
        par = parent_times(lambda: PARENT["attention_block"].attention_block_fused(*args)) if PARENT else {}
        rows.append(dict(shape=what, B=b, L=l, C=c, H=h, d=d, d_pad=dp, max_abs_err=err, ref_max=ref_max,
                         term_max=term_max, equal_share=equal, ms=ms, device_ms=dev_ms, phase_device_ms=phases,
                         host_us=host_us(kernel), plain_ms=plain_ms, library_ms=None, route_a_ms=route_ms,
                         route_a_device_ms=route_dev_ms, bound_ms=b_ms, bound_by=b_by,
                         bound_share=b_ms / dev_ms, **par))
        del args, x, res
    return rows


def record_sites(pipe):
    """Forward hooks on the pipeline's norms and self-attentions; returns
    (sites dict, hook handles).  GroupNorm: (B, C, H, W, act, eps); norm1/norm2
    LayerNorm: (rows, C); self-attention with a residual that the block kernel
    admits: (B, L, C, heads); every transformer self-attention: the same
    tuple under "self_attention"."""
    from saspa_tpu_torch.models.unet import CrossAttention, GroupNorm32, LayerNorm32
    from saspa_tpu_torch.ops.attention import attention_block_eligible

    sites = {"group_norm": set(), "layernorm": set(), "attention_block": set(), "self_attention": set()}

    def gn_hook(mod, args):
        x = args[0]
        sites["group_norm"].add((*x.shape, mod.act, mod.eps))

    def ln_hook(mod, args):
        x = args[0]
        sites["layernorm"].add((x.numel() // x.shape[-1], x.shape[-1]))

    def attn_hook(mod, args, kwargs):
        x = args[0]
        b, l, c = x.shape
        if kwargs.get("context") is None:
            sites["self_attention"].add((b, l, c, mod.heads))
        if kwargs.get("context") is None and kwargs.get("residual") is not None \
                and attention_block_eligible(l, l, mod.heads, c // mod.heads, c, x.element_size()):
            sites["attention_block"].add((b, l, c, mod.heads))

    handles = []
    for key in ("unet", "controlnet", "vae"):
        for m in (pipe.params[key].modules() if key in pipe.params else ()):
            if isinstance(m, GroupNorm32):
                handles.append(m.register_forward_pre_hook(gn_hook))
            elif isinstance(m, LayerNorm32):
                handles.append(m.register_forward_pre_hook(ln_hook))
            elif isinstance(m, CrossAttention):
                handles.append(m.register_forward_pre_hook(attn_hook, with_kwargs=True))
    return sites, handles


def kernel_group(name: str) -> str:
    """The op group of a kernel's name in the profiles' tables."""
    if "attention_packed" in name:  # the wgmma kernel and the VAE's
        return "attention_packed (K1)"
    if "ln_geglu_" in name:  # its three stages, the row-normalize included
        return "ln_geglu (K2)"
    if "saspa::gn_" in name:
        return "group_norm (K3)"
    if "layernorm_kernel" in name:
        return "layernorm (K4)"
    if "attention_block_" in name:  # its three phases
        return "attention_block (K5)"
    if "flash_attention_kernel" in name:
        return "flash_attention (K6)"
    n = name.lower()
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")):
        return "convolution (cuDNN)"
    if any(k in n for k in ("gemm", "nvjet", "cublas", "cutlass")):
        return "matmul (cuBLAS)"
    if "reduce" in n:
        return "reductions (norm statistics, softmax)"
    return "elementwise and copies"


def profile_run(run) -> dict:
    """Device time by kernel and by group over one call of run()
    (torch.profiler/CUPTI); run returns (anything, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run()
    rows = []
    for e in prof.key_averages():  # kernels only: aten ops would count their kernels twice
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if str(e.device_type).endswith("CUDA") and dev_us > 0:
            rows.append({"name": e.key, "calls": e.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows) / 1e3
    groups: dict = {}
    for r in rows:
        g = kernel_group(r["name"])
        groups[g] = groups.get(g, 0.0) + r["device_ms"]
    return {"wall_s": wall, "device_busy_s": busy, "idle_share": 1.0 - busy / wall, "groups_ms": groups,
            "kernels": rows}


def profile_main(run, out_path: str, steps: int, config: str) -> None:
    """Device time by kernel over one main-path run, into out_path."""
    from pathlib import Path

    r = profile_run(run)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps({"config": config, "steps": steps, **{k: r[k] for k in (
        "wall_s", "device_busy_s", "groups_ms", "kernels")}}, indent=1))
    emit({"phase": "profile", "config": config, "steps": steps, **{k: r[k] for k in (
        "wall_s", "device_busy_s", "idle_share", "groups_ms")}, "top": r["kernels"][:12], "table": out_path})


def synthetic_sources(rng: np.random.RandomState, n: int, size: int, width=None) -> np.ndarray:
    """Smooth synthetic scenes: a colour gradient with a few filled ellipses;
    size x size, or size x width."""
    width = width or size
    yy, xx = np.mgrid[0:size, 0:width].astype(np.float32)
    yy, xx = yy / size, xx / width
    imgs = np.empty((n, size, width, 3), np.float32)
    for i in range(n):
        a, c = rng.uniform(40, 200, 3), rng.uniform(-60, 60, 3)
        img = a[None, None] + c[None, None] * (0.6 * xx + 0.4 * yy)[..., None]
        for _ in range(rng.randint(3, 7)):
            cy, cx, ry, rx = rng.uniform(0.15, 0.85, 2).tolist() + rng.uniform(0.05, 0.3, 2).tolist()
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
            img[inside] = rng.uniform(0, 255, 3)
        imgs[i] = img
    return np.clip(np.round(imgs), 0, 255).astype(np.uint8)


CONFIGS = {"default": {}, "opt_in": {"pallas_group_norm": True, "attention_megakernel": True}}


def read_counts() -> dict:
    from saspa_tpu_torch.ops import attention, geglu, groupnorm, layernorm

    return {"attention_packed": attention.launches, "ln_geglu": geglu.launches, "group_norm": groupnorm.launches,
            "group_norm_tpu": groupnorm.launches_tpu, "layernorm": layernorm.launches,
            "attention_block": attention.block_launches, "flash_attention": attention.flash_launches,
            "attention_packed_f32": attention.launches_f32, "group_norm_f32": groupnorm.launches_f32}


def reset_counts() -> None:
    from saspa_tpu_torch.ops import attention, geglu, groupnorm, layernorm

    attention.launches = attention.block_launches = attention.flash_launches = geglu.launches = 0
    groupnorm.launches = groupnorm.launches_tpu = layernorm.launches = 0
    attention.launches_f32 = groupnorm.launches_f32 = 0


F32_NONE = {"attention_packed_f32": 0, "group_norm_f32": 0}  # no f32 launch: the VAE in bf16


def expected_counts(steps: int, config: str) -> dict:
    """Launches of one batch at 512^2.  Per step: UNet 15 + ControlNet 6
    self-attentions over >= 256 tokens, 16 + 7 transformer blocks (norm1 and
    norm2 each), 61 + 27 GroupNorms; per decode: the VAE's attention and 30
    GroupNorms, 7 of which (the 512^2 tail) the TPU kernel's split plan
    refuses."""
    if config == "default":
        return {"attention_packed": 21 * steps + 1, "ln_geglu": 23 * steps, "group_norm": 88 * steps + 30,
                "group_norm_tpu": 0, "layernorm": 46 * steps, "attention_block": 0, "flash_attention": 0,
                **F32_NONE}
    return {"attention_packed": 1, "ln_geglu": 23 * steps, "group_norm": 88 * steps + 30,
            "group_norm_tpu": 88 * steps + 23, "layernorm": 46 * steps, "attention_block": 21 * steps,
            "flash_attention": 0, **F32_NONE}


def expected_gen_counts(steps: int) -> dict:
    """Launches of one batch through `cli gen` at 1024^2 (128^2 latents),
    default configuration.  Self-attention per step: level 0 (16384 tokens)
    is past K1's 48 MiB guard, so its 7 sites run K6 (UNet: down 2 + up 3;
    ControlNet: down 2); levels 1 and 2 (4096, 1024 tokens) and the mid
    block (256 tokens, eligible at this size) run K1 (UNet 5 + 5 + 1,
    ControlNet 2 + 2 + 1 = 16).  The VAE's 16384-token attention takes the
    plain path.  Norms and feed-forwards as at 512^2."""
    return {"attention_packed": 16 * steps, "ln_geglu": 23 * steps, "group_norm": 88 * steps + 30,
            "group_norm_tpu": 0, "layernorm": 46 * steps, "attention_block": 0, "flash_attention": 7 * steps,
            **F32_NONE}


def write_planes_tree(root, rng, n: int, size: int) -> list:
    """A synthetic FGVC-Aircraft train split under root (the layout
    PlanesUtils and FGVCAircraftFiles read): n seeded size x size sources
    written as PNG under .jpg names, with manufacturer and variant files and
    the class list variants.txt (4 classes).  Returns the image ids."""
    from pathlib import Path

    from saspa_tpu_torch.gen.image_io import write_png

    data = Path(root) / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    (data / "images").mkdir(parents=True)
    ids = [f"{1000000 + 37 * i:07d}" for i in range(n)]
    makers = [("Boeing", "737-800"), ("Airbus", "A320"), ("Embraer", "E-190"), ("Cessna", "172")]
    for i, (img, image_id) in enumerate(zip(synthetic_sources(rng, n, size), ids)):
        write_png(data / "images" / f"{image_id}.jpg", img)
    (data / "images_train.txt").write_text("".join(f"{i}\n" for i in ids))
    (data / "images_manufacturer_train.txt").write_text(
        "".join(f"{i} {makers[k % 4][0]}\n" for k, i in enumerate(ids)))
    (data / "images_variant_train.txt").write_text("".join(f"{i} {makers[k % 4][1]}\n" for k, i in enumerate(ids)))
    (data / "variants.txt").write_text("".join(f"{m[1]}\n" for m in makers))
    return ids


class TelemetryHandler(logging.Handler):
    """Keeps the driver's telemetry lines, parsed, and its error records
    (with their tracebacks: the driver counts a failed batch and goes on)."""

    def __init__(self):
        super().__init__()
        self.lines = []
        self.errors = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("generation telemetry: "):
            self.lines.append(json.loads(msg.split(": ", 1)[1]))
        elif record.levelno >= logging.ERROR:
            self.errors.append(self.format(record))


def run_gen_phase(steps: int, seed: int, profile_path=None) -> dict:
    """The `gen` entry point at 1024^2 (module docstring, phase 5); returns
    its launch counts."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import init_pipeline
    from saspa_tpu_torch.gen.image_io import read_png, read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.gen.tokenizer import NEGATIVE_PROMPT
    from saspa_tpu_torch.ops.image import resize_image
    from saspa_tpu_torch.utils import rng as rngs

    size, b = GEN_RESOLUTION, 8
    root = tempfile.mkdtemp(prefix="saspa_gen_")
    old_root = os.environ.get("SASPA_DATA_ROOT")
    os.environ["SASPA_DATA_ROOT"] = root
    tele = TelemetryHandler()
    root_logger = logging.getLogger()
    old_level = root_logger.level
    root_logger.setLevel(logging.INFO)  # the driver's progress and telemetry lines
    root_logger.addHandler(tele)
    try:
        ids = write_planes_tree(root, np.random.RandomState(seed + 101), b, size)
        argv = ["gen", "--dataset", "planes", "--resolution", str(size), "--skip_filter", "--num_per_image", "1",
                "--num_inference_steps", str(steps), "--batch_size", str(b), "--seed", str(seed + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        folder = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        want = expected_gen_counts(steps)
        require(counts == want, "gen launch counts", counts, "expected", want)
        require(len(tele.lines) == 1 and tele.lines[0]["num_errors"] == 0 and tele.lines[0]["total"] == b,
                "gen telemetry", tele.lines)
        files = sorted(Path(folder).glob("*.png"))
        side = [f for f in files if f.stem.endswith(("_source", "_control"))]
        outs = {f.name.split("_prompt_")[0]: f for f in files if "_prompt_" in f.name}
        require(len(side) == 2 * b and sorted(outs) == sorted(ids), "gen files", [f.name for f in files])
        pngs = {i: read_png(f) for i, f in outs.items()}
        require(all(a.shape == (size, size, 3) for a in pngs.values()), "gen PNG shapes",
                [a.shape for a in pngs.values()])

        # the same batch through the fused function: same weights (seeded),
        # prompts, sources and noise -> the PNGs' pixels, bit for bit
        cfg = cli.gen_config(cli.build_parser().parse_args(argv)).with_dataset_overrides()
        ds = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        engine = PromptEngine(cfg, ds, ds.get_image_stem_to_class_str_dict())
        paths = ds.original_images_paths
        prompts = [engine.build(pth, i, 0) for i, pth in enumerate(paths)]
        pipe = init_pipeline("sd_v1.5", "canny")
        src = np.stack([resize_image(read_rgb(pth), size) for pth in paths])
        lf = pipe.latent_factor
        lat = np.stack([rngs.item_normal(cfg.seed, "noise", i, 0, shape=(size // lf, size // lf, 4))
                        for i in range(b)])
        tok_ids = pipe.tokenizer(prompts, pad="eot")
        neg_ids = pipe.tokenizer([NEGATIVE_PROMPT] * b, pad="eot")

        def fused_run(n_steps):
            fn = pipe.make_fused_generate(size, size, n_steps, 7.5, 0.75, 120.0, 200.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(pipe.params, tok_ids, neg_ids, src, lat, return_images=True)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        (u8, images), ts = fused_run(steps)
        require(bool(torch.isfinite(images).all()), "gen: non-finite images before quantisation")
        u8 = u8.cpu().numpy()
        del images
        same = [bool(np.array_equal(pngs[i], u8[k])) for k, i in enumerate(Path(pth).stem for pth in paths)]
        require(all(same), "gen PNGs differ from the fused function's output", same)
        _, t1 = fused_run(1)
        s_step = (ts - t1) / (steps - 1)
        emit({"phase": "gen", "argv": argv, "batch": b, "resolution": size, "steps": steps, "wall_s": wall,
              "img_per_s": b / wall, "fused_wall_s": ts, "fused_1step_s": t1, "s_per_step": s_step,
              "img_per_s_30_steps_est": b / (t1 + 29 * s_step), "peak_mem_bytes": peak,
              "launches": counts, "launches_expected": want, "telemetry": tele.lines[0],
              "pngs_equal_fused": all(same), "uint8_mean": float(u8.mean())})
        if profile_path:
            profile_main(lambda: fused_run(steps), profile_path, steps, "gen_1024")
        del pipe
        torch.cuda.empty_cache()
        return counts
    finally:
        root_logger.removeHandler(tele)
        root_logger.setLevel(old_level)
        if old_root is None:
            os.environ.pop("SASPA_DATA_ROOT", None)
        else:
            os.environ["SASPA_DATA_ROOT"] = old_root
        shutil.rmtree(root, ignore_errors=True)


BLIP_STEPS = 30  # the recipe's DDIM steps, whatever --steps says
BLIP_RESOLUTION = 512
BLIP_REFERENCE_RESOLUTION = 256  # the card-vs-CPU fused run, as phase 4's
# DTD train images (4 classes, two each) whose names the shipped captions JSON
# covers: DTD's prompts are its BLIP captions, keyed by these paths
DTD_SOURCES = ["banded/banded_0005.jpg", "banded/banded_0011.jpg", "blotchy/blotchy_0009.jpg",
               "blotchy/blotchy_0019.jpg", "braided/braided_0050.jpg", "braided/braided_0069.jpg",
               "bubbly/bubbly_0043.jpg", "bubbly/bubbly_0049.jpg"]


def write_dtd_tree(root, rng, size: int):
    """A synthetic DTD train split at root/data/DTD/dtdataset/dtd (the layout
    DTDUtils reads): DTD_SOURCES as seeded size x size PNG bytes under their
    .jpg names, and labels/train1.txt.  Returns the tree's root."""
    from pathlib import Path

    from saspa_tpu_torch.gen.image_io import write_png

    dtd = Path(root) / "data/DTD/dtdataset/dtd"
    (dtd / "labels").mkdir(parents=True)
    for name, img in zip(DTD_SOURCES, synthetic_sources(rng, len(DTD_SOURCES), size)):
        (dtd / "images" / name).parent.mkdir(parents=True, exist_ok=True)
        write_png(dtd / "images" / name, img)
    (dtd / "labels" / "train1.txt").write_text("".join(f"{n}\n" for n in DTD_SOURCES))
    return dtd


def row_cosines(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine of each last-axis vector of a with b's, in f64 on the host."""
    a, b = (t.detach().double().cpu().reshape(-1, t.shape[-1]) for t in (a, b))
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-300)


def run_blip_phase(seed: int, profile_path=None) -> dict:
    """BLIP-Diffusion through `cli gen --dataset dtd` (module docstring,
    phase 8); returns its launch counts."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import init_pipeline
    from saspa_tpu_torch.gen.image_io import read_png, read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.gen.tokenizer import NEGATIVE_PROMPT
    from saspa_tpu_torch.models.blip_diffusion import BlipDiffusionPipeline
    from saspa_tpu_torch.ops.image import pil_resize, resize_image
    from saspa_tpu_torch.utils import rng as rngs

    size, b, steps = BLIP_RESOLUTION, len(DTD_SOURCES), BLIP_STEPS
    if profile_path:  # the phase runs in another directory
        profile_path = str(Path(profile_path).resolve())
    root = tempfile.mkdtemp(prefix="saspa_blip_")
    old_cwd, old_root = os.getcwd(), os.environ.get("SASPA_DATA_ROOT")
    tele = TelemetryHandler()
    root_logger = logging.getLogger()
    old_level = root_logger.level
    root_logger.setLevel(logging.INFO)
    root_logger.addHandler(tele)
    try:
        os.chdir(root)  # DTD's captions are keyed by paths under data/
        os.environ["SASPA_DATA_ROOT"] = "data"
        write_dtd_tree(root, np.random.RandomState(seed + 301), size)
        argv = ["gen", "--dataset", "dtd", "--skip_filter", "--num_per_image", "1", "--resolution", str(size),
                "--num_inference_steps", str(steps), "--batch_size", str(b), "--seed", str(seed + 1)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        folder = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        require(len(tele.lines) == 1 and tele.lines[0]["num_errors"] == 0 and tele.lines[0]["total"] == b,
                "blip telemetry", tele.lines, *tele.errors)
        # one 512^2 main-path batch's launches at the recipe's 30 steps: the
        # vision tower and the Q-Former launch none of K1-K6
        want = expected_counts(steps, "default")
        require(counts == want, "blip launch counts", counts, "expected", want)
        require(folder.endswith("_style_img_from_diff_img_seed_%d/images" % (seed + 1)), "blip folder", folder)
        files = sorted(Path(folder).glob("*.png"))
        stems = [Path(n).stem for n in DTD_SOURCES]
        outs = {f.name.split("_prompt_")[0]: f for f in files if "_prompt_" in f.name}
        subjects = {f.name[:-len("_subject_0.png")]: f for f in files if f.name.endswith("_subject_0.png")}
        require(sorted(outs) == sorted(stems) and sorted(subjects) == sorted(stems), "blip files",
                [f.name for f in files])

        # host replay: the subject choice, the resize to 512^2 and the
        # truncation to uint8; then PIL's default resize to 224^2
        cfg = cli.gen_config(cli.build_parser().parse_args(argv)).with_dataset_overrides()
        require(cfg.base_model == "blip_diffusion" and cfg.controlnet == "canny", "dtd's recipe", cfg)
        ds = DS_UTILS_DICT["dtd"](print_func=lambda *a: None)
        paths = ds.original_images_paths
        subject_u8 = []
        for i, pth in enumerate(paths):
            same = ds.get_image_path_with_same_class(pth)
            pick = same[rngs.host_choice(len(same), cfg.seed, "subject_choice", i, 0)]
            r = resize_image(read_rgb(pick), size).astype(np.float32) / 255.0
            subject_u8.append((r * 255).astype(np.uint8))
        subjects_equal = [bool(np.array_equal(read_png(subjects[Path(p).stem]), u))
                          for p, u in zip(paths, subject_u8)]
        require(all(subjects_equal), "blip _subject_ files differ from the host replay", subjects_equal)
        refs = np.stack([pil_resize(u, (224, 224)) for u in subject_u8]).astype(np.float32) / np.float32(255.0)

        # the same batch through the fused function: same seeded weights,
        # ids, category ids, references, sources and noise -> the PNGs' pixels
        engine = PromptEngine(cfg, ds, ds.get_image_path_to_class_str_dict())
        prompts = [engine.build(pth, i, 0) for i, pth in enumerate(paths)]
        pipe = init_pipeline("blip_diffusion", "canny")
        src = np.stack([resize_image(read_rgb(pth), size) for pth in paths])
        lf = pipe.latent_factor
        lat = np.stack([rngs.item_normal(cfg.seed, "noise", i, 0, shape=(size // lf, size // lf, 4))
                        for i in range(b)])
        meta = ds.meta_class
        ids = pipe.build_subject_prompt_ids(prompts, meta)
        neg_ids = pipe.tokenizer([NEGATIVE_PROMPT] * b, pad="eot")
        cat_ids, cat_mask = pipe.bert_category_ids(meta, b)

        def fused_run(n_steps):
            fn = pipe.make_fused_generate(size, size, n_steps, 7.5, 0.75, 120.0, 200.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(pipe.params, ids, neg_ids, cat_ids, cat_mask, refs, src, lat, return_images=True)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        (u8, images), ts = fused_run(steps)
        require(bool(torch.isfinite(images).all()), "blip: non-finite images before quantisation")
        u8 = u8.cpu().numpy()
        del images
        pngs = {s: read_png(outs[s]) for s in stems}
        same = [bool(np.array_equal(pngs[s], u8[k])) for k, s in enumerate(stems)]
        require(all(same), "blip PNGs differ from the fused function's output", same)
        _, t1 = fused_run(1)
        s_step = (ts - t1) / (steps - 1)
        tower_ms = cuda_ms(lambda: pipe.subject_embeddings(pipe.params, refs, cat_ids, cat_mask), iters=5)

        def towers_run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe.subject_embeddings(pipe.params, refs, cat_ids, cat_mask)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        towers = profile_run(towers_run)  # their own device time and launches
        prof = profile_run(lambda: fused_run(steps))
        if profile_path:
            Path(profile_path).parent.mkdir(parents=True, exist_ok=True)
            Path(profile_path).write_text(json.dumps({"config": "blip", "steps": steps, **{k: prof[k] for k in (
                "wall_s", "device_busy_s", "groups_ms", "kernels")}}, indent=1))
        blip = {"phase": "blip", "argv": argv, "batch": b, "resolution": size, "steps": steps, "wall_s": wall,
                "img_per_s": b / wall, "fused_wall_s": ts, "fused_1step_s": t1, "s_per_step": s_step,
                "towers_ms": tower_ms, "towers_share_of_fused": tower_ms / 1e3 / ts,
                "towers_device_ms": towers["device_busy_s"] * 1e3, "towers_groups_ms": towers["groups_ms"],
                "towers_kernels": sum(k["calls"] for k in towers["kernels"]),
                "idle_share": prof["idle_share"], "profiled_wall_s": prof["wall_s"],
                "device_busy_s": prof["device_busy_s"], "groups_ms": prof["groups_ms"], "peak_mem_bytes": peak,
                "launches": counts, "launches_expected": want, "telemetry": tele.lines[0],
                "pngs_equal_fused": all(same), "subjects_equal_replay": all(subjects_equal),
                "uint8_mean": float(u8.mean()), "profile": profile_path}

        # card bf16 against the port on the CPU in f32, same weights: the
        # subject embeddings and the spliced text tower on the references of
        # items 0 and 2 (two classes: a class's two items may share one),
        # then the whole fused path on one 256^2 source at 2 steps
        t = time.perf_counter()
        cpu = BlipDiffusionPipeline(controlnet="canny", dtype=torch.float32, device="cpu", init_seed=None)
        copy_weights(pipe, cpu)
        cpu_setup_s = time.perf_counter() - t
        two, rs = [0, 2], BLIP_REFERENCE_RESOLUTION
        sub = {}
        for name, p in (("card", pipe), ("cpu", cpu)):
            e = p.subject_embeddings(p.params, refs[two], cat_ids[two], cat_mask[two])
            with torch.no_grad():
                h = p._encode_with_ctx(p.params, ids[two], e)
            sub[name] = (e.float().cpu(), h.float().cpu())
        cos_e = row_cosines(sub["card"][0], sub["cpu"][0])
        cos_h = row_cosines(sub["card"][1], sub["cpu"][1])
        centred = [cosine(sub["card"][0] - sub["card"][0].mean(0), sub["cpu"][0] - sub["cpu"][0].mean(0)),
                   cosine(sub["card"][1] - sub["card"][1].mean(0), sub["cpu"][1] - sub["cpu"][1].mean(0))]
        k = size // rs
        small = (ids[:1], neg_ids[:1], cat_ids[:1], cat_mask[:1], refs[:1], src[:1, ::k, ::k], lat[:1, ::k, ::k])
        outs_small = {}
        for name, p in (("cpu", cpu), ("card", pipe)):
            reset_counts()
            t = time.perf_counter()
            _, img = p.make_fused_generate(rs, rs, 2, 7.5)(p.params, *small, return_images=True)
            outs_small[name] = (img.float().cpu(), time.perf_counter() - t, read_counts())
        del cpu
        diff = (outs_small["card"][0] - outs_small["cpu"][0]).abs()
        small_counts = outs_small["card"][2]
        blip.update({"card_vs_cpu": {
            "refs": two, "subject_row_cosine_min": float(cos_e.min()), "text_row_cosine_min": float(cos_h.min()),
            "subject_centred_cosine": centred[0], "text_centred_cosine": centred[1],
            "fused_resolution": rs, "fused_mean_abs_diff": diff.mean().item(), "fused_max_abs_diff": diff.max().item(),
            "fused_launches": small_counts, "cpu_setup_s": cpu_setup_s, "cpu_s": outs_small["cpu"][1],
            "gpu_s": outs_small["card"][1], "cpu_threads": torch.get_num_threads()}})
        emit(blip)
        require(float(cos_e.min()) >= 0.99, "blip subject embeddings card vs CPU, row cosine", float(cos_e.min()))
        require(float(cos_h.min()) >= 0.99, "blip spliced text hidden states card vs CPU, row cosine",
                float(cos_h.min()))
        # with each side's mean over the two references taken off: what
        # depends on the reference image agrees too
        require(min(centred) >= 0.99, "blip card vs CPU, cosine without the mean over the references", centred)
        ran = [k for k, v in expected_counts(2, "default").items() if v > 0]
        require(all(small_counts[k] > 0 for k in ran), "blip reference run missed a kernel", small_counts)
        require(diff.mean().item() <= 0.02, "blip card vs CPU mean |diff|", diff.mean().item())
        del pipe
        torch.cuda.empty_cache()
        return counts
    finally:
        os.chdir(old_cwd)
        root_logger.removeHandler(tele)
        root_logger.setLevel(old_level)
        if old_root is None:
            os.environ.pop("SASPA_DATA_ROOT", None)
        else:
            os.environ["SASPA_DATA_ROOT"] = old_root
        shutil.rmtree(root, ignore_errors=True)


XL_STEPS = 2  # SDXL-Turbo's recipe (cub); the sd_xl CFG batch is cut from its 30 to the same 2
XL_EXTRA_STEPS = 4  # s/step: (time of XL_STEPS + 4 steps - time of XL_STEPS) / 4
XL_RESOLUTION = 512
XL_SOURCES = 8
CUB_CLASSES = ["001.Black_footed_Albatross", "002.Laysan_Albatross", "003.Sooty_Albatross",
               "004.Groove_billed_Ani"]


def expected_xl_counts(steps: int) -> dict:
    """Launches of one SDXL(-Turbo) + ControlNet-XL batch at 512^2 (64^2
    latents), default configuration, with or without CFG (XL runs no shared
    prefix: CFG doubles the batch, not the launches).  Per step: UNet 70 +
    ControlNet 34 transformer blocks (level 1 at 32^2: 4 + 6 + 4; level 2 and
    the mid block at 16^2: 20 + 10 + 30 + 20 + 10), each with one
    self-attention on K1, one K2 and two K4 (norm1, norm2); GroupNorms: UNet
    46 (17 resnets x 2, 11 Transformer2D norms, conv_norm_out), ControlNet 21
    (8 resnets x 2, 5 Transformer2D norms).  Per decode: the VAE's attention
    on K1 and its 30 GroupNorms.  The towers' 77-token attention and every
    cross-attention run plain; level 0 (64^2) has no attention."""
    return {"attention_packed": 104 * steps + 1, "ln_geglu": 104 * steps, "group_norm": 67 * steps + 30,
            "group_norm_tpu": 0, "layernorm": 208 * steps, "attention_block": 0, "flash_attention": 0, **F32_NONE}


def write_cub_tree(root, rng, n: int, size: int) -> list:
    """A synthetic CUB-200-2011 train split at root/CUB/CUB_200_2011 (the
    layout CUBUtils reads): n seeded size x size sources in 4 classes as PNG
    bytes under .jpg names none of which is in datasets_files/cub_val.txt,
    with images.txt, train_test_split.txt, classes.txt and
    image_class_labels.txt.  Returns the image paths under images/."""
    from pathlib import Path

    from saspa_tpu_torch.gen.image_io import write_png

    cub = Path(root) / "CUB/CUB_200_2011"
    names = [f"{CUB_CLASSES[i % 4]}/{CUB_CLASSES[i % 4].split('.', 1)[1]}_90{i:02d}_{700 + i}.jpg"
             for i in range(n)]
    val = set((Path(__file__).resolve().parent / "datasets_files/cub_val.txt").read_text().split())
    require(not val & set(names), "synthetic CUB names in the val carve-out", sorted(val & set(names)))
    for name, img in zip(names, synthetic_sources(rng, n, size)):
        (cub / "images" / name).parent.mkdir(parents=True, exist_ok=True)
        write_png(cub / "images" / name, img)
    (cub / "images.txt").write_text("".join(f"{i + 1} {nm}\n" for i, nm in enumerate(names)))
    (cub / "train_test_split.txt").write_text("".join(f"{i + 1} 1\n" for i in range(n)))
    (cub / "classes.txt").write_text("".join(f"{k + 1} {c}\n" for k, c in enumerate(CUB_CLASSES)))
    (cub / "image_class_labels.txt").write_text("".join(f"{i + 1} {i % 4 + 1}\n" for i in range(n)))
    return names


def run_xl_phase(seed: int, checks: dict, checked_sites: dict, profile_path=None) -> dict:
    """SDXL-Turbo + ControlNet-XL through `cli gen --dataset cub`, an sd_xl
    CFG batch, the XL kernel sites and the card against the CPU (module
    docstring, phase 10); returns the launch counts of both batches and
    appends the XL sites' K3, K4 and K5 rows to `checks`."""
    import gc
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, init_pipeline
    from saspa_tpu_torch.gen.image_io import read_png, read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.gen.tokenizer import NEGATIVE_PROMPT
    from saspa_tpu_torch.ops.canny import canny_control_image
    from saspa_tpu_torch.ops.image import resize_image
    from saspa_tpu_torch.utils import rng as rngs

    size, b, steps = XL_RESOLUTION, XL_SOURCES, XL_STEPS
    root = tempfile.mkdtemp(prefix="saspa_xl_")
    old_root = os.environ.get("SASPA_DATA_ROOT")
    os.environ["SASPA_DATA_ROOT"] = root
    tele = TelemetryHandler()
    root_logger = logging.getLogger()
    old_level = root_logger.level
    root_logger.setLevel(logging.INFO)
    root_logger.addHandler(tele)
    want = expected_xl_counts(steps)
    try:
        names = write_cub_tree(root, np.random.RandomState(seed + 401), b, size)
        argv = ["gen", "--dataset", "cub", "--skip_filter", "--num_per_image", "1", "--batch_size", str(b),
                "--seed", str(seed + 1)]
        cfg = cli.gen_config(cli.build_parser().parse_args(argv)).with_dataset_overrides()
        require((cfg.base_model, cfg.controlnet, cfg.num_inference_steps, cfg.guidance_scale, cfg.negative_prompt,
                 cfg.resolution) == ("sd_xl-turbo", "canny", steps, 0.0, None, size), "cub's recipe", cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()  # what earlier phases still hold
        reset_counts()
        t = time.perf_counter()
        folder = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        gc.collect()  # the driver's pipeline
        torch.cuda.empty_cache()
        require(len(tele.lines) == 1 and tele.lines[0]["num_errors"] == 0 and tele.lines[0]["total"] == b,
                "xl telemetry", tele.lines, *tele.errors)
        require(counts == want, "xl launch counts", counts, "expected", want)
        require(folder.endswith(f"/aug_data/controlnet/sd_xl-turbo/canny/{cfg.prompt_str}_seed_{seed + 1}/images"),
                "xl folder", folder)
        files = sorted(Path(folder).glob("*.png"))
        stems = [Path(n).stem for n in names]
        side = [f for f in files if f.stem.endswith(("_source", "_control"))]
        outs = {f.name.split("_prompt_")[0]: f for f in files if "_prompt_" in f.name}
        require(len(side) == 2 * b and sorted(outs) == sorted(stems), "xl files", [f.name for f in files])

        # the same batch through the fused function: same seeded weights,
        # prompts, sources and noise -> the PNGs' pixels, bit for bit
        ds = DS_UTILS_DICT["cub"](print_func=lambda *a: None)
        paths = ds.original_images_paths
        engine = PromptEngine(cfg, ds, ds.get_image_path_to_class_str_dict())
        prompts = [engine.build(pth, i, 0) for i, pth in enumerate(paths)]
        t = time.perf_counter()
        pipe = init_pipeline("sd_xl-turbo", "canny")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        require(pipe.scheduler.cfg.timestep_spacing == "trailing" and
                [int(x) for x in pipe.scheduler.timesteps(steps)] == [999, 499], "turbo's timesteps",
                pipe.scheduler.timesteps(steps))
        n_params = sum(p.numel() for m in pipe._modules() for p in m.parameters())
        src = np.stack([resize_image(read_rgb(pth), size) for pth in paths])
        lf = pipe.latent_factor
        lat = np.stack([rngs.item_normal(cfg.seed, "noise", i, 0, shape=(size // lf, size // lf, 4))
                        for i in range(b)])
        ids = pipe.tokenizer(prompts, pad="eot")
        neg_ids = pipe.tokenizer([""] * b, pad="eot")

        def fused_run(p, n_steps, gs, nids):
            fn = p.make_fused_generate(size, size, n_steps, gs, 0.75, 120.0, 200.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(p.params, ids, nids, src, lat, return_images=True)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        # one hooked warm-up step (it also builds the head-padded attention
        # weights, once per weight version): the XL sites of every norm and
        # self-attention
        sites, handles = record_sites(pipe)
        fused_run(pipe, 1, 0.0, neg_ids)
        for h in handles:
            h.remove()
        require({(bb, ll, hh) for bb, ll, _, hh in sites["self_attention"]} == {(b, 1024, 10), (b, 256, 20)},
                "xl self-attention sites", sorted(sites["self_attention"]))
        (u8, images), ts = fused_run(pipe, steps, 0.0, neg_ids)
        require(bool(torch.isfinite(images).all()), "xl: non-finite images before quantisation")
        u8 = u8.cpu().numpy()
        del images
        pngs = {s: read_png(outs[s]) for s in stems}
        same = [bool(np.array_equal(pngs[s], u8[k])) for k, s in enumerate(stems)]
        require(all(same), "xl PNGs differ from the fused function's output", same)
        _, t_more = fused_run(pipe, steps + XL_EXTRA_STEPS, 0.0, neg_ids)
        s_step = (t_more - ts) / XL_EXTRA_STEPS
        with torch.no_grad():
            towers_ms = cuda_ms(lambda: pipe.encode_ids(pipe.params["text"], ids), iters=5)

            def towers_run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pipe.encode_ids(pipe.params["text"], ids)
                torch.cuda.synchronize()
                return out, time.perf_counter() - t0

            towers = profile_run(towers_run)
        prof = profile_run(lambda: fused_run(pipe, steps, 0.0, neg_ids))
        if profile_path:
            Path(profile_path).parent.mkdir(parents=True, exist_ok=True)
            Path(profile_path).write_text(json.dumps({"config": "xl", "steps": steps, **{k: prof[k] for k in (
                "wall_s", "device_busy_s", "groups_ms", "kernels")}}, indent=1))

        # the XL sites of K3, K4 and K5 (the hooked step's) against their
        # plain versions, where the kernels phase has not checked them yet
        gen = torch.Generator(device="cuda").manual_seed(seed + 402)
        xl_rows = {}
        for name, check in (("group_norm", check_k3), ("layernorm", check_k4), ("attention_block", check_k5)):
            new = sites[name] - checked_sites[name]
            xl_rows[name] = check(gen, new)
            checks[name] += xl_rows[name]
            emit({"phase": "kernels", "kernel": name, "cell": "xl", "shapes": xl_rows[name]})
        require(len(xl_rows["layernorm"]) == 2 and len(xl_rows["attention_block"]) == 2,
                "xl LayerNorm and block-kernel sites", sorted(sites["layernorm"]), sorted(sites["attention_block"]))

        xl = {"phase": "xl", "argv": argv, "base_model": cfg.base_model, "controlnet": cfg.controlnet,
              "steps": steps, "timesteps": [int(x) for x in pipe.scheduler.timesteps(steps)],
              "guidance_scale": cfg.guidance_scale, "negative_prompt": cfg.negative_prompt, "batch": b,
              "resolution": size, "params": n_params, "init_s": init_s, "wall_s": wall, "img_per_s": b / wall,
              "fused_wall_s": ts, f"fused_{steps + XL_EXTRA_STEPS}step_s": t_more, "s_per_step": s_step,
              "fused_img_per_s": b / ts,
              "towers_ms": towers_ms, "towers_share_of_fused": towers_ms / 1e3 / ts,
              "towers_device_ms": towers["device_busy_s"] * 1e3, "towers_groups_ms": towers["groups_ms"],
              "towers_kernels": sum(k["calls"] for k in towers["kernels"]),
              "idle_share": prof["idle_share"], "profiled_wall_s": prof["wall_s"],
              "device_busy_s": prof["device_busy_s"], "groups_ms": prof["groups_ms"], "peak_mem_bytes": peak,
              "mem_before_bytes": mem_before, "launches": counts, "launches_expected": want,
              "telemetry": tele.lines[0], "pngs_equal_fused": all(same), "uint8_mean": float(u8.mean()),
              "profile": profile_path}

        # card bf16 against the port on the CPU in f32, same weights: both
        # towers on one prompt, then one UNet + ControlNet-XL step at B1 on
        # the same f32 inputs (the CPU towers' context and pooled embedding)
        t = time.perf_counter()
        cpu = DiffusionPipeline("sd_xl-turbo", "canny", dtype=torch.float32, device="cpu", init_seed=None)
        copy_weights(pipe, cpu)
        cpu_setup_s = time.perf_counter() - t
        tw = {}
        with torch.no_grad():
            for name, p in (("card", pipe), ("cpu", cpu)):
                t = time.perf_counter()
                tw[name] = [x.float().cpu() for x in p.encode_ids(p.params["text"], ids[:1])]
                tw[name + "_s"] = time.perf_counter() - t
        cos_hidden = row_cosines(tw["card"][0], tw["cpu"][0])
        cos_pooled = row_cosines(tw["card"][1], tw["cpu"][1])
        control = canny_control_image(torch.as_tensor(src[:1]).float(), 120.0, 200.0)
        x0 = torch.from_numpy(lat[:1]).permute(0, 3, 1, 2)
        ac = {"text_embeds": tw["cpu"][1], "time_ids": cpu.make_time_ids(1, size, size)}

        def step(p):
            dev = p.device
            with torch.no_grad():
                a = {k: v.to(dev) for k, v in ac.items()}
                x, ctx = x0.to(dev), tw["cpu"][0].to(dev)
                cn = p.params["controlnet"]
                dr, mr = cn(x, 999, ctx, cn.embed_cond(control.permute(0, 3, 1, 2).to(dev)), 0.75, a)
                return p.params["unet"](x, 999, ctx, dr, mr, a).float().cpu()

        t = time.perf_counter()
        eps_cpu = step(cpu)
        cpu_step_s = time.perf_counter() - t
        reset_counts()
        eps_card = step(pipe)
        step_counts = read_counts()
        del cpu
        gc.collect()
        cos_eps = cosine(eps_card, eps_cpu)
        xl["card_vs_cpu"] = {
            "hidden_row_cosine_min": float(cos_hidden.min()), "pooled_cosine": float(cos_pooled.min()),
            "eps_cosine": cos_eps, "eps_rel_err": rel_norm(eps_card, eps_cpu), "step_launches": step_counts,
            "cpu_setup_s": cpu_setup_s, "towers_cpu_s": tw["cpu_s"], "towers_card_s": tw["card_s"],
            "cpu_step_s": cpu_step_s, "cpu_threads": torch.get_num_threads()}
        require(float(cos_hidden.min()) >= 0.99, "xl towers' hidden states card vs CPU, row cosine",
                float(cos_hidden.min()))
        require(float(cos_pooled.min()) >= 0.99, "xl pooled embedding card vs CPU, cosine", float(cos_pooled.min()))
        require(cos_eps >= 0.99, "xl UNet + ControlNet step card vs CPU, eps cosine", cos_eps)
        require(all(step_counts[k] > 0 for k in ("attention_packed", "ln_geglu", "group_norm", "layernorm")),
                "xl card step missed a kernel", step_counts)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()

        # sd_xl, the same network under CFG 7.5 (leading timesteps, 2 of the
        # recipe's 30): the latents go in at 2B, every K1 site at B16
        t = time.perf_counter()
        sdxl = init_pipeline("sd_xl", "canny")
        torch.cuda.synchronize()
        init_cfg_s = time.perf_counter() - t
        require(sdxl.scheduler.cfg.timestep_spacing == "leading", "sd_xl's spacing", sdxl.scheduler.cfg)
        nids = sdxl.tokenizer([NEGATIVE_PROMPT] * b, pad="eot")
        sites, handles = record_sites(sdxl)
        fused_run(sdxl, 1, 7.5, nids)  # warm-up at B16, hooked
        for h in handles:
            h.remove()
        require({(bb, ll, hh) for bb, ll, _, hh in sites["self_attention"]} == {(2 * b, 1024, 10), (2 * b, 256, 20)},
                "sd_xl CFG self-attention sites", sorted(sites["self_attention"]))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (u8_cfg, images_cfg), ts_cfg = fused_run(sdxl, steps, 7.5, nids)
        counts_cfg = read_counts()
        peak_cfg = torch.cuda.max_memory_allocated()
        require(u8_cfg.shape == (b, size, size, 3) and bool(torch.isfinite(images_cfg).all()),
                "sd_xl output", tuple(u8_cfg.shape))
        require(counts_cfg == want, "sd_xl launch counts", counts_cfg, "expected", want)
        _, t_more_cfg = fused_run(sdxl, steps + XL_EXTRA_STEPS, 7.5, nids)
        xl["sd_xl_cfg"] = {"guidance_scale": 7.5, "steps": steps,
                           "timesteps": [int(x) for x in sdxl.scheduler.timesteps(steps)], "init_s": init_cfg_s,
                           "wall_s": ts_cfg, f"wall_{steps + XL_EXTRA_STEPS}step_s": t_more_cfg,
                           "s_per_step": (t_more_cfg - ts_cfg) / XL_EXTRA_STEPS,
                           "img_per_s": b / ts_cfg, "peak_mem_bytes": peak_cfg, "launches": counts_cfg,
                           "self_attention_sites": sorted(sites["self_attention"]),
                           "uint8_mean": float(u8_cfg.float().mean())}
        emit(xl)
        del sdxl, u8_cfg, images_cfg
        gc.collect()
        torch.cuda.empty_cache()
        return {"xl": counts, "xl_cfg": counts_cfg}
    finally:
        root_logger.removeHandler(tele)
        root_logger.setLevel(old_level)
        if old_root is None:
            os.environ.pop("SASPA_DATA_ROOT", None)
        else:
            os.environ["SASPA_DATA_ROOT"] = old_root
        shutil.rmtree(root, ignore_errors=True)


FILTER_RESOLUTION = 512
FILTER_THROUGHPUT_AUGS = 256
FILTER_BATCH = 64


def filter_telemetry(json_path) -> dict:
    """The filter's telemetry line, read from the log the builder writes
    beside its JSON (which proves the log is there)."""
    from pathlib import Path

    jp = Path(json_path)
    logs = sorted(jp.parent.glob(f"{jp.stem}_*.log"))
    require(logs, "no log beside", jp)
    lines = [ln.split("filter telemetry: ", 1)[1] for ln in logs[-1].read_text().splitlines()
             if "filter telemetry: " in ln]
    require(lines, "no filter telemetry in", logs[-1])
    return json.loads(lines[-1])


def topk_margins(logits: np.ndarray, owner: np.ndarray, k: int) -> np.ndarray:
    """> 0 where the owner's class is in the top k (the kept side), < 0
    where it is not: its logit less the (k+1)-th, or less the k-th."""
    k = min(k, logits.shape[1])
    top = -np.sort(-logits, axis=1)
    own = logits[np.arange(len(owner)), owner]
    in_top = (np.argsort(-logits, axis=1)[:, :k] == owner[:, None]).any(axis=1)
    nxt = top[:, k] if k < logits.shape[1] else np.full(len(owner), -np.inf)
    return np.where(in_top, own - nxt, own - top[:, k - 1])


def calibrate_batch_norm(model, images) -> None:
    """Sets each BatchNorm's mean and var to the statistics of its input
    over `images` ((H, W, 3) float32 arrays, preprocessed), layer after layer
    in one forward: each sees the layers before it already set."""
    from saspa_tpu_torch.models.layers import BatchNorm

    def take(mod, args):
        x = args[0].float()
        dims = [0] + list(range(2, x.ndim))
        mod.mean.copy_(x.mean(dims))
        mod.var.copy_(x.var(dims, unbiased=False))

    device = next(model.parameters()).device
    hooks = [m.register_forward_pre_hook(take) for m in model.modules() if isinstance(m, BatchNorm)]
    try:
        with torch.no_grad():
            model(torch.from_numpy(np.stack(images)).to(device).permute(0, 3, 1, 2))
    finally:
        for h in hooks:
            h.remove()


def run_filter_phase(steps: int, seed: int, smi: str, profile_path=None) -> dict:
    """The filter stage (module docstring, phase 6); returns the launch
    counts of its `gen` run."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.filters.aug_json import _clip_class_battery, get_aug_json_path
    from saspa_tpu_torch.filters.batches import score_in_batches
    from saspa_tpu_torch.filters.clip_filters import NEGATIVE_SEMANTIC_PROMPTS, TEXT_CFG, VISION_CFG, CLIPScorer, \
        clip_preprocess_path, per_class_keep, semantic_keep
    from saspa_tpu_torch.filters.confidence import BASELINE_NET, batched_logits, load_cal_baseline
    from saspa_tpu_torch.models.cal import WSDAN_CAL
    from saspa_tpu_torch.models.clip import CLIPModel
    from saspa_tpu_torch.gen.image_io import write_png

    size, n_src, per = FILTER_RESOLUTION, 8, 2
    root = Path(tempfile.mkdtemp(prefix="saspa_filter_"))
    env = {k: os.environ.get(k) for k in ("SASPA_DATA_ROOT", "SASPA_CHECKPOINTS")}
    os.environ["SASPA_DATA_ROOT"] = str(root)
    os.environ["SASPA_CHECKPOINTS"] = str(root / "checkpoints")  # none: seeded weights
    root_logger = logging.getLogger()
    old_handlers, old_level = root_logger.handlers[:], root_logger.level
    root_logger.setLevel(logging.INFO)
    try:
        ids = write_planes_tree(root, np.random.RandomState(seed + 301), n_src, size)
        # ---- gen without --skip_filter: generate 16 augs, then the recipe's JSON
        argv = ["gen", "--dataset", "planes", "--resolution", str(size), "--num_per_image", str(per),
                "--num_inference_steps", str(steps), "--batch_size", "8", "--seed", str(seed + 2)]
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        json_path = cli.main(argv)
        torch.cuda.synchronize()
        gen_wall = time.perf_counter() - t
        counts = read_counts()
        want = {k: per * v for k, v in expected_counts(steps, "default").items()}  # two batches of 8 at 512^2
        require(counts == want, "filter phase: gen launch counts", counts, "expected", want)
        ds = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        folder = Path(cli.gen_config(cli.build_parser().parse_args(argv)).with_dataset_overrides()
                      .output_folder(str(ds.root_path)))
        want_path = get_aug_json_path(str(folder), semantic_filtering=True, model_confidence_based_filtering=True)
        require(json_path == want_path and Path(want_path).name ==
                "semantic_filtering-model_confidence_based_filtering_top_10_classes-aug.json",
                "gen's aug-JSON path", json_path, want_path)
        gen_bytes = Path(json_path).read_bytes()
        recipe = json.loads(gen_bytes)
        augs = {i: sorted(str(f) for f in folder.glob(f"{i}_prompt_*.png")) for i in ids}
        require(sorted(recipe) == sorted(f"{i}.jpg" for i in ids), "aug-JSON keys", sorted(recipe))
        require(all(len(augs[i]) == per for i in ids), "generated files", augs)
        require(all(set(recipe[f"{i}.jpg"]) <= set(augs[i]) for i in ids), "aug-JSON values", recipe)
        flat = [p for i in ids for p in augs[i]]
        owner = np.asarray([ds.get_image_path_to_class_id_dict()[ds.original_images_paths[k]]
                            for k in range(n_src) for _ in range(per)])

        # ---- the same folder through `filter`: the recipe rebuilt, the other predicates
        reset_counts()
        t = time.perf_counter()
        rebuilt = cli.main(["filter", "--dataset", "planes", "--aug_folder", str(folder)])
        rebuild_wall = time.perf_counter() - t
        require(rebuilt == json_path and Path(rebuilt).read_bytes() == gen_bytes,
                "cli filter's rebuilt recipe JSON differs from gen's", rebuilt)
        tele_recipe = filter_telemetry(rebuilt)
        require(tele_recipe["images"] == 2 * len(flat), "recipe telemetry", tele_recipe)
        top2 = cli.main(["filter", "--dataset", "planes", "--aug_folder", str(folder), "--conf_top_k", "2"])
        per_class = cli.main(["filter", "--dataset", "planes", "--aug_folder", str(folder), "--clip_filtering",
                              "per_class", "--no_model_confidence", "--no_semantic_filtering"])
        for path, name in ((top2, "semantic_filtering-model_confidence_based_filtering_top_2_classes-aug.json"),
                           (per_class, "clip_filtering_per_class_discount_1.0-aug.json")):
            require(Path(path).name == name, "filter JSON name", path, name)
            filter_telemetry(path)
        merged_path = root / "merged" / "merged-aug.json"
        merged = cli.main(["merge-jsons", "--jsons", top2, per_class, "--output", str(merged_path)])
        js = {k: json.loads(Path(v).read_text()) for k, v in (("top2", top2), ("per_class", per_class))}
        require(merged == {i: js["top2"][i] + js["per_class"].get(i, []) for i in js["top2"]}
                and json.loads(merged_path.read_text()) == merged, "merge-jsons", merged)
        filter_counts = read_counts()
        require(not any(filter_counts.values()), "the filter path launched a K1-K6 kernel", filter_counts)

        # ---- card scores of every aug (the builder's batches), and f32 CPU scores of four
        scorer = CLIPScorer(device="cuda")
        cal, prep = load_cal_baseline("planes", ds.num_classes, device="cuda")
        classnames, prompts, key_to_class, _ = _clip_class_battery("planes", ds)
        batteries = {"semantic": [ds.get_basic_prompt()] + NEGATIVE_SEMANTIC_PROMPTS, "per_class": prompts}
        pick = [0, 5, 10, 15]
        sub = [flat[k] for k in pick]
        scorer_cpu = CLIPScorer(device="cpu")
        cal_cpu, _ = load_cal_baseline("planes", ds.num_classes, device="cpu")
        cpu_s = []

        def scores(clip_model, cal_model):
            """Card scores of every aug; f32 CPU scores of the picked four,
            the card's weights moved by state_dict."""
            scorer_cpu.model.load_state_dict(clip_model.state_dict())
            cal_cpu.load_state_dict(cal_model.state_dict())
            card = (score_in_batches(flat, clip_preprocess_path, clip_model.encode_image, FILTER_BATCH,
                                     VISION_CFG.output_dim, torch.device("cuda")),
                    batched_logits(cal_model, flat, prep, FILTER_BATCH))
            t = time.perf_counter()
            cpu = scorer_cpu.image_features(sub, len(sub)), batched_logits(cal_cpu, sub, prep, len(sub))
            cpu_s.append(time.perf_counter() - t)
            require(all(np.isfinite(a).all() for a in card + cpu), "non-finite filter scores")
            return card + cpu

        def agreement(card, cpu):
            """The card's scores of every aug against the CPU's of the picked
            four: the rows' spread over the augs (root mean square distance
            from their mean) beside the largest card-CPU row distance, and
            the agreement as it is and with each side's mean taken off."""
            c4 = card[pick]
            rows = (c4 * cpu).sum(1) / (np.linalg.norm(c4, axis=1) * np.linalg.norm(cpu, axis=1))
            cc, uc = (c4 - c4.mean(0)).ravel(), (cpu - cpu.mean(0)).ravel()
            spread = float(np.sqrt((np.linalg.norm(card - card.mean(0), axis=1) ** 2).mean()))
            gap = float(np.linalg.norm(c4 - cpu, axis=1).max())
            return {"spread": spread, "gap": gap, "spread_over_gap": spread / gap if gap else math.inf,
                    "cosine_min": float(rows.min()), "centered_cosine": float(cc @ uc / (np.linalg.norm(cc) *
                                                                                         np.linalg.norm(uc))),
                    "rel_err": float(np.abs(c4 - cpu).max() / np.abs(cpu).max())}

        feats_gpu, logits_gpu, feats_cpu, logits_cpu = scores(scorer.model, cal)
        txt_gpu = {k: scorer.text_features(v) for k, v in batteries.items()}
        txt_cpu = {k: scorer_cpu.text_features(v) for k, v in batteries.items()}
        seeded = {"clip_features": agreement(feats_gpu, feats_cpu), "cal_logits": agreement(logits_gpu, logits_cpu)}
        require(seeded["clip_features"]["cosine_min"] >= 0.99, "CLIP image features, card vs CPU f32", seeded)
        require(seeded["cal_logits"]["rel_err"] <= 0.02, "CAL logits, card vs CPU f32: max |diff| / max |logit|",
                seeded)
        for what, a in seeded.items():
            require(a["centered_cosine"] >= 0.99, what, "card vs CPU f32 without the batch mean", a)

        # keep decisions: the card's JSONs against the card's scores (exact) and
        # against the CPU's f32 scores (a flip only where the CPU's margin lies
        # within the measured gap: the largest difference of that rule's scores)
        def rules_of(feats, logits, txt, scale, rows):
            """rule -> (keep, margin (>= 0 on the kept side), scores) as the builder decides."""
            sem = scale * feats @ txt["semantic"].T
            cls = scale * feats @ txt["per_class"].T
            ex = np.exp(cls - cls.max(1, keepdims=True))
            probs = ex / ex.sum(1, keepdims=True)
            own = np.asarray([classnames.index(key_to_class[Path(ds.original_images_paths[k // per]).stem])
                              for k in rows])
            thr = 1 / len(classnames)
            out = {"semantic": (semantic_keep(sem), sem[:, 0] - sem[:, 1:].max(1), sem),
                   "per_class": (per_class_keep(cls, own, thr), probs[np.arange(len(rows)), own] - thr, probs)}
            for k in (2, 10):
                top = np.argsort(-logits, axis=-1)[:, :min(k, logits.shape[1])]
                out[f"top{k}"] = ((top == owner[rows][:, None]).any(-1), topk_margins(logits, owner[rows], k), logits)
            return out

        card = rules_of(feats_gpu, logits_gpu, txt_gpu, scorer.logit_scale, list(range(len(flat))))
        cpu = rules_of(feats_cpu, logits_cpu, txt_cpu, scorer.logit_scale, pick)
        gaps = {r: float(np.abs(card[r][2][pick] - cpu[r][2]).max()) for r in card}
        rules = {"recipe": ("semantic", "top10"), "top2": ("semantic", "top2"), "per_class": ("per_class",)}
        got_json = {"recipe": recipe, "top2": js["top2"], "per_class": js["per_class"]}
        flips, decisions = [], {}
        for name, parts in rules.items():
            kept = {p for v in got_json[name].values() for p in v}
            in_json = np.asarray([p in kept for p in flat])
            card_keep = np.all([card[r][0] for r in parts], axis=0)
            require(np.array_equal(in_json, card_keep), name, "JSON differs from the card's own scores",
                    in_json.tolist(), card_keep.tolist())
            for j, k in enumerate(pick):
                if all(cpu[r][0][j] for r in parts) != in_json[k]:
                    near = [r for r in parts if cpu[r][0][j] != card[r][0][k] and abs(cpu[r][1][j]) <= gaps[r]]
                    require(near, name, "keep decision of", flat[k], "differs from the CPU's beyond the gap")
                    flips.append({"json": name, "aug": Path(flat[k]).name, "rules": near})
            decisions[name] = int(in_json.sum())

        # The seeded BatchNorms (mean 0, var 1) leave a component common to
        # every image on top of the outputs: the scores above spread over the
        # augs by only a few of bf16's steps.  The same weights with each
        # BatchNorm's statistics taken from these 16 augs (as a trained
        # network holds them) spread them widely, but subtract large means
        # that bf16 resolves coarsely; so that comparison runs the card's path
        # in f32 (TF32 off), where the spread must stand 10x above the gap.
        clip32 = CLIPModel("rn50", VISION_CFG, TEXT_CFG, dtype=torch.float32, device="cuda").eval()
        clip32.load_state_dict(scorer.model.state_dict())
        cal32 = WSDAN_CAL(ds.num_classes, M=32, net=BASELINE_NET, dtype=torch.float32, device="cuda").eval()
        cal32.load_state_dict(cal.state_dict())
        calibrate_batch_norm(clip32.visual, [clip_preprocess_path(f) for f in flat])
        calibrate_batch_norm(cal32, [prep(f) for f in flat])
        fg, lg, fc, lc = scores(clip32, cal32)
        calibrated = {"clip_features": agreement(fg, fc), "cal_logits": agreement(lg, lc)}
        emit({"phase": "filter_agreement", "augs": len(flat), "picked": pick, "seeded_bf16": seeded,
              "calibrated_f32": calibrated, "score_gaps": gaps})
        for what, a in calibrated.items():
            require(a["spread"] >= 10 * a["gap"], what, "of the calibrated models: spread over the augs not 10x"
                    " the card-CPU gap", a)
            require(a["centered_cosine"] >= 0.99, what, "of the calibrated models: card vs CPU f32 without the"
                    " batch mean", a)
        require(calibrated["clip_features"]["cosine_min"] >= 0.99, "calibrated CLIP features, card vs CPU f32",
                calibrated)
        require(calibrated["cal_logits"]["rel_err"] <= 0.02, "calibrated CAL logits, card vs CPU f32", calibrated)
        del clip32, cal32, scorer_cpu, cal_cpu
        emit({"phase": "filter", "gen_argv": argv, "augs": len(flat), "gen_wall_s": gen_wall,
              "rebuild_wall_s": rebuild_wall, "launches": counts, "launches_expected": want,
              "filter_launches": filter_counts, "kept": decisions,
              "clip_cosine_min": seeded["clip_features"]["cosine_min"],
              "cal_rel_err": seeded["cal_logits"]["rel_err"], "score_gaps": gaps, "decision_flips_within_gap": flips,
              "cpu_reference_s": cpu_s, "cpu_threads": torch.get_num_threads(), "telemetry_recipe": tele_recipe})
        del scorer, cal
        torch.cuda.empty_cache()

        # ---- throughput: 256 synthetic 512^2 PNG augs through `filter`, batch 64
        tp = root / "throughput" / "images"
        tp.mkdir(parents=True)
        distinct = synthetic_sources(np.random.RandomState(seed + 302), 16, size)
        for k in range(16):
            write_png(tp / f"src_{k}.png", distinct[k])
        blobs = [(tp / f"src_{k}.png").read_bytes() for k in range(16)]
        for k in range(FILTER_THROUGHPUT_AUGS):
            (tp / f"{ids[k % n_src]}_prompt_synthetic_{k}.png").write_bytes(blobs[k % 16])
        for k in range(16):
            (tp / f"src_{k}.png").unlink()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        tp_json = cli.main(["filter", "--dataset", "planes", "--aug_folder", str(tp), "--batch_size",
                            str(FILTER_BATCH)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        tele = filter_telemetry(tp_json)
        require(tele["images"] == 2 * FILTER_THROUGHPUT_AUGS and
                tele["batches"] == 2 * math.ceil(FILTER_THROUGHPUT_AUGS / FILTER_BATCH), "throughput telemetry", tele)
        scored = sum(len(v) for v in json.loads(Path(tp_json).read_text()).values())
        emit({"phase": "filter_throughput", "augs": FILTER_THROUGHPUT_AUGS, "resolution": size,
              "batch": FILTER_BATCH, "wall_s": wall, "augs_per_s": FILTER_THROUGHPUT_AUGS / wall,
              "host_preprocess_s": tele["preprocess_s"], "device_s": tele["device_s"], "verify_s": tele["verify_s"],
              "scoring_augs_per_s": FILTER_THROUGHPUT_AUGS / (tele["preprocess_s"] + tele["device_s"]),
              "kept": scored, "peak_mem_bytes": peak, "nvidia_smi": smi})
        if profile_path:  # the scoring of the same 256 augs, both models built beforehand
            scorer = CLIPScorer(device="cuda")
            cal, prep = load_cal_baseline("planes", ds.num_classes, device="cuda")
            paths = sorted(str(p) for p in tp.glob("*.png"))

            def score():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scorer.image_features(paths, FILTER_BATCH)
                batched_logits(cal, paths, prep, FILTER_BATCH)
                torch.cuda.synchronize()
                return None, time.perf_counter() - t0

            score()  # warm-up
            profile_main(score, profile_path, 1, "filter_256")
            del scorer, cal
            torch.cuda.empty_cache()
        return counts
    finally:
        for h in root_logger.handlers[:]:
            if h not in old_handlers:
                root_logger.removeHandler(h)
                h.close()
        for h in old_handlers:
            if h not in root_logger.handlers:
                root_logger.addHandler(h)
        root_logger.setLevel(old_level)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


TRAIN_CLASSES = 100  # FGVC-Aircraft's variants: the planes width of fc
TRAIN_SPLITS = {"train": 64, "val": 16, "test": 16}
TRAIN_SOURCE_HW = (700, 1000)  # about FGVC-Aircraft's image size
TRAIN_AUGS = 2  # seeded 512^2 PNG augs a train image in the aug-JSON
TRAIN_BATCHES = (4, 16)  # the planes preset's batch, and cub/dtd's
TRAIN_TIMED_STEPS = 20
TRAIN_PROFILED_STEPS = 2
TRAIN_COMPARE_STEPS = 3


TRAIN_DISTINCT = 16  # distinct encoded images of each kind; the tree's files repeat their bytes


def write_train_tree(root, seed: int):
    """A synthetic FGVC-Aircraft tree of 100 classes: seeded sources of
    about 1000 x 700 as PNG bytes under .jpg names, split 64 / 16 / 16,
    and an aug-JSON of 2 seeded 512^2 PNG augs a train image; the files
    repeat the bytes of 16 distinct encoded sources and 16 augs (decoding
    costs the same).  Returns the aug-JSON's path."""
    from pathlib import Path

    from saspa_tpu_torch.gen.image_io import write_png

    rng = np.random.RandomState(seed)
    data = Path(root) / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    (data / "images").mkdir(parents=True)
    classes = [f"variant-{i:03d}" for i in range(TRAIN_CLASSES)]
    (data / "variants.txt").write_text("".join(c + "\n" for c in classes))
    aug_dir = Path(root) / "augs"
    aug_dir.mkdir()
    blobs = {}
    for kind in ("source", "aug"):
        for j in range(TRAIN_DISTINCT):
            h, w = (d + rng.randint(-40, 41) for d in TRAIN_SOURCE_HW) if kind == "source" else (512, 512)
            pth = Path(root) / f"{kind}_{j}.png"
            write_png(pth, synthetic_sources(rng, 1, h, w)[0])
            blobs[kind, j] = pth.read_bytes()
            pth.unlink()
    augs, k = {}, 0
    for shift, (split, n) in enumerate(TRAIN_SPLITS.items()):
        lines = []
        for i in range(n):
            image_id = f"{2000000 + 7 * k:07d}"
            # a split's i-th image takes label i % 100 and source (i + 5 * shift) % 16: val and test differ
            (data / "images" / f"{image_id}.jpg").write_bytes(blobs["source", (i + 5 * shift) % TRAIN_DISTINCT])
            lines.append(f"{image_id} {classes[i % TRAIN_CLASSES]}\n")
            if split == "train":
                paths = [aug_dir / f"{image_id}_prompt_synthetic_{j}.png" for j in range(TRAIN_AUGS)]
                for j, pth in enumerate(paths):
                    pth.write_bytes(blobs["aug", (TRAIN_AUGS * k + j) % TRAIN_DISTINCT])
                augs[f"{image_id}.jpg"] = [str(pth) for pth in paths]
            k += 1
        (data / f"images_variant_{split}.txt").write_text("".join(lines))
    aug_json = Path(root) / "aug.json"
    aug_json.write_text(json.dumps(augs))
    return aug_json


def train_draws(rng, b: int, m: int, hw: int):
    """Seeded draws of one train step (fake attention, picks, thetas), as
    numpy arrays in the port's layout."""
    return {"fake1": rng.uniform(0, 2, (b, m, hw, hw)), "pick1": rng.randint(0, m, (b, 2)),
            "fake2": rng.uniform(0, 2, (2 * b, m, hw, hw)), "pick2": rng.randint(0, m, (2 * b, 2)),
            "crop_theta": rng.uniform(0.4, 0.6, b), "drop_theta": rng.uniform(0.2, 0.5, b)}


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu().ravel(), b.detach().double().cpu().ravel()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def feature_side(net: str, size: int) -> int:
    """The side of a WSDAN-CAL backbone's feature map at size^2 (a forward on
    the meta device)."""
    from saspa_tpu_torch.models.cal import WSDAN_CAL

    model = WSDAN_CAL(num_classes=1, net=net, device="meta")
    return int(model.features(torch.zeros(1, 3, size, size, device="meta")).shape[-1])


def card_vs_cpu(cfg, dtype, lr: float, seed: int, soft: bool = False, steps: int = TRAIN_COMPARE_STEPS) -> list:
    """`steps` train steps of one seeded full-width model (cfg.net) on the
    card and through the port on the CPU (weights moved by state_dict), on
    the same seeded batches with the same injected draws, all in `dtype`;
    the per-step agreement.  With soft, each step also takes seeded soft
    labels (each label mixed with another's, as CutMix leaves them)."""
    from saspa_tpu_torch.fgvc import train as ttrain

    cfg = cfg.replace(compute_dtype="float32", learning_rate=lr)
    b, m = cfg.batch_size, cfg.num_attentions
    hw = feature_side(cfg.net, cfg.image_size[0])
    states = {}
    for dev in ("cuda", "cpu"):
        st = ttrain.create_train_state(cfg, TRAIN_CLASSES, device=dev, init_seed=seed)
        if dtype == torch.float64:
            for mod in st.model.modules():
                if hasattr(mod, "dtype"):
                    mod.dtype = torch.float64
            st.model.to(torch.float64)
            st.momentum = {n: p.to(torch.float64) for n, p in st.momentum.items()}
            st.feature_center = st.feature_center.to(torch.float64)
        states[dev] = st
    states["cpu"].model.load_state_dict({k: v.cpu() for k, v in states["cuda"].model.state_dict().items()})
    step = ttrain.make_train_step(cfg, 16)
    rng = np.random.RandomState(seed + 1)
    rows = []
    for s in range(steps):
        X = rng.randn(b, 3, *cfg.image_size)
        y = rng.randint(0, TRAIN_CLASSES, b)
        draws = train_draws(rng, b, m, hw)
        y_soft = None
        if soft:
            lam, eye = rng.uniform(0.2, 1.0, (b, 1)), np.eye(TRAIN_CLASSES)
            y_soft = lam * eye[y] + (1 - lam) * eye[y[rng.permutation(b)]]
        key = np.array([0, s], np.uint32)
        out, times = {}, {}
        for dev, st in states.items():
            d = {k: torch.from_numpy(v).to(dev, dtype if v.dtype.kind == "f" else torch.long) for k, v in draws.items()}
            ys = None if y_soft is None else torch.from_numpy(y_soft).to(dev, dtype)
            fc_before = st.model.fc.kernel.detach().clone()
            t = time.perf_counter()
            met = step(st, torch.from_numpy(X).to(dev, dtype), torch.from_numpy(y).to(dev), key, y_soft=ys, draws=d)
            if dev == "cuda":
                torch.cuda.synchronize()
            times[dev] = time.perf_counter() - t
            out[dev] = (met["loss"].item(), st.model.fc.kernel.detach() - fc_before)
        sg, sc = states["cuda"].model.state_dict(), states["cpu"].model.state_dict()
        stats = [k for k in sc if k.endswith((".mean", ".var"))]
        rows.append({"step": s, "loss_card": out["cuda"][0], "loss_cpu": out["cpu"][0],
                     "loss_rel": abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0]),
                     "feature_center_cos": cosine(states["cuda"].feature_center, states["cpu"].feature_center),
                     "fc_update_cos": cosine(out["cuda"][1], out["cpu"][1]),
                     "running_stats_rel": max(rel_norm(sg[k], sc[k]) for k in stats),
                     "card_s": times["cuda"], "cpu_s": times["cpu"]})
    del states
    torch.cuda.empty_cache()
    return rows


def run_train_phase(seed: int, smi: str, profile_path=None) -> dict:
    """The train stage (module docstring, phase 7); returns its launch
    counts (all 0: the train path runs none of K1-K6)."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data import datasets as tds
    from saspa_tpu_torch.data.pipeline import InputPipeline
    from saspa_tpu_torch.fgvc import runner
    from saspa_tpu_torch.fgvc import train as ttrain
    from saspa_tpu_torch.models.cal import sample_attention_maps
    from saspa_tpu_torch.ops.augment import train_transform_batch, val_transform_batch
    from saspa_tpu_torch.ops.batch_augment import batch_augment
    from saspa_tpu_torch.utils import rng as rngs
    from saspa_tpu_torch.utils.config import get_train_config

    root = Path(tempfile.mkdtemp(prefix="saspa_train_"))
    old_root = os.environ.get("SASPA_DATA_ROOT")
    os.environ["SASPA_DATA_ROOT"] = str(root)
    root_logger = logging.getLogger()
    old_handlers, old_level = root_logger.handlers[:], root_logger.level
    sampler_call = tds.AugSampler.__call__
    calls = []

    def recording_call(self, image_path, idx=0):
        out = sampler_call(self, image_path, idx)
        calls.append(out)
        return out

    try:
        t = time.perf_counter()
        aug_json = write_train_tree(root, seed + 401)
        tree_s = time.perf_counter() - t
        argv = ["train", "--dataset", "planes", "--aug_json", str(aug_json), "--aug_sample_ratio", "0.4",
                "--limit_aug_per_image", "2", "--special_aug", "classic", "--epochs", "1", "--seed", "1",
                "--logdir", str(root / "logs")]
        # ---- the recipe through `cli train`: 16 steps, validation, test, checkpoint
        tds.AugSampler.__call__ = recording_call
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()  # what earlier phases still hold
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        logs = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        tds.AugSampler.__call__ = sampler_call
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        require(all(v == 0 for v in counts.values()), "train: the train path launched a kernel of K1-K6", counts)
        lines = [json.loads(ln) for ln in (Path(logs["save_dir"]) / "metrics.jsonl").read_text().splitlines()]
        epoch = lines[0]
        require(epoch["steps"] == TRAIN_SPLITS["train"] // 4 and math.isfinite(epoch["train_loss"]),
                "train: the epoch's metrics", epoch)
        val = next(ln for ln in lines if "val_loss" in ln)
        test = next(ln for ln in lines if "test_loss" in ln)
        require(all(math.isfinite(v) for v in (val["val_loss"], test["test_loss"])), "train: eval metrics", lines)
        require(Path(logs["ckpt_path"]).exists(), "train: no checkpoint at", logs["ckpt_path"])

        # the AugSampler's substitutions, replayed on the host in the pipeline's order
        train_ds = tds.get_datasets("planes", aug_json=str(aug_json), aug_sample_ratio=0.4, limit_aug_per_image=2,
                                    special_aug="classic", seed=1, print_func=lambda *a: None)[0]
        order = np.arange(len(train_ds))
        np.random.RandomState(1 * 100003 + 0).shuffle(order)
        replay = [train_ds.item_path(int(i))[0] for i in order]
        require(calls == replay, "train: the AugSampler's substitutions differ from the host replay")
        substituted = sum("_prompt_synthetic_" in pth for pth in calls)

        # ---- the checkpoint through --ckpt: the same test metrics
        t = time.perf_counter()
        again = runner.evaluate_checkpoint(cli.build_parser().parse_args(argv + ["--ckpt", logs["ckpt_path"]]))
        reload_s = time.perf_counter() - t
        same = (again["test_loss"] == test["test_loss"] and again["test_topk_accuracy"][0] == test["test_topk_accuracy"]
                and again["test_mean_class_acc"] == test["test_mean_class_acc"])
        require(same, "train: --ckpt's test metrics differ from the run's", again, test)
        emit({"phase": "train", "argv": argv, "tree_s": tree_s, "wall_s": wall, "steps": epoch["steps"],
              "epoch": epoch, "val": val, "test": test, "reloaded_test": {k: again[k] for k in (
                  "test_loss", "test_topk_accuracy", "test_mean_class_acc")}, "reload_s": reload_s,
              "aug_substitutions": substituted, "sampler_calls": len(calls), "peak_mem_bytes": peak,
              "peak_mem_above_base_bytes": peak - base_mem,
              "launches": counts, "pipeline_timings": logs["pipeline_timings"]})

        # ---- host draws and views: card against CPU on the same inputs
        rng = np.random.RandomState(seed + 402)
        u8 = torch.from_numpy(rng.randint(0, 256, (16, 256, 256, 3)).astype(np.uint8))
        key = rngs.item_key(1, "augment", 0, 0)
        views_equal = {
            "classic": torch.equal(train_transform_batch(u8.cuda(), key, "classic", 224, 224).cpu(),
                                   train_transform_batch(u8, key, "classic", 224, 224)),
            "val": torch.equal(val_transform_batch(u8.cuda(), 224, 224).cpu(), val_transform_batch(u8, 224, 224))}
        att = torch.from_numpy((np.maximum(rng.randn(16, 32, 14, 14), 0) * rng.uniform(0.1, 3, (1, 32, 1, 1)))
                               .astype(np.float32))
        pick_key = rngs.item_key(1, "dropout", 0, 0)
        _, picks_card = sample_attention_maps(att.cuda(), pick_key, return_picks=True)
        _, picks_cpu = sample_attention_maps(att, pick_key, return_picks=True)
        picks_equal = float((picks_card.cpu() == picks_cpu).float().mean())
        X = torch.from_numpy(rng.randn(16, 3, 224, 224).astype(np.float32))
        aug_err = {}
        for mode, theta in (("crop", (0.4, 0.6)), ("drop", (0.2, 0.5))):
            a = batch_augment(X.cuda(), att[:, 0].cuda(), pick_key, mode=mode, theta=theta).cpu()
            b = batch_augment(X, att[:, 0], pick_key, mode=mode, theta=theta)
            aug_err[mode] = float((a - b).abs().max())
        emit({"phase": "train_draws", "views_bit_equal": views_equal, "picks_equal_share": picks_equal,
              "batch_augment_max_abs_err": aug_err})
        require(all(views_equal.values()), "train: the card's transforms differ from the CPU's", views_equal)
        require(picks_equal == 1.0, "train: the card's attention picks differ from the CPU's", picks_equal)
        require(max(aug_err.values()) <= 1e-6, "train: the card's attention crop/drop differ from the CPU's", aug_err)

        # ---- the step on the card against the port on the CPU, full width, batch 4
        cfg = get_train_config("planes")
        cmp = {}
        t = time.perf_counter()
        cmp["f64"] = card_vs_cpu(cfg, torch.float64, cfg.learning_rate, seed + 403)
        cmp["f32"] = card_vs_cpu(cfg, torch.float32, cfg.learning_rate, seed + 403)
        emit({"phase": "train_card_vs_cpu", "cpu_threads": torch.get_num_threads(), "seconds":
              time.perf_counter() - t, **cmp})
        for r in cmp["f64"]:
            require(r["loss_rel"] <= 1e-6 and r["running_stats_rel"] <= 1e-4 and r["feature_center_cos"] >= 0.9999
                    and r["fc_update_cos"] >= 0.9999, "train: the card's f64 steps differ from the CPU's", r)
        for r in cmp["f32"]:  # f32 rounding grows through the seeded train-mode ResNet (docstring)
            require(r["loss_rel"] <= 1e-2 and r["feature_center_cos"] >= 0.99 and r["fc_update_cos"] >= 0.98
                    and r["running_stats_rel"] <= (0.1 if r["step"] == 0 else 0.5),
                    "train: the card's f32 steps differ from the CPU's", r)

        # ---- bf16 on one fixed batch: the loss falls
        state = ttrain.create_train_state(cfg, TRAIN_CLASSES, device="cuda", init_seed=seed)
        step = ttrain.make_train_step(cfg, 16)
        pipe = InputPipeline(train_ds, cfg.batch_size, resize=cfg.image_size, train_transform="classic", seed=1,
                             device="cuda")
        Xf, yf, _ = next(iter(pipe.iter_train(0)))
        losses = [step(state, Xf, yf, rngs.item_key(1, "dropout", 0, i))["loss"].item() for i in range(10)]
        emit({"phase": "train_fixed_batch", "dtype": "bfloat16", "losses": losses})
        require(all(math.isfinite(v) for v in losses) and min(losses[-3:]) < losses[0],
                "train: the bf16 loss did not fall on a fixed batch", losses)
        del state

        # ---- throughput: the input pipeline feeding the step, batch 4 and 16
        for b in TRAIN_BATCHES:
            cfg_b = get_train_config("planes", batch_size=b)
            state = ttrain.create_train_state(cfg_b, TRAIN_CLASSES, device="cuda", init_seed=seed)
            ds = tds.get_datasets("planes", aug_json=str(aug_json), aug_sample_ratio=0.4, limit_aug_per_image=2,
                                  special_aug="classic", seed=1, print_func=lambda *a: None)[0]
            pipe = InputPipeline(ds, b, resize=cfg_b.image_size, train_transform="classic", seed=1,
                                 num_threads=cfg_b.workers * 2, device="cuda")
            step = ttrain.make_train_step(cfg_b, len(pipe))

            def batches():
                e = 0
                while True:
                    yield from pipe.iter_train(e)
                    e += 1

            it = batches()

            def run_steps(n):
                wait = dispatch = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(n):
                    ta = time.perf_counter()
                    X, y, _ = next(it)
                    tb = time.perf_counter()
                    step(state, X, y, rngs.item_key(1, "dropout", 9, i))
                    dispatch += time.perf_counter() - tb
                    wait += tb - ta
                tc = time.perf_counter()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                return (wait, dispatch, t1 - tc), t1 - t0

            run_steps(3)  # warm-up: cuDNN's heuristics, the allocator
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")  # a warning for each stream synchronization
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    X, y, _ = next(it)
                    step(state, X, y, rngs.item_key(1, "dropout", 9, TRAIN_TIMED_STEPS))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
            require(not syncs, "train: a batch and step synchronized the stream", syncs[:5])
            load0 = pipe.timings["load_s"]
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated() - sum(  # what earlier phases still hold
                t.numel() * t.element_size() for t in (*state.model.parameters(), *state.model.buffers(),
                                                       *state.momentum.values(), state.feature_center))
            torch.cuda.reset_peak_memory_stats()
            (wait, dispatch, sync_wait), wall = run_steps(TRAIN_TIMED_STEPS)
            load = pipe.timings["load_s"] - load0
            peak = torch.cuda.max_memory_allocated()
            t = time.perf_counter()
            prof = profile_run(lambda: run_steps(TRAIN_PROFILED_STEPS))
            profile_s = time.perf_counter() - t
            kernels = sum(r["calls"] for r in prof["kernels"]) / TRAIN_PROFILED_STEPS
            emit({"phase": "train_throughput", "batch": b, "steps": TRAIN_TIMED_STEPS, "wall_s": wall,
                  "s_per_step": wall / TRAIN_TIMED_STEPS, "img_per_s": b * TRAIN_TIMED_STEPS / wall,
                  "host_input_wait_s": wait, "host_input_load_s": load, "host_step_dispatch_s": dispatch,
                  "host_sync_wait_s": sync_wait, "syncs_per_step": len(syncs),
                  "profiled_steps": TRAIN_PROFILED_STEPS, "profiled_wall_s": prof["wall_s"],
                  "device_busy_s": prof["device_busy_s"], "idle_share": prof["idle_share"],
                  "kernels_per_step": kernels, "groups_ms": prof["groups_ms"], "profile_s": profile_s,
                  "peak_mem_bytes": peak, "peak_mem_above_base_bytes": peak - base_mem, "nvidia_smi": smi})
            if profile_path:
                out = Path(profile_path) if b == TRAIN_BATCHES[0] else Path(profile_path).with_name(
                    f"{Path(profile_path).stem}_b{b}{Path(profile_path).suffix}")
                out.parent.mkdir(parents=True, exist_ok=True)
                out.write_text(json.dumps({"config": f"train_b{b}", "steps": TRAIN_PROFILED_STEPS, **prof}, indent=1))
            del state, it
            torch.cuda.empty_cache()
        return read_counts()
    finally:
        tds.AugSampler.__call__ = sampler_call
        for h in root_logger.handlers[:]:
            if h not in old_handlers:
                root_logger.removeHandler(h)
                h.close()
        for h in old_handlers:
            if h not in root_logger.handlers:
                root_logger.addHandler(h)
        root_logger.setLevel(old_level)
        if old_root is None:
            os.environ.pop("SASPA_DATA_ROOT", None)
        else:
            os.environ["SASPA_DATA_ROOT"] = old_root
        shutil.rmtree(root, ignore_errors=True)


# the paper's best train recipes (saspa_tpu/gen/recipes.py:17-23) at their datasets' presets:
# (dataset, --special_aug, extra cli flags, preset batch, steps of the epoch)
RECIPES = (("dtd", "classic-cutmix", ("--aug_sample_ratio", "0.4", "--limit_aug_per_image", "2"), 16, 4),
           ("compcars-parts", "randaug-cutmix", ("--train_sample_ratio", "0.01"), 8, 4))
DTD_CLASSES = 47  # DTD's categories: dtd's width of fc
DTD_SPLITS = {"train": 64, "val": 32, "test": 32}  # one eval batch (batch_size * 2) each for val and test
DTD_SOURCE_HW = 400  # about DTD's image size (300-640)
COMPCARS_SOURCE_HW = 48  # small: the shipped test split's 4,683 images and val's 1,838 are all decoded
RECIPE_TIMED_STEPS = 10


def write_dtd_train_tree(root, seed: int):
    """A synthetic DTD tree at root/DTD/dtdataset/dtd of 47 class folders,
    labels/{train,val,test}1.txt of 64 / 32 / 32 seeded PNG sources (the
    bytes of 8 distinct ones, under .jpg names), and an aug-JSON of 2 seeded
    512^2 PNG augs a train image.  Returns the aug-JSON's path."""
    from pathlib import Path

    from saspa_tpu_torch.gen.image_io import write_png

    rng = np.random.RandomState(seed)
    dtd = Path(root) / "DTD/dtdataset/dtd"
    (dtd / "labels").mkdir(parents=True)
    aug_dir = Path(root) / "dtd_augs"
    aug_dir.mkdir()
    blobs = {}
    for kind, size in (("source", DTD_SOURCE_HW), ("aug", 512)):
        for j in range(8):
            pth = Path(root) / f"dtd_{kind}_{j}.png"
            write_png(pth, synthetic_sources(rng, 1, size)[0])
            blobs[kind, j] = pth.read_bytes()
            pth.unlink()
    classes = [f"texture{c:02d}" for c in range(DTD_CLASSES)]
    augs, k = {}, 0
    for split, n in DTD_SPLITS.items():
        lines = []
        for i in range(n):
            rel = f"{classes[i % DTD_CLASSES]}/{classes[i % DTD_CLASSES]}_{k:04d}.jpg"
            (dtd / "images" / rel).parent.mkdir(parents=True, exist_ok=True)
            (dtd / "images" / rel).write_bytes(blobs["source", k % 8])
            lines.append(rel + "\n")
            if split == "train":
                paths = [aug_dir / f"{Path(rel).stem}_prompt_synthetic_{j}.png" for j in range(2)]
                for j, pth in enumerate(paths):
                    pth.write_bytes(blobs["aug", (2 * k + j) % 8])
                augs[Path(rel).name] = [str(pth) for pth in paths]
            k += 1
        (dtd / "labels" / f"{split}1.txt").write_text("".join(lines))
    aug_json = Path(root) / "dtd_aug.json"
    aug_json.write_text(json.dumps(augs))
    return aug_json


def write_compcars_tree(root, seed: int) -> int:
    """Every path of the shipped CompCars-parts csv splits under
    root/compcars/part, each a hard link to one of 8 seeded small PNG blobs
    (under .jpg names).  Returns the file count."""
    import os
    from pathlib import Path

    from saspa_tpu_torch.data.registry import DATASETS_FILES
    from saspa_tpu_torch.gen.image_io import write_png

    rng = np.random.RandomState(seed)
    part = Path(root) / "compcars/part"
    part.mkdir(parents=True)
    blobs = []
    for j in range(8):
        blobs.append(Path(root) / f"compcars_blob_{j}.png")
        write_png(blobs[-1], synthetic_sources(rng, 1, COMPCARS_SOURCE_HW)[0])
    paths = set()
    for split in ("train", "test"):
        with open(DATASETS_FILES / "compcars-parts" / f"{split}.csv") as f:
            paths |= {line.split(",")[0] for line in f if line.strip()}
    for i, rel in enumerate(sorted(paths)):
        (part / rel).parent.mkdir(parents=True, exist_ok=True)
        os.link(blobs[i % len(blobs)], part / rel)
    return len(paths)


def batch_ms(fn, iters: int = 5) -> dict:
    """A batch's costs of fn: the host's ms to queue a call (the card busy
    behind it), and the device ms of the kernels a call launches
    (device_ms: torch.profiler, else CUDA events)."""
    return {"host_ms": host_us(fn, iters) / 1e3, "device_ms": device_ms(fn, iters)[0]}


def run_train_recipes_phase(seed: int, smi: str) -> dict:
    """The paper's best train recipes (module docstring, phase 9); returns
    their launch counts (all 0: they run none of K1-K6)."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data import datasets as tds
    from saspa_tpu_torch.data.pipeline import InputPipeline
    from saspa_tpu_torch.fgvc import train as ttrain
    from saspa_tpu_torch.ops import augment as taug
    from saspa_tpu_torch.utils import rng as rngs
    from saspa_tpu_torch.utils.config import get_train_config

    root = Path(tempfile.mkdtemp(prefix="saspa_recipes_"))
    old_root = os.environ.get("SASPA_DATA_ROOT")
    os.environ["SASPA_DATA_ROOT"] = str(root)
    root_logger = logging.getLogger()
    old_handlers, old_level = root_logger.handlers[:], root_logger.level
    try:
        t = time.perf_counter()
        aug_json = write_dtd_train_tree(root, seed + 501)
        n_compcars = write_compcars_tree(root, seed + 502)
        tree_s = time.perf_counter() - t
        counts = {}
        # ---- each recipe through `cli train`: an epoch, validation, test, checkpoint
        for dataset, aug, extra, batch, steps in RECIPES:
            argv = ["train", "--dataset", dataset, "--special_aug", aug, "--epochs", "1", "--seed", "1",
                    "--logdir", str(root / f"logs_{dataset}"), *extra]
            if dataset == "dtd":
                argv += ["--aug_json", str(aug_json)]
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t = time.perf_counter()
            logs = cli.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts[dataset] = read_counts()
            peak = torch.cuda.max_memory_allocated()
            require(all(v == 0 for v in counts[dataset].values()), "train_recipes:", dataset,
                    "launched a kernel of K1-K6", counts[dataset])
            lines = [json.loads(ln) for ln in (Path(logs["save_dir"]) / "metrics.jsonl").read_text().splitlines()]
            epoch = lines[0]
            val = next(ln for ln in lines if "val_loss" in ln)
            test = next(ln for ln in lines if "test_loss" in ln)
            emit({"phase": "train_recipes", "dataset": dataset, "argv": argv, "batch": batch, "tree_s": tree_s,
                  "compcars_files": n_compcars, "wall_s": wall, "epoch": epoch, "val": val, "test": test,
                  "peak_mem_bytes": peak, "peak_mem_above_base_bytes": peak - base_mem,
                  "launches": counts[dataset], "pipeline_timings": logs["pipeline_timings"], "nvidia_smi": smi})
            require(epoch["steps"] == steps and math.isfinite(epoch["train_loss"]), "train_recipes:", dataset,
                    "epoch metrics", epoch)
            require(all(math.isfinite(v) for v in (val["val_loss"], test["test_loss"])), "train_recipes:", dataset,
                    "eval metrics", val, test)
            require(Path(logs["ckpt_path"]).exists(), "train_recipes: no checkpoint at", logs["ckpt_path"])

        # ---- the transforms and CutMix on the card against the CPU, one key; their costs a batch
        rng = np.random.RandomState(seed + 503)
        u8 = torch.from_numpy(rng.randint(0, 256, (16, 256, 256, 3)).astype(np.uint8))
        key = rngs.item_key(1, "augment", 0, 0)
        agree, cost = {}, {}
        for preset in ("randaug", "autoaug", "classic"):
            card = taug.train_transform_batch(u8.cuda(), key, preset, 224, 224).cpu()
            cpu = taug.train_transform_batch(u8, key, preset, 224, 224)
            agree[preset] = {"max_abs_err": float((card - cpu).abs().max()),
                             "equal_share": float((card == cpu).float().mean())}
            u8c = u8.cuda()
            cost[preset] = batch_ms(lambda: taug.train_transform_batch(u8c, key, preset, 224, 224))
        cost["randaug"]["draws_host_ms"] = host_us(lambda: taug.randaugment_draws(key, 16), 5) / 1e3
        cost["autoaug"]["draws_host_ms"] = host_us(lambda: taug.autoaugment_draws(key, 16), 5) / 1e3
        X = torch.from_numpy(rng.randn(16, 3, 224, 224).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, DTD_CLASSES, 16))
        ck = rngs.item_key(1, "cutmix", 0, 0)
        Xc, yc, sc = taug.cutmix_batch(X.cuda(), y.cuda(), ck, DTD_CLASSES)
        Xh, yh, sh = taug.cutmix_batch(X, y, ck, DTD_CLASSES)
        agree["cutmix"] = {"images_equal": torch.equal(Xc.cpu(), Xh), "soft_labels_equal": torch.equal(sc.cpu(), sh),
                           "mixed_share": float((Xh != X).float().mean())}
        Xd, yd = X.cuda(), y.cuda()
        cost["cutmix"] = {**batch_ms(lambda: taug.cutmix_batch(Xd, yd, ck, DTD_CLASSES)),
                          "draws_host_ms": host_us(lambda: taug.cutmix_draws(ck, 16, 224, 224), 5) / 1e3}
        emit({"phase": "train_recipes_transforms", "batch": 16, "agreement": agree, "ms_a_batch": cost,
              "nvidia_smi": smi})
        for preset in ("randaug", "autoaug", "classic"):  # the CPU tests' bound against JAX
            require(agree[preset]["max_abs_err"] <= 1e-6, "train_recipes: the card's", preset, "differs from the CPU's",
                    agree[preset])
        require(agree["cutmix"]["images_equal"] and agree["cutmix"]["soft_labels_equal"],
                "train_recipes: the card's CutMix differs from the CPU's", agree["cutmix"])

        # ---- the soft-label step on the card against the port on the CPU, f64, full width
        t = time.perf_counter()
        rows = card_vs_cpu(get_train_config("planes"), torch.float64, 1e-3, seed + 504, soft=True)
        emit({"phase": "train_recipes_card_vs_cpu", "dtype": "float64", "soft_labels": True,
              "seconds": time.perf_counter() - t, "steps": rows})
        for r in rows:
            require(r["loss_rel"] <= 1e-6 and r["running_stats_rel"] <= 1e-4 and r["feature_center_cos"] >= 0.9999
                    and r["fc_update_cos"] >= 0.9999, "train_recipes: the card's f64 soft-label steps differ", r)

        # ---- throughput: the input pipeline (transform + CutMix) feeding the step at each preset
        for dataset, aug, extra, batch, _ in RECIPES:
            cfg = get_train_config(dataset)
            ds, _, _, info = tds.get_datasets(dataset, special_aug=aug, seed=1, print_func=lambda *a: None,
                                              train_sample_ratio=0.01 if dataset == "compcars-parts" else 1.0)
            state = ttrain.create_train_state(cfg, info["num_classes"], device="cuda", init_seed=seed)
            pipe = InputPipeline(ds, batch, resize=cfg.image_size, train_transform=info["train_transform"],
                                 use_cutmix=info["use_cutmix"], seed=1, num_threads=cfg.workers * 2,
                                 device="cuda")
            step = ttrain.make_train_step(cfg, len(pipe))

            def batches():
                e = 0
                while True:
                    yield from pipe.iter_train(e)
                    e += 1

            it = batches()

            def run_steps(n):
                wait = dispatch = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in range(n):
                    ta = time.perf_counter()
                    X, y, ys = next(it)
                    tb = time.perf_counter()
                    step(state, X, y, rngs.item_key(1, "dropout", 9, i), y_soft=ys)
                    dispatch += time.perf_counter() - tb
                    wait += tb - ta
                torch.cuda.synchronize()
                return wait, dispatch, time.perf_counter() - t0

            run_steps(3)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    X, y, ys = next(it)
                    require(ys is not None and tuple(ys.shape) == (batch, info["num_classes"]),
                            "train_recipes: no soft labels from the pipeline")
                    step(state, X, y, rngs.item_key(1, "dropout", 9, RECIPE_TIMED_STEPS), y_soft=ys)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs = [str(w.message).splitlines()[0] for w in caught if "synchroniz" in str(w.message)]
            require(not syncs, "train_recipes: a batch and step synchronized the stream", syncs[:5])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            wait, dispatch, wall = run_steps(RECIPE_TIMED_STEPS)
            emit({"phase": "train_recipes_throughput", "dataset": dataset, "special_aug": aug, "net": cfg.net,
                  "batch": batch, "steps": RECIPE_TIMED_STEPS, "wall_s": wall, "s_per_step": wall / RECIPE_TIMED_STEPS,
                  "img_per_s": batch * RECIPE_TIMED_STEPS / wall, "host_input_wait_s": wait,
                  "host_step_dispatch_s": dispatch, "syncs_per_step": len(syncs),
                  "peak_mem_bytes": torch.cuda.max_memory_allocated(), "nvidia_smi": smi})
            del state, it
            torch.cuda.empty_cache()
        return read_counts()
    finally:
        for h in root_logger.handlers[:]:
            if h not in old_handlers:
                root_logger.removeHandler(h)
                h.close()
        for h in old_handlers:
            if h not in root_logger.handlers:
                root_logger.addHandler(h)
        root_logger.setLevel(old_level)
        if old_root is None:
            os.environ.pop("SASPA_DATA_ROOT", None)
        else:
            os.environ["SASPA_DATA_ROOT"] = old_root
        shutil.rmtree(root, ignore_errors=True)


WEIGHTS_RESOLUTION = 512
WEIGHTS_STEPS = 2  # the smoke's --steps took it 94 s past PR 13's 396 s (PERF.md, cell (i))
WEIGHTS_REFERENCE_RESOLUTION = 256  # the card-vs-CPU fused run, as phase 4's
WEIGHTS_CAL_CLASSES = TRAIN_CLASSES  # the released planes baseline: WSDAN-CAL ResNet-101, 100 classes
# keys a loader leaves out of what it loads (weights/load.py): the file side of its sums skips them
WEIGHTS_NOT_LOADED = ("position_ids", "num_batches_tracked", "input_resolution", "context_length", "vocab_size",
                      "scaling_layer.")


class NormalFill:
    """tools/synth_checkpoints.py's `fill`: float32 normals from one
    np.random.default_rng stream (a seeded tree of 1.57 G values in seconds),
    times `scale` (the layouts multiply by 0.02)."""

    def __init__(self, seed: int, scale: float = 1.0):
        self.rng = np.random.default_rng(seed)
        self.scale = np.float32(scale)

    def randn(self, *shape):
        if not shape:
            return float(self.rng.standard_normal()) * float(self.scale)
        x = self.rng.standard_normal(shape, dtype=np.float32)
        return x if self.scale == 1 else x * self.scale


class RssPeak:
    """The host's peak resident set while the block runs, sampled every 20 ms."""

    def __enter__(self):
        import os
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self.rss()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.run, daemon=True)
        self.thread.start()
        return self

    def rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def run(self):
        while not self.stop.wait(0.02):
            self.peak = max(self.peak, self.rss())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self.rss())


def write_weights_tree(root, seed: int) -> dict:
    """The public files of the planes recipe in the weights_day --src_dir
    layout, at full published width, from tools/synth_checkpoints.py's key
    layouts with seeded values: SD1.5's UNet, VAE (the 2022 attention names)
    and text tower and the canny ControlNet as F16 safetensors (the public
    fp16 variants), OpenAI's RN50.pt as a TorchScript archive, the lpips
    alex .pth, and the released WSDAN-CAL ResNet-101 of planes (100 classes,
    with feature_center) under checkpoints/planes/.  Returns {path:
    (elements, f64 sum)} of what each file holds for its model, the keys the
    loaders leave out (WEIGHTS_NOT_LOADED) not counted: the VAE file's
    encoder counts, as it loads."""
    from pathlib import Path

    from saspa_tpu_torch.weights.files import write_safetensors
    from tools import synth_checkpoints as synth

    root = Path(root)
    fill = NormalFill(seed)
    sums = {}

    def record(path, sd):
        n, total = 0, 0.0
        for k, v in sd.items():
            if any(x in k for x in WEIGHTS_NOT_LOADED):
                continue
            n += v.size
            total += float(np.sum(v, dtype=np.float64))
        sums[str(path)] = (n, total)

    def f16(sd):  # torch's cast: 3x numpy's
        return {k: torch.from_numpy(v).half().numpy() if v.dtype == np.float32 else v for k, v in sd.items()}

    for rel, make in (
            ("sd_v1.5/unet/diffusion_pytorch_model.fp16.safetensors", synth.diffusers_unet_state_dict),
            ("sd_v1.5/vae/diffusion_pytorch_model.fp16.safetensors", synth.diffusers_vae_state_dict),
            ("sd_v1.5/text_encoder/model.fp16.safetensors", synth.hf_clip_text_state_dict),
            ("controlnet_canny_sd15/diffusion_pytorch_model.fp16.safetensors", synth.diffusers_controlnet_state_dict)):
        sd = f16(make(fill=fill))
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        write_safetensors(path, sd)
        record(path, sd)
        del sd
    sd = synth.openai_clip_rn50_state_dict(fill=fill)
    module = torch.nn.Module()  # OpenAI's RN50.pt is a scripted model: its state as buffers
    for key, v in sd.items():
        *mods, leaf = key.split(".")
        m = module
        for name in mods:
            if not hasattr(m, name):
                m.add_module(name, torch.nn.Module())
            m = getattr(m, name)
        m.register_buffer(leaf, torch.from_numpy(np.asarray(v)))
    torch.jit.save(torch.jit.script(module), str(root / "RN50.pt"))
    record(root / "RN50.pt", sd)
    # lpips at weights of std 0.08 (near He's for the alexnet convs; 0.02 leaves
    # every deep feature map at its bias, and every distance near 0), its
    # heads non-negative, as trained lpips's are
    sd = synth.lpips_alex_state_dict(fill=NormalFill(seed + 1, scale=4.0))
    sd.update({k: np.abs(v) for k, v in sd.items() if k.startswith("lin")})
    (root / "lpips").mkdir()
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, root / "lpips" / "alex.pth")
    record(root / "lpips" / "alex.pth", sd)
    sd = synth.cal_checkpoint_state_dict(depth=101, num_classes=WEIGHTS_CAL_CLASSES, fill=fill)
    center = fill.randn(WEIGHTS_CAL_CLASSES, 32 * 2048) * np.float32(0.02)
    (root / "checkpoints" / "planes").mkdir(parents=True)
    torch.save({"logs": {"epoch": 80, "val_topk_accuracy": [0.9]},
                "state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "feature_center": torch.from_numpy(center)}, root / "checkpoints" / "planes" / "model_bestacc.pth")
    record(root / "checkpoints" / "planes" / "model_bestacc.pth", sd)
    return sums


def write_wide_planes_tree(root, gen_root, ids, n: int, seed: int) -> None:
    """A planes train split of n images in n variants (the released
    baseline's class count) under root: the gen tree's sources under their
    ids, then seeded 64^2 PNGs."""
    import shutil
    from pathlib import Path

    from saspa_tpu_torch.gen.image_io import write_png

    src = Path(gen_root) / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    data = Path(root) / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    (data / "images").mkdir(parents=True)
    all_ids = list(ids) + [f"{1900000 + j:07d}" for j in range(n - len(ids))]
    rng = np.random.RandomState(seed)
    for i, image_id in enumerate(all_ids):
        if i < len(ids):
            shutil.copyfile(src / "images" / f"{image_id}.jpg", data / "images" / f"{image_id}.jpg")
        else:
            write_png(data / "images" / f"{image_id}.jpg", synthetic_sources(rng, 1, 64)[0])
    (data / "images_train.txt").write_text("".join(f"{i}\n" for i in all_ids))
    (data / "images_manufacturer_train.txt").write_text("".join(f"{i} Maker\n" for i in all_ids))
    (data / "images_variant_train.txt").write_text("".join(f"{i} V-{k:03d}\n" for k, i in enumerate(all_ids)))
    (data / "variants.txt").write_text("".join(f"V-{k:03d}\n" for k in range(n)))


def check_load_reports(reports, file_sums, what: str) -> list:
    """Each model: every key of its file taken, every parameter loaded, the
    element count and f64 sum equal to the file's, and the module's state
    after the load equal to the file's values rounded to its dtypes
    (relative 1e-6).  Returns one summary row a model."""
    rows = []
    for r in reports:
        n, total = file_sums[r["file"]]
        require(r["unconsumed"] == 0 and r["params"] == r["module_params"], what, "load report", r)
        require(r["elements"] == n, what, r["model"], "elements", r["elements"], "file", n)
        require(abs(r["sum"] - total) <= 1e-6 * max(abs(total), 1.0), what, r["model"], "sum", r["sum"], "file", total)
        require(abs(r["loaded_sum"] - r["rounded_sum"]) <= 1e-6 * max(abs(r["rounded_sum"]), 1.0), what,
                r["model"], "loaded", r["loaded_sum"], "rounded file", r["rounded_sum"])
        rows.append({k: r[k] for k in ("model", "file", "kind", "file_keys", "params", "elements", "sum",
                                       "loaded_sum", "rounded_sum", "bytes", "seconds")})
    return rows


def run_weights_phase(steps: int, seed: int, smi: str) -> dict:
    """Loading the public checkpoint files (module docstring, phase 11);
    returns the launch counts of its `gen` run."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion import pipelines as tpipelines
    from saspa_tpu_torch.filters import lpips_filter
    from saspa_tpu_torch.filters.batches import new_timings
    from saspa_tpu_torch.gen.image_io import read_png, read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.gen.tokenizer import NEGATIVE_PROMPT
    from saspa_tpu_torch.ops.image import resize_image
    from saspa_tpu_torch.utils import rng as rngs
    from saspa_tpu_torch.weights import load as wload

    size, b = WEIGHTS_RESOLUTION, 8
    root = Path(tempfile.mkdtemp(prefix="saspa_weights_"))
    tree = root / "weights"
    env = {k: os.environ.get(k) for k in ("SASPA_DATA_ROOT", "SASPA_CHECKPOINTS")}
    os.environ["SASPA_DATA_ROOT"] = str(root / "data")
    os.environ["SASPA_CHECKPOINTS"] = str(root / "no_checkpoints")  # the baseline must come from the tree
    root_logger = logging.getLogger()
    old_handlers, old_level = root_logger.handlers[:], root_logger.level
    root_logger.setLevel(logging.INFO)
    real_init = tpipelines.init_pipeline
    made = []

    def recording_init(*a, **k):
        t0 = time.perf_counter()
        with RssPeak() as rss:
            pipe = real_init(*a, **k)
            torch.cuda.synchronize()
        made.append((pipe, rss, time.perf_counter() - t0))
        return pipe

    wload.REPORT_SUMS = True
    try:
        t = time.perf_counter()
        file_sums = write_weights_tree(tree, seed + 501)
        tree_s = time.perf_counter() - t
        tree_bytes = sum(f.stat().st_size for f in tree.rglob("*") if f.is_file())
        ids = write_planes_tree(root / "data", np.random.RandomState(seed + 502), b, size)

        # ---- cli gen from the tree: the planes recipe's SD1.5 + canny, loaded
        argv = ["gen", "--dataset", "planes", "--skip_filter", "--weights_dir", str(tree), "--resolution", str(size),
                "--num_per_image", "1", "--num_inference_steps", str(steps), "--batch_size", str(b), "--seed",
                str(seed + 3)]
        wload.REPORTS.clear()
        tpipelines.init_pipeline = recording_init
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        folder = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        tpipelines.init_pipeline = real_init
        counts = read_counts()
        want = expected_counts(steps, "default")
        require(counts == want, "weights: gen launch counts", counts, "expected", want)
        (pipe, rss, init_s), = made
        require(pipe.weights_loaded and pipe.params["controlnet"] is not None, "weights: the pipeline did not load")
        gen_rows = check_load_reports(pipe.load_report, file_sums, "weights: gen")
        require(sorted(r["model"] for r in gen_rows) == ["controlnet", "text", "unet", "vae"], "weights: gen models",
                gen_rows)
        load_s = sum(r["seconds"] for r in gen_rows)
        files = {f.name.split("_prompt_")[0]: f for f in Path(folder).glob("*.png") if "_prompt_" in f.name}
        require(sorted(files) == sorted(ids), "weights: gen files", sorted(files))

        # the same batch through the loaded pipeline's fused function: the PNGs bit for bit
        cfg = cli.gen_config(cli.build_parser().parse_args(argv)).with_dataset_overrides()
        ds = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        engine = PromptEngine(cfg, ds, ds.get_image_stem_to_class_str_dict())
        paths = ds.original_images_paths
        prompts = [engine.build(pth, i, 0) for i, pth in enumerate(paths)]
        src = np.stack([resize_image(read_rgb(pth), size) for pth in paths])
        lf = pipe.latent_factor
        lat = np.stack([rngs.item_normal(cfg.seed, "noise", i, 0, shape=(size // lf, size // lf, 4)) for i in range(b)])
        tok_ids = pipe.tokenizer(prompts, pad="eot")
        neg_ids = pipe.tokenizer([NEGATIVE_PROMPT] * b, pad="eot")
        u8 = pipe.make_fused_generate(size, size, steps, 7.5, 0.75, 120.0, 200.0)(pipe.params, tok_ids, neg_ids, src,
                                                                                 lat).cpu().numpy()
        same = [bool(np.array_equal(read_png(files[Path(pth).stem]), u8[k])) for k, pth in enumerate(paths)]
        require(all(same), "weights: gen PNGs differ from the fused function's output", same)

        # card bf16 against the port on the CPU in f32, both loaded from the tree (phase 4's bound)
        rs = WEIGHTS_REFERENCE_RESOLUTION
        small = (tok_ids[:1], neg_ids[:1], src[:1, ::2, ::2], lat[:1, ::2, ::2])
        t = time.perf_counter()
        cpu = tpipelines.DiffusionPipeline("sd_v1.5", "canny", dtype=torch.float32, device="cpu",
                                           weights_dir=str(tree))
        cpu_load_s = time.perf_counter() - t
        require(cpu.weights_loaded and len(cpu.load_report) == 4, "weights: the CPU pipeline did not load")
        _, img_cpu = cpu.make_fused_generate(rs, rs, 2, 7.5)(cpu.params, *small, return_images=True)
        del cpu
        _, img_gpu = pipe.make_fused_generate(rs, rs, 2, 7.5)(pipe.params, *small, return_images=True)
        diff = (img_gpu.float().cpu() - img_cpu).abs()
        mean_diff, max_diff = diff.mean().item(), diff.max().item()
        require(mean_diff <= 0.02, "weights: card vs CPU mean |diff|", mean_diff)
        del pipe, made[:]
        torch.cuda.empty_cache()

        # ---- cli filter from the tree: CLIP RN50, WSDAN-CAL and LPIPS loaded.  The
        # planes classes are the train split's: a split of the baseline's 100
        # classes whose first 8 images are the gen tree's sources
        write_wide_planes_tree(root / "wide", root / "data", ids, WEIGHTS_CAL_CLASSES, seed + 504)
        os.environ["SASPA_DATA_ROOT"] = str(root / "wide")
        argv_f = ["filter", "--dataset", "planes", "--aug_folder", str(folder), "--weights_dir", str(tree),
                  "--lpips_min", "1e-06", "--lpips_max", "1000"]
        wload.REPORTS.clear()
        reset_counts()
        t = time.perf_counter()
        json_path = cli.main(argv_f)
        torch.cuda.synchronize()
        filter_wall = time.perf_counter() - t
        require(all(v == 0 for v in read_counts().values()), "weights: filter launched a kernel of K1-K6")
        filter_rows = check_load_reports(wload.REPORTS, file_sums, "weights: filter")
        require(sorted(r["model"] for r in filter_rows) == ["cal", "clip", "lpips"], "weights: filter models",
                filter_rows)
        kept = json.loads(Path(json_path).read_text())
        log = "".join(f.read_text() for f in Path(json_path).parent.glob(Path(json_path).stem + "*.log"))
        counters = re.findall(r"For filter = (lpips_min|lpips_max), filtered (\d+) images", log)
        require(sorted(c[0] for c in counters) == ["lpips_max", "lpips_min"] and all(c[1] == "0" for c in counters),
                "weights: the LPIPS counters of the aug-JSON's log", counters)

        # LPIPS on the card (bf16) against the port on the CPU (f32), both from the tree
        wide = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        require(wide.num_classes == WEIGHTS_CAL_CLASSES, "weights: the wide tree's classes", wide.num_classes)
        by_stem = {Path(p).stem: p for p in wide.original_images_paths}
        origs, augs = [by_stem[i] for i in sorted(files)], [str(files[i]) for i in sorted(files)]
        d_card = lpips_filter.batched_lpips(origs, augs, weights_dir=str(tree), batch_size=b)
        d_cpu = lpips_filter.batched_lpips(origs, augs, weights_dir=str(tree), batch_size=b, device="cpu")
        rel = np.abs(d_card - d_cpu) / np.abs(d_cpu)
        require(bool(np.all(rel <= 0.02)), "weights: LPIPS card vs CPU", d_card.tolist(), d_cpu.tolist())
        model = lpips_filter.load_lpips(str(tree))
        reps = 8  # 64 pairs, one batch of 64
        lpips_filter.batched_lpips(origs * reps, augs * reps, batch_size=64, model=model)  # warm-up
        timings = new_timings()
        torch.cuda.synchronize()
        t = time.perf_counter()
        lpips_filter.batched_lpips(origs * reps, augs * reps, batch_size=64, model=model, timings=timings)
        torch.cuda.synchronize()
        lpips_s = time.perf_counter() - t
        del model

        # ---- cli train --ckpt: the released baseline's file, 2 steps
        ckpt = tree / "checkpoints" / "planes" / "model_bestacc.pth"
        train_root = root / "train"
        os.environ["SASPA_DATA_ROOT"] = str(train_root)
        aug_json = write_train_tree(train_root, seed + 503)
        argv_t = ["train", "--dataset", "planes", "--aug_json", str(aug_json), "--aug_sample_ratio", "0.4",
                  "--limit_aug_per_image", "2", "--special_aug", "classic", "--epochs", "1", "--seed", "1",
                  "--train_sample_ratio", "0.125", "--ckpt", str(ckpt), "--logdir", str(root / "logs")]
        reset_counts()
        t = time.perf_counter()
        logs = cli.main(argv_t)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t
        require(all(v == 0 for v in read_counts().values()), "weights: train launched a kernel of K1-K6")
        restored = logs["restored"]
        require(restored is not None and restored["skipped"] == [] and restored["missing"] == []
                and restored["feature_center"], "weights: train --ckpt did not restore every parameter", restored)
        epoch = json.loads((Path(logs["save_dir"]) / "metrics.jsonl").read_text().splitlines()[0])
        require(epoch["steps"] == 2 and math.isfinite(epoch["train_loss"]), "weights: train steps", epoch)

        def gbps(rows):
            by_file = {r["file"]: r for r in rows}.values()
            nbytes, secs = sum(r["bytes"] for r in by_file), sum(r["seconds"] for r in by_file)
            return {"files": len(by_file), "bytes": nbytes, "seconds": secs, "gb_per_s": nbytes / 1e9 / secs}

        emit({"phase": "weights", "tree_s": tree_s, "tree_bytes": tree_bytes,
              "tree_values": sum(n for n, _ in file_sums.values()), "gen_argv": argv, "steps": steps, "batch": b,
              "resolution": size, "gen_wall_s": wall, "gen_init_s": init_s, "gen_img_per_s": b / (wall - init_s),
              "gen_img_per_s_with_load": b / wall, "launches": counts,
              "launches_expected": want, "pngs_equal_fused": all(same),
              "load": {"sd_v1.5": gbps([r for r in gen_rows if r["model"] != "controlnet"]),
                       "controlnet_canny_sd15": gbps([r for r in gen_rows if r["model"] == "controlnet"]),
                       **{r["model"]: gbps([r]) for r in filter_rows}},
              "gen_load_s": load_s, "gen_init_host_rss_peak_bytes": rss.peak,
              "gen_init_host_rss_before_bytes": rss.base,
              "models": gen_rows + filter_rows, "cpu_f32_load_s": cpu_load_s,
              "reference": {"resolution": rs, "steps": 2, "mean_abs_diff": mean_diff, "max_abs_diff": max_diff},
              "filter_argv": argv_f, "filter_wall_s": filter_wall, "kept": sum(len(v) for v in kept.values()),
              "lpips_counters": counters, "lpips_card": d_card.tolist(), "lpips_cpu": d_cpu.tolist(),
              "lpips_max_rel_diff": float(rel.max()), "lpips_pairs": len(origs) * reps,
              "lpips_pairs_per_s": len(origs) * reps / lpips_s, "lpips_timings": timings,
              "train_argv": argv_t, "train_wall_s": train_wall, "restored": restored, "train_epoch": epoch,
              "nvidia_smi": smi})
        return counts
    finally:
        tpipelines.init_pipeline = real_init
        wload.REPORT_SUMS = False
        root_logger.handlers[:] = old_handlers
        root_logger.setLevel(old_level)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


SDEDIT_RESOLUTION = 512
SDEDIT_SOURCES = 8
SDEDIT_REFERENCE_RESOLUTION = 256  # the card-vs-CPU SDEdit batch, as phase 4's
SDEDIT_REFERENCE_STEPS = (4, 0.5)  # 4 steps at strength 0.5: 2 denoise steps
EDIT_INVERSION_STEPS = 50  # LAVIS' num_inversion_steps: 49 UNet calls
CARS_CLASSES = ["Acura TL Sedan 2012", "Audi R8 Coupe 2012", "BMW M3 Coupe 2012", "Kia Rio Sedan 2011"]


def expected_sdedit_counts(steps: int, inversion_calls: int = 0, controlnet: bool = False, xl: bool = False,
                           refiner: bool = False) -> dict:
    """Launches of one 512^2 batch through SDEdit (steps denoise steps) or
    BLIP-Diffusion's edit (inversion_calls UNet calls, then steps), default
    configuration.  Per UNet call, under CFG or not: 15 self-attentions over
    >= 256 tokens, 16 transformer blocks (norm1 and norm2 each), 61
    GroupNorms; the ControlNet adds 6, 7 and 27 a step; SDXL's UNet runs 70
    blocks and 46 GroupNorms (expected_xl_counts); the SDXL refiner's runs 44
    blocks (levels 1 and 2: 2 down and 3 up transformers each, 4 deep: 20 +
    20; the mid block's 4), the 40 of levels 1 and 2 with a self-attention
    on K1 (1024 and 256 tokens; the mid block's 64 run plain), and 56
    GroupNorms (22 resnets x 2, 11 Transformer2D norms, conv_norm_out); per
    encode: its mid attention (K1 at 4096 tokens, d 512) and 22 GroupNorms;
    per decode: its attention and 30."""
    attn, blocks, norms = (70, 70, 46) if xl else ((40, 44, 56) if refiner else (15, 16, 61))
    if controlnet:
        attn, blocks, norms = attn + 6, blocks + 7, norms + 27
    calls = steps + inversion_calls
    return {"attention_packed": attn * calls + 2, "ln_geglu": blocks * calls, "group_norm": norms * calls + 22 + 30,
            "group_norm_tpu": 0, "layernorm": 2 * blocks * calls, "attention_block": 0, "flash_attention": 0,
            **F32_NONE}


def write_cars_tree(root, rng, n: int, size: int) -> list:
    """A synthetic Stanford Cars train split at root/stanford_cars/stanford_cars
    (the layout CarsUtils reads): n seeded size x size sources in 4 classes
    as PNG bytes under .jpg names none of which is in
    datasets_files/cars_val.txt, with the devkit's cars_meta.mat and
    cars_train_annos.mat (scipy.io.savemat).  Returns the file names."""
    from pathlib import Path

    import scipy.io as sio

    from saspa_tpu_torch.gen.image_io import write_png

    cars = Path(root) / "stanford_cars/stanford_cars"
    (cars / "devkit").mkdir(parents=True)
    (cars / "cars_train").mkdir()
    names = [f"{9001 + 7 * i:05d}.jpg" for i in range(n)]
    val = set((Path(__file__).resolve().parent / "datasets_files/cars_val.txt").read_text().split())
    require(not val & set(names), "synthetic Cars names in the val carve-out", sorted(val & set(names)))
    for name, img in zip(names, synthetic_sources(rng, n, size)):
        write_png(cars / "cars_train" / name, img)
    meta = np.empty((1, len(CARS_CLASSES)), dtype=object)
    for k, c in enumerate(CARS_CLASSES):
        meta[0, k] = np.array([c])
    sio.savemat(str(cars / "devkit/cars_meta.mat"), {"class_names": meta})
    fields = ("bbox_x1", "bbox_y1", "bbox_x2", "bbox_y2", "class", "fname")
    annos = np.zeros((1, n), dtype=[(f, "O") for f in fields])
    for i, name in enumerate(names):
        for f in fields[:4]:
            annos[0, i][f] = np.array([[0 if f.endswith("1") else size - 1]], dtype=np.uint16)
        annos[0, i]["class"] = np.array([[i % len(CARS_CLASSES) + 1]], dtype=np.uint8)
        annos[0, i]["fname"] = np.array([name])
    sio.savemat(str(cars / "devkit/cars_train_annos.mat"), {"annotations": annos})
    return names


def check_k1_encoder(pipe, images) -> dict:
    """K1 at the VAE encoder's mid attention on the encoder's own activations
    (images (B, H, W, 3) in [0, 1] on the card) against its plain version:
    q, k, v made as VAEAttentionBlock makes them; times and bound as
    check_k1's rows."""
    from saspa_tpu_torch.ops import attention as att

    blk = pipe.params["vae"].encoder.mid_attn
    held = {}
    hook = blk.register_forward_pre_hook(lambda m, a: held.setdefault("x", a[0]))
    try:
        pipe.encode_image(images)
    finally:
        hook.remove()
    x = held["x"]
    b, c, h, w = x.shape
    with torch.no_grad():
        xn = blk.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = att.fold_scale(blk.to_q(xn), (1.0 / math.sqrt(c)) * att.LOG2E).contiguous()
        k, v = blk.to_k(xn).contiguous(), blk.to_v(xn).contiguous()
        out = att.flash_attention_packed(q, k, v, 1)
        ref = att.flash_attention_packed_plain(q, k, v, 1)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    require(err <= 1e-2 * ref_max, "vae encoder mid attention", "max |kernel - plain|", err, "> 1% of", ref_max)
    l = h * w
    qh, kh, vh = (t.reshape(b, l, 1, c).transpose(1, 2) for t in (q, k, v))
    ms = cuda_ms(lambda: att.flash_attention_packed(q, k, v, 1), 10)
    plain_ms = cuda_ms(lambda: att.flash_attention_packed_plain(q, k, v, 1), 3, warmup=1)
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=math.log(2.0)), 10)
    b_ms, b_by = bound(4.0 * b * l * l * c, 4 * b * l * c * 2, exps=b * l * l)
    return dict(shape="vae encoder mid attention", cell="sdedit", B=b, L=l, H=1, d=c, d_pad=c, max_abs_err=err,
                ref_max=ref_max, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                lib_ratio=ms / lib_ms, bound_share=b_ms / ms)


def run_sdedit_phase(seed: int, checks: dict, checked_sites: dict, profile_path=None) -> dict:
    """SDEdit and BLIP-Diffusion's inversion edit through `cli gen` (module
    docstring, phase 12); returns the launch counts of its runs and appends
    the encoder's K1 row and K3 sites to `checks`."""
    import gc
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, init_pipeline, quantize
    from saspa_tpu_torch.diffusion.schedulers import sdedit_start_step
    from saspa_tpu_torch.filters.aug_json import get_aug_json_path
    from saspa_tpu_torch.gen.image_io import read_png, read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.ops.image import pil_resize, resize_image
    from saspa_tpu_torch.utils import rng as rngs

    size, b = SDEDIT_RESOLUTION, SDEDIT_SOURCES
    if profile_path:  # the edit runs in another directory
        profile_path = str(Path(profile_path).resolve())
    root = Path(tempfile.mkdtemp(prefix="saspa_sdedit_"))
    env = {k: os.environ.get(k) for k in ("SASPA_DATA_ROOT", "SASPA_CHECKPOINTS")}
    os.environ["SASPA_DATA_ROOT"] = str(root)
    os.environ["SASPA_CHECKPOINTS"] = str(root / "checkpoints")  # none: seeded baselines
    old_cwd = os.getcwd()
    # ALIA's confidence thresholds are cached in alia_confidence_thresholds/
    # under the working directory: the phase runs in its temporary root, so
    # the seeded ones go with it and a cache already there is not read
    thresholds = Path(old_cwd) / "alia_confidence_thresholds"
    thresholds_before = sorted(thresholds.iterdir()) if thresholds.is_dir() else None
    tele = TelemetryHandler()
    root_logger = logging.getLogger()
    old_level = root_logger.level
    root_logger.setLevel(logging.INFO)
    root_logger.addHandler(tele)
    out = {"phase": "sdedit", "batch": b, "resolution": size}
    counts = {}

    def run_cli(name, argv, want):
        """One `cli gen` run: its resolved configuration, its launch counts
        against want, wall s, img/s, peak memory, telemetry; returns (the
        configuration, cli.main's result)."""
        args = cli.build_parser().parse_args(argv)
        cfg = (cli.preset_config(args) if args.preset else cli.gen_config(args)).with_dataset_overrides()
        tele.lines.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts[name] = read_counts()
        require(len(tele.lines) == 1 and tele.lines[0]["num_errors"] == 0 and tele.lines[0]["total"] == b,
                name, "telemetry", tele.lines, *tele.errors)
        require(counts[name] == want, name, "launch counts", counts[name], "expected", want)
        out[name] = {"argv": argv, "wall_s": wall, "img_per_s": b / wall,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": counts[name],
                     "launches_expected": want, "telemetry": tele.lines[0]}
        return cfg, result

    def denoise_steps(cfg):
        return cfg.num_inference_steps - sdedit_start_step(cfg.num_inference_steps, cfg.sdedit_strength)

    def outputs(cfg, ds):
        """The run's PNGs by source stem, in the tree's order."""
        stems = [Path(p).stem for p in ds.original_images_paths]
        files = sorted(Path(cfg.output_folder(str(ds.root_path))).glob("*.png"))
        outs = {f.name.split("_prompt_")[0]: f for f in files if "_prompt_" in f.name}
        require(sorted(outs) == sorted(stems), "sdedit files", [f.name for f in files])
        return [read_png(outs[s]) for s in stems]

    def same_as(name, pngs, images):
        """The run's PNGs against quantize(images), bit for bit."""
        u8 = quantize(images).cpu().numpy()
        same = [bool(np.array_equal(png, u)) for png, u in zip(pngs, u8)]
        require(all(same), name, "PNGs differ from the pipeline's output", same)
        out[name].update({"pngs_equal_pipeline": True, "uint8_mean": float(u8.mean())})

    def batch(pipe, cfg, ds, classes):
        """The driver's inputs of the tree's 8 items (sources / 255 on the
        card, noise, prompts, control image); returns them and generate(strength)."""
        paths, res = ds.original_images_paths, cfg.resolution
        src = np.stack([resize_image(read_rgb(p), res) for p in paths])
        lf = pipe.latent_factor
        lat = np.stack([rngs.item_normal(cfg.seed, "noise", i, 0, shape=(res // lf, res // lf, 4))
                        for i in range(b)])
        engine = PromptEngine(cfg, ds, classes)
        prompts = [engine.build(p, i, 0) for i, p in enumerate(paths)]
        init = torch.as_tensor(src, device=pipe.device).float() / 255.0
        control = pipe.control_from_src(src, res, res, cfg.low_threshold_canny, cfg.high_threshold_canny)

        def generate(strength=None):
            return pipe.generate(prompts, lat, height=res, width=res, num_inference_steps=cfg.num_inference_steps,
                                 guidance_scale=cfg.guidance_scale, negative_prompt=cfg.negative_prompt,
                                 control_image=control, controlnet_scale=cfg.controlnet_conditioning_scale,
                                 init_image=init, sdedit_strength=strength or cfg.sdedit_strength)

        return {"src": src, "init": init, "lat": lat, "prompts": prompts}, generate

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    try:
        os.chdir(root)
        # ---- Real-Guidance on cars: SDEdit 0.15 of 50 steps, the CLIP per-class filter
        write_cars_tree(root, np.random.RandomState(seed + 501), b, size)
        argv = ["gen", "--preset", "real_guidance", "--dataset", "cars", "--num_per_image", "1", "--batch_size",
                str(b), "--seed", str(seed + 1)]
        rg, json_rg = run_cli("real_guidance", argv, expected_sdedit_counts(7))
        require((rg.base_model, rg.controlnet, rg.sdedit, rg.sdedit_strength, rg.num_inference_steps,
                 denoise_steps(rg), rg.prompt_type) == ("sd_v1.5", None, True, 0.15, 50, 7, "txt2sentence"),
                "real_guidance", rg)
        ds = DS_UTILS_DICT["cars"](print_func=lambda *a: None)
        folder = rg.output_folder(str(ds.root_path))
        require(json_rg == get_aug_json_path(folder, clip_filtering="per_class", clip_filtering_discount=1) and
                Path(json_rg).name == "clip_filtering_per_class_discount_1-aug.json", "real_guidance JSON", json_rg)
        require(sorted(json.loads(Path(json_rg).read_text())) == sorted(Path(p).name for p in
                                                                         ds.original_images_paths),
                "real_guidance JSON keys", json_rg)
        pngs = outputs(rg, ds)

        # the same batch through pipe.generate: same seeded weights, prompts,
        # sources / 255 and noise -> the PNGs' pixels, bit for bit
        pipe, init_s = timed(lambda: init_pipeline("sd_v1.5", None, SDEdit=True))
        inputs, generate = batch(pipe, rg, ds, ds.get_image_stem_to_class_str_dict())
        # one hooked call of 1 denoise step (50 x 0.02): the encoder's,
        # UNet's and decoder's norm and attention sites
        sites, handles = record_sites(pipe)
        generate(0.02)
        for h in handles:
            h.remove()
        images, ts = timed(generate)
        require(bool(torch.isfinite(images).all()), "real_guidance: non-finite images")
        same_as("real_guidance", pngs, images)
        _, t_more = timed(lambda: generate(0.3))  # 15 denoise steps
        init = inputs["init"]
        encode_ms = cuda_ms(lambda: pipe.encode_image(init), 5)
        enc = profile_run(lambda: timed(lambda: pipe.encode_image(init)))
        prof = profile_run(lambda: timed(generate))
        if profile_path:
            Path(profile_path).parent.mkdir(parents=True, exist_ok=True)
            Path(profile_path).write_text(json.dumps({"config": "sdedit real_guidance", "steps": 7, **{
                k: prof[k] for k in ("wall_s", "device_busy_s", "groups_ms", "kernels")}}, indent=1))
        out["real_guidance"].update({
            "init_s": init_s, "denoise_steps": 7, "generate_s": ts, "generate_15step_s": t_more,
            "s_per_step": (t_more - ts) / (15 - 7), "encode_ms": encode_ms,
            "encode_device_ms": enc["device_busy_s"] * 1e3, "encode_kernels": sum(k["calls"] for k in enc["kernels"]),
            "encode_groups_ms": enc["groups_ms"], "idle_share": prof["idle_share"],
            "profiled_wall_s": prof["wall_s"], "device_busy_s": prof["device_busy_s"], "groups_ms": prof["groups_ms"],
            "profile": profile_path})

        # the encoder's sites: K1 at its mid attention on its own activations,
        # and the K3 sites the kernels phase has not checked
        k1_row = check_k1_encoder(pipe, init)
        gen = torch.Generator(device="cuda").manual_seed(seed + 502)
        checks["attention_packed"].append(k1_row)
        new_gn = sites["group_norm"] - checked_sites["group_norm"]
        require(new_gn, "the encoder added no GroupNorm site", sorted(sites["group_norm"], key=str))
        k3_rows = [dict(r, cell="sdedit") for r in check_k3(gen, new_gn)]
        checks["group_norm"] += k3_rows
        emit({"phase": "kernels", "kernel": "attention_packed", "cell": "sdedit", "shapes": [k1_row]})
        emit({"phase": "kernels", "kernel": "group_norm", "cell": "sdedit", "shapes": k3_rows})
        checked_sites["group_norm"] |= new_gn
        out["new_group_norm_sites"] = sorted(map(list, new_gn), key=str)

        # ---- ALIA on planes: SDEdit 0.5 of 30 steps, semantic + ALIA confidence filters
        ids = write_planes_tree(root, np.random.RandomState(seed + 503), b, size)
        argv = ["gen", "--preset", "alia", "--dataset", "planes", "--num_per_image", "1", "--batch_size", str(b),
                "--seed", str(seed + 2)]
        al, json_al = run_cli("alia", argv, expected_sdedit_counts(15))
        require((al.base_model, al.controlnet, al.sdedit, al.sdedit_strength, al.num_inference_steps,
                 denoise_steps(al), al.prompt_type) == ("sd_v1.5", None, True, 0.5, 30, 15, "ALIA"), "alia", al)
        ds = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        folder = al.output_folder(str(ds.root_path))
        require(Path(json_al).name == "semantic_filtering-alia_conf_filtering-aug.json" and
                json_al == get_aug_json_path(folder, semantic_filtering=True, alia_conf_filtering=True),
                "alia JSON", json_al)
        require(sorted(json.loads(Path(json_al).read_text())) == sorted(f"{i}.jpg" for i in ids), "alia JSON keys")
        inputs, generate = batch(pipe, al, ds, ds.get_image_stem_to_class_str_dict())
        images, ts = timed(generate)
        same_as("alia", outputs(al, ds), images)
        out["alia"].update({"denoise_steps": 15, "generate_s": ts})

        # ---- card bf16 against the port on the CPU in f32, same weights: the
        # encoder's mean on one 256^2 source, then one SDEdit batch there
        t = time.perf_counter()
        cpu = DiffusionPipeline("sd_v1.5", controlnet=None, dtype=torch.float32, device="cpu", init_seed=None)
        copy_weights(pipe, cpu)
        cpu_setup_s = time.perf_counter() - t
        rs = SDEDIT_REFERENCE_RESOLUTION
        k = size // rs
        small, small_lat = inputs["src"][:1, ::k, ::k], inputs["lat"][:1, ::k, ::k]
        steps, strength = SDEDIT_REFERENCE_STEPS
        ref = {}
        for name, p in (("cpu", cpu), ("card", pipe)):
            init = torch.as_tensor(small, device=p.device).float() / 255.0
            mean = p.encode_image(init).float().cpu()
            reset_counts()
            t = time.perf_counter()
            img = p.generate(inputs["prompts"][:1], small_lat, height=rs, width=rs, num_inference_steps=steps,
                             init_image=init, sdedit_strength=strength).float().cpu()
            ref[name] = (mean, img, time.perf_counter() - t, read_counts())
        del cpu, pipe, inputs, generate, images
        gc.collect()
        torch.cuda.empty_cache()
        cos_mean = cosine(ref["card"][0], ref["cpu"][0])
        diff = (ref["card"][1] - ref["cpu"][1]).abs()
        out["card_vs_cpu"] = {
            "resolution": rs, "steps": steps, "strength": strength,
            "denoise_steps": steps - sdedit_start_step(steps, strength), "encoder_mean_cosine": cos_mean,
            "encoder_mean_rel_err": rel_norm(ref["card"][0], ref["cpu"][0]), "mean_abs_diff": diff.mean().item(),
            "max_abs_diff": diff.max().item(), "launches": ref["card"][3], "cpu_setup_s": cpu_setup_s,
            "cpu_s": ref["cpu"][2], "gpu_s": ref["card"][2], "cpu_threads": torch.get_num_threads()}
        require(cos_mean >= 0.99, "sdedit encoder mean card vs CPU, cosine", cos_mean)
        require(diff.mean().item() <= 0.02, "sdedit card vs CPU mean |diff|", diff.mean().item())
        ran = [key for key, v in expected_sdedit_counts(2).items() if v > 0]
        require(all(ref["card"][3][key] > 0 for key in ran), "sdedit reference run missed a kernel", ref["card"][3])

        # ---- --sdedit with the canny ControlNet (planes): 0.5 of 4 steps
        argv = ["gen", "--dataset", "planes", "--sdedit", "--sdedit_strength", "0.5", "--num_inference_steps", "4",
                "--skip_filter", "--num_per_image", "1", "--batch_size", str(b), "--seed", str(seed + 4)]
        cn, _ = run_cli("sdedit_canny", argv, expected_sdedit_counts(2, controlnet=True))
        require((cn.base_model, cn.controlnet, denoise_steps(cn)) == ("sd_v1.5", "canny", 2), "sdedit canny", cn)
        pipe = init_pipeline("sd_v1.5", "canny", SDEdit=True)
        _, generate = batch(pipe, cn, ds, ds.get_image_stem_to_class_str_dict())
        images, ts = timed(generate)
        same_as("sdedit_canny", outputs(cn, ds), images)
        out["sdedit_canny"].update({"denoise_steps": 2, "generate_s": ts})
        del pipe, generate, images
        gc.collect()
        torch.cuda.empty_cache()

        # ---- ALIA on cub: SDXL-Turbo + SDEdit, 0.5 of 2 trailing steps, guidance 0
        write_cub_tree(root, np.random.RandomState(seed + 505), b, size)
        argv = ["gen", "--preset", "alia", "--dataset", "cub", "--num_per_image", "1", "--batch_size", str(b),
                "--seed", str(seed + 5)]
        xc, json_xc = run_cli("alia_cub", argv, expected_sdedit_counts(1, xl=True))
        require((xc.base_model, xc.controlnet, xc.sdedit, xc.guidance_scale, denoise_steps(xc)) ==
                ("sd_xl-turbo", None, True, 0.0, 1) and Path(json_xc).name ==
                "semantic_filtering-alia_conf_filtering-aug.json", "alia on cub", xc, json_xc)
        ds = DS_UTILS_DICT["cub"](print_func=lambda *a: None)
        xpipe, init_xl_s = timed(lambda: init_pipeline("sd_xl-turbo", None, SDEdit=True))
        _, generate = batch(xpipe, xc, ds, ds.get_image_path_to_class_str_dict())
        images, ts = timed(generate)
        same_as("alia_cub", outputs(xc, ds), images)
        out["alia_cub"].update({"denoise_steps": 1, "init_s": init_xl_s, "generate_s": ts,
                                "timesteps": [int(x) for x in xpipe.scheduler.timesteps(2)]})
        del xpipe, generate, images
        gc.collect()
        torch.cuda.empty_cache()

        require(sorted(p.name for p in (root / "alia_confidence_thresholds").iterdir()) == ["cub.json", "planes.json"],
                "ALIA thresholds were not computed in the phase's root")

        # ---- blip_diffusion-edit on dtd: 49 inversion calls, then 30 CFG steps
        os.environ["SASPA_DATA_ROOT"] = "data"  # DTD's captions are keyed by paths under data/
        write_dtd_tree(root, np.random.RandomState(seed + 504), size)
        argv = ["gen", "--dataset", "dtd", "--base_model", "blip_diffusion-edit", "--skip_filter", "--num_per_image",
                "1", "--resolution", str(size), "--batch_size", str(b), "--seed", str(seed + 3)]
        calls = EDIT_INVERSION_STEPS - 1
        ed, folder = run_cli("blip_edit", argv, expected_sdedit_counts(30, calls))
        ds = DS_UTILS_DICT["dtd"](print_func=lambda *a: None)
        require("/blip_diffusion-edit/" in folder and ed.num_inference_steps == 30, "edit", folder, ed)
        paths = ds.original_images_paths
        subject_u8 = []
        for i, pth in enumerate(paths):
            same_class = ds.get_image_path_with_same_class(pth)
            pick = same_class[rngs.host_choice(len(same_class), ed.seed, "subject_choice", i, 0)]
            subject_u8.append((resize_image(read_rgb(pick), size).astype(np.float32) / 255.0 * 255).astype(np.uint8))
        subjects_equal = [bool(np.array_equal(read_png(Path(folder) / f"{Path(p).stem}_subject_0.png"), u))
                          for p, u in zip(paths, subject_u8)]
        require(all(subjects_equal), "edit _subject_ files differ from the host replay", subjects_equal)
        refs = np.stack([pil_resize(u, (224, 224)) for u in subject_u8]).astype(np.float32) / np.float32(255.0)
        bpipe, init_s = timed(lambda: init_pipeline("blip_diffusion-edit", "canny"))
        require("controlnet" not in bpipe.params, "the edit pipeline holds a ControlNet")
        src_t = torch.as_tensor(np.stack([resize_image(read_rgb(p), size) for p in paths]),
                                device=bpipe.device).float() / 255.0
        engine = PromptEngine(ed, ds, ds.get_image_path_to_class_str_dict())
        prompts = [engine.build(p, i, 0) for i, p in enumerate(paths)]
        meta = ds.meta_class
        images, ts = timed(lambda: bpipe.edit(src_t, refs, prompts, source_subject=meta, target_subject=meta,
                                              guidance_scale=ed.guidance_scale,
                                              num_inference_steps=ed.num_inference_steps,
                                              negative_prompt=ed.negative_prompt))
        same_as("blip_edit", outputs(ed, ds), images)
        with torch.no_grad():
            inv_ctx = bpipe.params["text"][0](torch.as_tensor(bpipe.tokenizer([f"a {meta}"] * b, pad="eot"),
                                                              device=bpipe.device).long())["hidden"]
        _, t_inv = timed(lambda: bpipe.invert(src_t, inv_ctx, EDIT_INVERSION_STEPS))
        out["blip_edit"].update({"init_s": init_s, "inversion_calls": calls, "regeneration_steps": 30, "edit_s": ts,
                                 "invert_s": t_inv, "s_per_inversion_call": t_inv / calls,
                                 "subjects_equal_replay": all(subjects_equal)})
        emit(out)
        del bpipe, src_t, images, inv_ctx
        gc.collect()
        torch.cuda.empty_cache()
        os.chdir(old_cwd)
        require((sorted(thresholds.iterdir()) if thresholds.is_dir() else None) == thresholds_before,
                "the sdedit phase changed", thresholds)
        return counts
    finally:
        os.chdir(old_cwd)
        root_logger.removeHandler(tele)
        root_logger.setLevel(old_level)
        for key, v in env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        shutil.rmtree(root, ignore_errors=True)


PB_RESOLUTION = 512
PB_SOURCES = 8  # one ip2p batch: the UNet at B24 under 3-way guidance
PB_SMALL_HW = 64  # the split's other rows: small seeded PNGs (the train and eval runs resize them)
PB_VARIANTS = {"Boeing": "737-800", "Airbus": "A320"}  # the planes tree's variant of each manufacturer
PB_TRAIN_SAMPLE_RATIO = "0.04"  # 16 of the 409 train rows: 4 steps at batch 4
PB_PLANES_EVAL_ROWS = 16  # the planes split's val and test rows for the teacher run
PB_SPLIT = ("train", "val", "test")
# the gen run's seed: its 8 ALIA prompts name two augs whose 20% amnesty coin
# keeps them through the confidence filter; the seeded baseline's logits put
# every other aug over its class's threshold, and train needs a non-empty JSON
PB_GEN_SEED = 1


def write_planes_biased_tree(root, seed: int, n_gen: int, size: int) -> list:
    """A synthetic FGVC-Aircraft tree for every row of
    datasets_files/aircraft_biased_dataset/alia_cotextual_bias_split.csv
    (409 train, 715 val, 707 test): PNG bytes under the rows' .jpg names,
    the first n_gen train rows' at size^2 (the gen run's sources), the
    others' at 64^2; the manufacturer and variant files of the train rows
    (the gen side's class strings, "Boeing 737-800" and "Airbus A320"), and a
    planes split over the same images for the teacher's run (variants.txt,
    images_variant_{train,val,test}.txt: the csv's train rows and the first
    16 val and test rows).  Returns the gen sources' ids."""
    import csv
    from pathlib import Path

    from saspa_tpu_torch.gen.image_io import write_png

    here = Path(__file__).resolve().parent
    with open(here / "datasets_files/aircraft_biased_dataset/alia_cotextual_bias_split.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    data = Path(root) / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    (data / "images").mkdir(parents=True)
    by_split = {s: [r for r in rows if r["Split"] == s] for s in PB_SPLIT}
    gen_ids = [Path(r["Filename"]).stem for r in by_split["train"][:n_gen]]
    rng = np.random.RandomState(seed)
    big = dict(zip(gen_ids, synthetic_sources(rng, n_gen, size)))
    small = synthetic_sources(rng, len(rows), PB_SMALL_HW)
    for r, img in zip(rows, small):
        stem = Path(r["Filename"]).stem
        write_png(data / "images" / f"{stem}.jpg", big.get(stem, img))
    for split, rs in by_split.items():
        if split != "train":
            rs = rs[:PB_PLANES_EVAL_ROWS]
        ids = [(Path(r["Filename"]).stem, r["Plane"]) for r in rs]
        (data / f"images_{split}.txt").write_text("".join(f"{i}\n" for i, _ in ids))
        (data / f"images_manufacturer_{split}.txt").write_text("".join(f"{i} {m}\n" for i, m in ids))
        (data / f"images_variant_{split}.txt").write_text("".join(f"{i} {PB_VARIANTS[m]}\n" for i, m in ids))
    (data / "variants.txt").write_text("".join(f"{v}\n" for v in PB_VARIANTS.values()))
    return gen_ids


def write_ip2p_weights(root, seed: int) -> dict:
    """InstructPix2Pix's public files (timbrooks/instruct-pix2pix's unet, vae
    and text_encoder) in the weights_day --src_dir layout, ip2p/...: F16
    safetensors from tools/synth_checkpoints.py's key layouts with seeded
    values at full published width (the UNet's conv_in takes 8 channels, the
    VAE carries the 2022 attention names).  Returns {path: (elements, f64
    sum)} as write_weights_tree's."""
    from pathlib import Path

    from saspa_tpu_torch.weights.files import write_safetensors
    from tools import synth_checkpoints as synth

    fill = NormalFill(seed)
    sums = {}
    for rel, make in (
            ("ip2p/unet/diffusion_pytorch_model.fp16.safetensors",
             lambda: synth.diffusers_unet_state_dict(synth.IP2P_TORCH_CFG, fill=fill)),
            ("ip2p/vae/diffusion_pytorch_model.fp16.safetensors", lambda: synth.diffusers_vae_state_dict(fill=fill)),
            ("ip2p/text_encoder/model.fp16.safetensors", lambda: synth.hf_clip_text_state_dict(fill=fill))):
        sd = {k: torch.from_numpy(v).half().numpy() if v.dtype == np.float32 else v for k, v in make().items()}
        path = Path(root) / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        write_safetensors(path, sd)
        kept = [v for k, v in sd.items() if not any(x in k for x in WEIGHTS_NOT_LOADED)]
        sums[str(path)] = (sum(v.size for v in kept), float(sum(np.sum(v, dtype=np.float64) for v in kept)))
        del sd, kept
    return sums


def run_planes_biased_phase(seed: int, checks: dict, checked_sites: dict) -> dict:
    """The planes_biased path (module docstring, phase 13); returns the
    launch counts of its `gen` run and appends the ip2p K3 and K4 sites the
    earlier phases did not check to `checks`."""
    import gc
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion import pipelines as tpipelines
    from saspa_tpu_torch.fgvc import runner
    from saspa_tpu_torch.gen import driver as tdriver
    from saspa_tpu_torch.gen.image_io import read_png, read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.ops.image import resize_image
    from saspa_tpu_torch.utils import rng as rngs
    from saspa_tpu_torch.weights import load as wload

    t_phase = time.perf_counter()
    size, b = PB_RESOLUTION, PB_SOURCES
    root = Path(tempfile.mkdtemp(prefix="saspa_planes_biased_"))
    env = {k: os.environ.get(k) for k in ("SASPA_DATA_ROOT", "SASPA_CHECKPOINTS")}
    os.environ["SASPA_DATA_ROOT"] = str(root)
    os.environ["SASPA_CHECKPOINTS"] = str(root / "checkpoints")  # none: seeded baselines
    old_cwd = os.getcwd()
    thresholds = Path(old_cwd) / "alia_confidence_thresholds"
    thresholds_before = sorted(thresholds.iterdir()) if thresholds.is_dir() else None
    root_logger = logging.getLogger()
    old_handlers, old_level = root_logger.handlers[:], root_logger.level
    tele = TelemetryHandler()
    root_logger.setLevel(logging.INFO)
    root_logger.addHandler(tele)
    real_init = tpipelines.init_pipeline
    made = []

    def recording_init(*a, **k):
        pipe = real_init(*a, **k)
        made.append(pipe)
        return pipe

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    out = {"phase": "planes_biased", "batch": b, "resolution": size}
    wload.REPORT_SUMS = True
    try:
        os.chdir(root)
        (tree_ids, tree_s) = timed(lambda: write_planes_biased_tree(root, seed + 601, b, size))
        file_sums, weights_s = timed(lambda: write_ip2p_weights(root / "weights", seed + 602))
        out.update(tree_s=tree_s, weights_s=weights_s)

        # ---- cli gen --preset alia --dataset planes_biased: ip2p, 100 steps, 3-way CFG at B24, then the filters
        argv = ["gen", "--preset", "alia", "--dataset", "planes_biased", "--num_per_image", "1", "--batch_size",
                str(b), "--seed", str(PB_GEN_SEED), "--weights_dir", str(root / "weights"), "--max_items", str(b)]
        args = cli.build_parser().parse_args(argv)
        cfg = cli.preset_config(args).with_dataset_overrides()
        require((cfg.base_model, cfg.controlnet, cfg.sdedit, cfg.prompt_type, cfg.guidance_scale) ==
                ("ip2p", None, False, "ALIA", 7.5), "planes_biased: the ALIA preset", cfg)
        want = expected_sdedit_counts(tdriver.IP2P_STEPS)
        wload.REPORTS.clear()
        tpipelines.init_pipeline = recording_init
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        json_path, wall = timed(lambda: cli.main(argv))
        counts = read_counts()
        tpipelines.init_pipeline = real_init
        require(len(tele.lines) == 1 and tele.lines[0]["num_errors"] == 0 and tele.lines[0]["total"] == b,
                "planes_biased gen telemetry", tele.lines, *tele.errors)
        require(counts == want, "planes_biased gen launch counts", counts, "expected", want)
        (pipe,) = made
        require(pipe.base_model == "ip2p" and pipe.unet_cfg.in_channels == 8 and pipe.weights_loaded,
                "planes_biased: the ip2p pipeline", pipe.base_model)
        load_rows = check_load_reports(pipe.load_report, file_sums, "planes_biased: ip2p")
        require(sorted(r["model"] for r in load_rows) == ["text", "unet", "vae"], "ip2p models", load_rows)
        ds = DS_UTILS_DICT["planes_biased"](print_func=lambda *a: None)
        folder = Path(cfg.output_folder(str(ds.root_path)))
        require(str(folder).endswith(f"/regular/ip2p/None/ALIA_prompt_w_sub_class_seed_{cfg.seed}/images") and
                Path(json_path).name == "semantic_filtering-alia_conf_filtering-aug.json", "planes_biased outputs",
                folder, json_path)
        files = {f.name.split("_prompt_")[0]: f for f in folder.glob("*.png") if "_prompt_" in f.name}
        require(sorted(files) == sorted(tree_ids), "planes_biased gen files", sorted(files))
        out["gen"] = {"argv": argv, "wall_s": wall, "img_per_s": b / wall, "launches": counts,
                      "launches_expected": want, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "telemetry": tele.lines[0], "load": load_rows}

        # the same batch through pipe.generate: the PNGs bit for bit; then s/step at B24
        paths = ds.original_images_paths[:b]
        engine = PromptEngine(cfg, ds, ds.get_image_stem_to_class_str_dict())
        prompts = [engine.build(p, i, 0) for i, p in enumerate(paths)]
        src = np.stack([resize_image(read_rgb(p), size) for p in paths])
        lf = pipe.latent_factor
        lat = np.stack([rngs.item_normal(cfg.seed, "noise", i, 0, shape=(size // lf, size // lf, 4))
                        for i in range(b)])
        init = torch.as_tensor(src, device=pipe.device).float() / 255.0

        def generate(steps):
            return pipe.generate(prompts, lat, height=size, width=size, num_inference_steps=steps,
                                 guidance_scale=cfg.guidance_scale, negative_prompt=cfg.negative_prompt,
                                 init_image=init, image_guidance_scale=tdriver.IP2P_IMAGE_GUIDANCE)

        images, t100 = timed(lambda: generate(tdriver.IP2P_STEPS))
        require(bool(torch.isfinite(images).all()), "planes_biased: non-finite images")
        u8 = tpipelines.quantize(images).cpu().numpy()
        same = [bool(np.array_equal(read_png(files[Path(p).stem]), u)) for p, u in zip(paths, u8)]
        require(all(same), "planes_biased PNGs differ from pipe.generate's", same)
        _, t10 = timed(lambda: generate(10))
        s_step = (t100 - t10) / (tdriver.IP2P_STEPS - 10)
        out["gen"].update({"pngs_equal_pipeline": True, "uint8_mean": float(u8.mean()), "generate_s": t100,
                           "s_per_step": s_step, "unet_batch": 3 * b, "img_per_s_generate": b / t100})
        del images

        # the ip2p UNet's K3 and K4 sites at B24 (one hooked step) that earlier phases did not check
        sites, handles = record_sites(pipe)
        generate(1)
        for h in handles:
            h.remove()
        gen = torch.Generator(device="cuda").manual_seed(seed + 603)
        new_gn = sites["group_norm"] - checked_sites["group_norm"]
        new_ln = sites["layernorm"] - checked_sites["layernorm"]
        require(any(s[0] == 3 * b for s in new_gn) and any(m % (3 * b) == 0 for m, _ in new_ln),
                "planes_biased: no new B24 norm site", sorted(new_gn, key=str), sorted(new_ln))
        k3_rows = [dict(r, cell="ip2p") for r in check_k3(gen, new_gn)]
        k4_rows = [dict(r, cell="ip2p") for r in check_k4(gen, new_ln)]
        checks["group_norm"] += k3_rows
        checks["layernorm"] += k4_rows
        checked_sites["group_norm"] |= new_gn
        checked_sites["layernorm"] |= new_ln
        emit({"phase": "kernels", "kernel": "group_norm", "cell": "ip2p", "shapes": k3_rows})
        emit({"phase": "kernels", "kernel": "layernorm", "cell": "ip2p", "shapes": k4_rows})
        del pipe, made[:], init
        gc.collect()
        torch.cuda.empty_cache()

        # ---- cli filter with ALIA's recipe rebuilds the gen run's aug-JSON
        before = Path(json_path).read_bytes()
        filt = cli.main(["filter", "--dataset", "planes_biased", "--aug_folder", str(folder), "--alia_conf_filtering",
                         "--no_model_confidence", "--weights_dir", str(root / "weights")])
        require(filt == json_path and Path(filt).read_bytes() == before, "planes_biased: cli filter's JSON", filt)
        kept = {k: len(v) for k, v in json.loads(before).items()}
        out["filter"] = {"json": Path(json_path).name, "sources": len(kept), "kept": sum(kept.values())}
        require(sorted(kept) == sorted(Path(p).name for p in ds.original_images_paths) and
                sum(kept[f"{i}.jpg"] for i in tree_ids) == sum(kept.values()) > 0, "planes_biased aug-JSON",
                {k: v for k, v in kept.items() if v})

        # ---- cli train on the aug-JSON: 4 steps at batch 4, the validation's checkpoint
        ckpts = root / "ckpts"
        argv = ["train", "--dataset", "planes_biased", "--aug_json", json_path, "--aug_sample_ratio", "0.4",
                "--epochs", "1", "--batch_size", "4", "--train_sample_ratio", PB_TRAIN_SAMPLE_RATIO, "--seed", "1",
                "--logdir", str(ckpts / "aug")]
        logs, t = timed(lambda: cli.main(argv))
        require(Path(logs["ckpt_path"]).is_file() and logs["train_steps"] > 0 and np.isfinite(logs["train_train_loss"]),
                "planes_biased train", logs.get("ckpt_path"))
        out["train"] = {"argv": argv, "wall_s": t, "steps": logs["train_steps"], "loss": logs["train_train_loss"]}
        ckpt_files = [logs["ckpt_path"]]

        # ---- the CLIP soft-target teacher: cli train --dataset planes --use_target_soft_cross_entropy (the
        # planes split of the same images, 2 variants: its checkpoint fits the planes_biased net too)
        teacher_calls = []
        real_teacher = runner.make_clip_teacher

        def recording_teacher(*a, **k):
            teacher = real_teacher(*a, **k)

            def run(X):
                logits = teacher(X)
                teacher_calls.append((tuple(X.shape), tuple(logits.shape), bool(torch.isfinite(logits).all())))
                return logits

            return run

        runner.make_clip_teacher = recording_teacher
        try:
            argv = ["train", "--dataset", "planes", "--use_target_soft_cross_entropy", "--epochs", "1",
                    "--batch_size", "4", "--train_sample_ratio", PB_TRAIN_SAMPLE_RATIO, "--seed", "1", "--logdir",
                    str(ckpts / "teacher"), "--weights_dir", str(root / "weights")]
            logs, t = timed(lambda: cli.main(argv))
        finally:
            runner.make_clip_teacher = real_teacher
        n = logs["train_steps"]
        require(n > 0 and np.isfinite(logs["train_train_loss"]) and teacher_calls ==
                [((4, 3, 224, 224), (4, len(PB_VARIANTS)), True)] * n, "teacher train", n, teacher_calls[:2])
        out["teacher"] = {"argv": argv, "wall_s": t, "steps": n, "loss": logs["train_train_loss"],
                          "s_per_step_with_epoch": t / n}
        ckpt_files.append(logs["ckpt_path"])

        # ---- cli eval-biased over both checkpoints, the whole test split
        results, t = timed(lambda: cli.main(["eval-biased", "--ckpt_folder", str(ckpts)]))
        require(sorted(results) == sorted(ckpt_files), "eval-biased sweep", sorted(results))
        for path, r in results.items():
            require((r["n_id"], r["n_ood"]) == (552, 155) and all(
                0.0 <= r[k] <= 100.0 for k in ("mean_class_acc", "overall_acc", "id_acc", "ood_acc")),
                "eval-biased", path, r)
        out["eval_biased"] = {"wall_s": t, "images": 707 * len(results), "img_per_s": 707 * len(results) / t,
                              "results": {Path(k).parent.name: v for k, v in results.items()}}
        out["phase_s"] = time.perf_counter() - t_phase
        emit(out)
        os.chdir(old_cwd)
        require((sorted(thresholds.iterdir()) if thresholds.is_dir() else None) == thresholds_before,
                "the planes_biased phase changed", thresholds)
        return {"planes_biased": counts}
    finally:
        os.chdir(old_cwd)
        tpipelines.init_pipeline = real_init
        wload.REPORT_SUMS = False
        for h in root_logger.handlers[:]:
            root_logger.removeHandler(h)
        for h in old_handlers:
            root_logger.addHandler(h)
        root_logger.setLevel(old_level)
        for key, v in env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
        shutil.rmtree(root, ignore_errors=True)


UNIPC_SAMPLER = "unipcmultistep"


def run_unipc_phase(base, src, ids, neg_ids, latents, steps: int) -> dict:
    """The main path's batch on UniPC (module docstring, phase 14): `base`
    is the default configuration's DDIM pipeline, whose weights a UniPC
    pipeline takes; returns the UniPC batch's launch counts."""
    import gc

    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline, quantize
    from saspa_tpu_torch.diffusion.schedulers import UniPCScheduler, make_timesteps

    b, size = src.shape[0], src.shape[1]
    t = time.perf_counter()
    pipe = DiffusionPipeline("sd_v1.5", controlnet="canny", sampler=UNIPC_SAMPLER, dtype=torch.bfloat16,
                             init_seed=None)
    copy_weights(base, pipe)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    grid = [int(x) for x in pipe.scheduler.timesteps(steps)]
    require(isinstance(pipe.scheduler, UniPCScheduler) and
            grid == [int(x) for x in make_timesteps(pipe.scheduler.cfg, steps, multistep=True)], "UniPC grid", grid)

    def run(p, n):
        fn = p.make_fused_generate(size, size, n, 7.5, 0.75, 120.0, 200.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(p.params, ids, neg_ids, src, latents, return_images=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    run(pipe, 1)  # warm-up
    _, t1 = run(pipe, 1)
    reset_counts()
    (u8, images), ts = run(pipe, steps)
    counts = read_counts()
    want = expected_counts(steps, "default")
    require(counts == want, "unipc launch counts", counts, "expected DDIM's", want)
    require(u8.shape == (b, size, size, 3) and bool(torch.isfinite(images).all()), "unipc output", tuple(u8.shape))
    # the unfused entry point on the same ids, noise and control image
    control = pipe.control_from_src(src, size, size, 120.0, 200.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unfused = quantize(pipe.generate([""] * b, latents, size, size, steps, 7.5, control_image=control,
                                     controlnet_scale=0.75, token_ids=ids, negative_token_ids=neg_ids))
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    same = bool(torch.equal(unfused, u8))
    require(same, "unipc: the fused path differs from generate", (unfused != u8).float().mean().item())
    _, d1 = run(base, 1)  # DDIM, same weights, timed the same way
    (ddim_u8, _), dts = run(base, steps)
    out = {"phase": "unipc", "sampler": UNIPC_SAMPLER, "batch": b, "resolution": size, "steps": steps,
           "timesteps": grid, "ddim_timesteps": [int(x) for x in base.scheduler.timesteps(steps)], "init_s": init_s,
           "wall_s": ts, "wall_1step_s": t1, "s_per_step": (ts - t1) / (steps - 1), "img_per_s": b / ts,
           "ddim_wall_s": dts, "ddim_s_per_step": (dts - d1) / (steps - 1), "generate_s": generate_s,
           "launches": counts, "launches_expected": want, "fused_equals_generate": same,
           "uint8_mean": u8.float().mean().item(),
           "mean_abs_diff_vs_ddim": (u8.float() - ddim_u8.float()).abs().mean().item() / 255.0}
    emit(out)
    del pipe, u8, images, unfused, ddim_u8
    gc.collect()
    torch.cuda.empty_cache()
    return counts


JPEG_FIXTURES = "tests/fixtures/jpeg"  # PIL-written JPEGs beside PIL's pixels (tests/test_torch_jpeg.py)
JPEG_GEN_SOURCES = ("q90_420_512x512", "prog_420_512x512")  # baseline and progressive: one 512^2 bucket
JPEG_EVAL_SOURCES = ("q75_420_375x500", "prog_420_375x500", "q90_420_667x1000", "grey_q75_17x33",
                     "rst_rows_422_60x90", "opt_420_90x120", "q100_420_64x48", "prog_grey_47x61")
JPEG_TIMED = ("q90_420_512x512", "prog_420_512x512", "q90_420_667x1000")
JPEG_STEPS = 2
JPEG_THREADS = 8  # the train pipeline's decode threads


def write_jpeg_planes_tree(root, fixtures) -> dict:
    """A synthetic FGVC-Aircraft tree (4 variants) whose sources are real
    JPEG bytes: the train split 8 copies of JPEG_GEN_SOURCES, val and test
    one of each JPEG_EVAL_SOURCES, under FGVC-Aircraft ids, with the files
    PlanesUtils (gen) and the train datasets read.  Returns {split: [path]}."""
    import shutil
    from pathlib import Path

    data = Path(root) / "FGVC-Aircraft/fgvc-aircraft-2013b/data"
    (data / "images").mkdir(parents=True)
    makers = [("Boeing", "737-800"), ("Airbus", "A320"), ("Embraer", "E-190"), ("Cessna", "172")]
    splits = {"train": [JPEG_GEN_SOURCES[k % 2] for k in range(8)], "val": list(JPEG_EVAL_SOURCES),
              "test": list(JPEG_EVAL_SOURCES[::-1])}
    paths, k = {}, 0
    for split, names in splits.items():
        ids = []
        for name in names:
            ids.append(f"{3000000 + 11 * k:07d}")
            shutil.copyfile(Path(fixtures) / f"{name}.jpg", data / "images" / f"{ids[-1]}.jpg")
            k += 1
        (data / f"images_variant_{split}.txt").write_text("".join(
            f"{i} {makers[j % 4][1]}\n" for j, i in enumerate(ids)))
        if split == "train":
            (data / "images_train.txt").write_text("".join(f"{i}\n" for i in ids))
            (data / "images_manufacturer_train.txt").write_text("".join(
                f"{i} {makers[j % 4][0]}\n" for j, i in enumerate(ids)))
        paths[split] = [str(data / "images" / f"{i}.jpg") for i in ids]
    (data / "variants.txt").write_text("".join(f"{m[1]}\n" for m in makers))
    return paths


def run_jpeg_phase(seed: int) -> dict:
    """JPEG sources without PIL (module docstring, phase 15); returns the
    launch counts of its gen run."""
    import os
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.gen import jpeg as tjpeg
    from saspa_tpu_torch.gen.image_io import read_png

    fixtures = Path(__file__).resolve().parent / JPEG_FIXTURES
    names = sorted(p.name[:-len(".jpg")] for p in fixtures.glob("*.jpg"))
    require(len(names) >= 15, "JPEG fixtures", names)
    out = {"phase": "jpeg", "fixtures": len(names)}
    # ---- every fixture bit-equal to PIL's pixels, which PIL wrote as PNG beside it
    kinds = {}
    for name in names:
        data = (fixtures / f"{name}.jpg").read_bytes()
        got = tjpeg.decode_jpeg(data, name)
        want = read_png(fixtures / f"{name}.pil.png")
        rgb = np.repeat(got, 3, axis=2) if got.shape[2] == 1 else got
        require(rgb.shape == want.shape and np.array_equal(rgb, want), "JPEG decode differs from PIL's pixels", name)
        kinds[name] = list(got.shape)
    out["bit_equal_to_pil"] = kinds
    # ---- decode time a JPEG, beside read_png of the same pixels, and with the pipeline's threads
    timing = {}
    for name in JPEG_TIMED:
        data, png = (fixtures / f"{name}.jpg").read_bytes(), fixtures / f"{name}.pil.png"
        n = 20
        t = time.perf_counter()
        for _ in range(n):
            tjpeg.decode_jpeg(data)
        jpeg_ms = (time.perf_counter() - t) / n * 1e3
        t = time.perf_counter()
        for _ in range(n):
            read_png(png)
        png_ms = (time.perf_counter() - t) / n * 1e3
        with ThreadPoolExecutor(JPEG_THREADS) as ex:
            t = time.perf_counter()
            list(ex.map(lambda _: tjpeg.decode_jpeg(data), range(4 * JPEG_THREADS)))
            threads_ms = (time.perf_counter() - t) / (4 * JPEG_THREADS) * 1e3
        timing[name] = {"bytes": len(data), "decode_ms": jpeg_ms, "read_png_ms": png_ms,
                        f"decode_ms_{JPEG_THREADS}_threads": threads_ms, "thread_speedup": jpeg_ms / threads_ms}
    out["timing"] = timing
    out["host_cpus"] = os.cpu_count()

    root = Path(tempfile.mkdtemp(prefix="saspa_jpeg_"))
    env = {k: os.environ.get(k) for k in ("SASPA_DATA_ROOT", "SASPA_CHECKPOINTS")}
    os.environ["SASPA_DATA_ROOT"] = str(root)
    os.environ["SASPA_CHECKPOINTS"] = str(root / "checkpoints")  # none: seeded baselines
    root_logger = logging.getLogger()
    old_handlers, old_level = root_logger.handlers[:], root_logger.level
    real_decode = tjpeg.decode_jpeg
    decoded = []

    def counting_decode(data, name="<bytes>"):
        decoded.append(name)
        return real_decode(data, name)

    tjpeg.decode_jpeg = counting_decode
    try:
        paths = write_jpeg_planes_tree(root, fixtures)
        # ---- cli gen, the default recipe (SD1.5 + canny, then the semantic and top-10 filters), 2 steps
        argv = ["gen", "--dataset", "planes", "--resolution", "512", "--num_per_image", "1", "--num_inference_steps",
                str(JPEG_STEPS), "--batch_size", "8", "--seed", str(seed + 1)]
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        json_path = cli.main(argv)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        counts = read_counts()
        want = expected_counts(JPEG_STEPS, "default")  # one batch of 8 at 512^2
        require(counts == want, "jpeg gen launch counts", counts, "expected", want)
        require(set(paths["train"]) <= set(decoded), "jpeg gen: sources not read through decode_jpeg",
                sorted(set(paths["train"]) - set(decoded)))
        gen_decodes = len(decoded)
        recipe_bytes = Path(json_path).read_bytes()
        recipe = json.loads(recipe_bytes)
        require(sorted(recipe) == sorted(Path(p).name for p in paths["train"]), "jpeg aug-JSON keys", sorted(recipe))
        # ---- cli filter rebuilds the recipe's JSON byte for byte
        ds = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        folder = cli.gen_config(cli.build_parser().parse_args(argv)).with_dataset_overrides().output_folder(
            str(ds.root_path))
        require(sorted(ds.original_images_paths) == sorted(paths["train"]), "jpeg tree's sources",
                ds.original_images_paths)
        t = time.perf_counter()
        rebuilt = cli.main(["filter", "--dataset", "planes", "--aug_folder", folder])
        filter_s = time.perf_counter() - t
        require(rebuilt == json_path and Path(rebuilt).read_bytes() == recipe_bytes,
                "jpeg: cli filter's JSON differs from gen's", rebuilt)
        # ---- cli train on the aug-JSON: the JPEG originals in its batches, val and test
        del decoded[:]
        argv_train = ["train", "--dataset", "planes", "--aug_json", json_path, "--special_aug", "classic",
                      "--epochs", "1", "--seed", "1", "--logdir", str(root / "logs")]
        reset_counts()
        t = time.perf_counter()
        logs = cli.main(argv_train)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        lines = [json.loads(ln) for ln in (Path(logs["save_dir"]) / "metrics.jsonl").read_text().splitlines()]
        epoch = lines[0]
        require(epoch["steps"] == len(paths["train"]) // 4 and math.isfinite(epoch["train_loss"]),
                "jpeg train: the epoch's metrics", epoch)
        require(set(paths["val"]) | set(paths["test"]) <= set(decoded) and set(paths["train"]) & set(decoded),
                "jpeg train: originals not read through decode_jpeg", sorted(set(decoded)))
        require(not any(read_counts().values()), "jpeg train launched a kernel of K1-K6", read_counts())
        out.update({"gen_argv": argv, "gen_s": gen_s, "gen_decodes": gen_decodes, "launches": counts,
                    "launches_expected": want, "aug_json": Path(json_path).name,
                    "augs_kept": sum(len(v) for v in recipe.values()), "filter_s": filter_s,
                    "filter_rebuilt_equal": True, "train_argv": argv_train, "train_s": train_s,
                    "train_steps": epoch["steps"], "train_loss": epoch["train_loss"],
                    "train_decodes": len(decoded)})
        emit(out)
        return counts
    finally:
        tjpeg.decode_jpeg = real_decode
        root_logger.handlers[:] = old_handlers
        root_logger.setLevel(old_level)
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


REFINER_RESOLUTION = 512
REFINER_SOURCES = 8
REFINER_STEPS, REFINER_STRENGTH = 4, 0.5  # 2 denoise steps: 2 UNet calls at B16 under CFG 7.5


def run_refiner_phase(seed: int, checks: dict, checked_sites: dict) -> dict:
    """The SDXL refiner through `cli gen --base_model sd_xl --sdedit
    --controlnet none` (module docstring, phase 16); returns its launch
    counts and appends its K3 and K4 sites' rows to `checks`."""
    import gc
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import init_pipeline, quantize
    from saspa_tpu_torch.diffusion.schedulers import sdedit_start_step
    from saspa_tpu_torch.gen.image_io import read_png, read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.ops.image import resize_image
    from saspa_tpu_torch.utils import rng as rngs

    size, b = REFINER_RESOLUTION, REFINER_SOURCES
    n_steps = REFINER_STEPS - sdedit_start_step(REFINER_STEPS, REFINER_STRENGTH)
    root = tempfile.mkdtemp(prefix="saspa_refiner_")
    old_root = os.environ.get("SASPA_DATA_ROOT")
    os.environ["SASPA_DATA_ROOT"] = root
    tele = TelemetryHandler()
    root_logger = logging.getLogger()
    old_level = root_logger.level
    root_logger.setLevel(logging.INFO)
    root_logger.addHandler(tele)
    want = expected_sdedit_counts(n_steps, refiner=True)
    try:
        ids = write_planes_tree(root, np.random.RandomState(seed + 601), b, size)
        argv = ["gen", "--dataset", "planes", "--base_model", "sd_xl", "--sdedit", "--sdedit_strength",
                str(REFINER_STRENGTH), "--controlnet", "none", "--num_inference_steps", str(REFINER_STEPS),
                "--skip_filter", "--num_per_image", "1", "--batch_size", str(b), "--seed", str(seed + 1)]
        cfg = cli.gen_config(cli.build_parser().parse_args(argv)).with_dataset_overrides()
        require((cfg.base_model, cfg.controlnet, cfg.sdedit, cfg.guidance_scale) == ("sd_xl", None, True, 7.5),
                "refiner recipe", cfg)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        gc.collect()  # the driver's pipeline
        torch.cuda.empty_cache()
        require(len(tele.lines) == 1 and tele.lines[0]["num_errors"] == 0 and tele.lines[0]["total"] == b,
                "refiner telemetry", tele.lines, *tele.errors)
        require(counts == want, "refiner launch counts", counts, "expected", want)
        ds = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        folder = Path(cfg.output_folder(str(ds.root_path)))
        require("regular/sd_xl-SDEdit_strength_0.5/None/" in str(folder), "refiner folder", folder)
        files = sorted(folder.glob("*.png"))
        outs = {f.name.split("_prompt_")[0]: f for f in files if "_prompt_" in f.name}
        require(sorted(outs) == sorted(ids), "refiner files", [f.name for f in files])

        # the same batch through pipe.generate: same seeded weights, prompts,
        # sources / 255 and noise -> the PNGs' pixels, bit for bit
        t = time.perf_counter()
        pipe = init_pipeline("sd_xl", None, SDEdit=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        n_unet = sum(p.numel() for p in pipe.params["unet"].parameters())
        require(pipe.base_model == "sd_xl-refiner" and 2.2e9 < n_unet < 2.35e9 and len(pipe.params["text"]) == 1,
                "init_pipeline's refiner", pipe.base_model, n_unet)
        paths = ds.original_images_paths
        src = np.stack([resize_image(read_rgb(p), size) for p in paths])
        lf = pipe.latent_factor
        lat = np.stack([rngs.item_normal(cfg.seed, "noise", i, 0, shape=(size // lf, size // lf, 4))
                        for i in range(b)])
        engine = PromptEngine(cfg, ds, ds.get_image_stem_to_class_str_dict())
        prompts = [engine.build(p, i, 0) for i, p in enumerate(paths)]
        init = torch.as_tensor(src, device=pipe.device).float() / 255.0

        def generate(strength=REFINER_STRENGTH):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            images = pipe.generate(prompts, lat, height=size, width=size, num_inference_steps=REFINER_STEPS,
                                   guidance_scale=cfg.guidance_scale, negative_prompt=cfg.negative_prompt,
                                   init_image=init, sdedit_strength=strength)
            torch.cuda.synchronize()
            return images, time.perf_counter() - t0

        # one hooked call of 1 denoise step: the refiner's norm and attention sites
        sites, handles = record_sites(pipe)
        generate(0.25)
        for h in handles:
            h.remove()
        want_attn = {(2 * b, 1024, 768, 12), (2 * b, 256, 1536, 24), (2 * b, 64, 1536, 24)}
        require(sites["self_attention"] == want_attn, "refiner self-attention sites", sorted(sites["self_attention"]))
        _, t1 = generate(0.25)  # 1 denoise step, unhooked
        images, ts = generate()
        require(bool(torch.isfinite(images).all()), "refiner: non-finite images")
        u8 = quantize(images).cpu().numpy()
        same = [bool(np.array_equal(read_png(outs[i]), u8[k])) for k, i in enumerate(Path(p).stem for p in paths)]
        require(all(same), "refiner PNGs differ from generate's output", same)
        _, t3 = generate(0.75)  # 3 denoise steps

        # the refiner's K1/K2 shapes are in the kernels phase's lists; its K3
        # and K4 sites that no earlier phase checked are checked here
        for name, tag in (("attention_packed", "refiner level"), ("ln_geglu", "refiner")):
            require(sum(r["shape"].startswith(tag) for r in checks[name]) >= 2, "refiner rows missing", name)
        gen = torch.Generator(device="cuda").manual_seed(seed + 602)
        rows = {}
        for name, check in (("group_norm", check_k3), ("layernorm", check_k4)):
            new = sites[name] - checked_sites[name]
            rows[name] = [dict(r, cell="refiner") for r in check(gen, new)]
            checks[name] += rows[name]
            checked_sites[name] |= new
            emit({"phase": "kernels", "kernel": name, "cell": "refiner", "shapes": rows[name]})
        require(any(r["C"] == 384 for r in rows["group_norm"]) and
                {r["C"] for r in rows["layernorm"]} >= {768, 1536}, "refiner K3/K4 sites",
                sorted(sites["group_norm"], key=str), sorted(sites["layernorm"]))
        emit({"phase": "refiner", "argv": argv, "base_model": pipe.base_model, "unet_params": n_unet,
              "params": sum(p.numel() for m in pipe._modules() for p in m.parameters()), "batch": b,
              "resolution": size, "steps": REFINER_STEPS, "strength": REFINER_STRENGTH, "denoise_steps": n_steps,
              "time_ids": pipe.make_time_ids(1, size, size).tolist()[0],
              "negative_time_ids": pipe.make_time_ids(1, size, size, negative=True).tolist()[0],
              "init_s": init_s, "wall_s": wall, "img_per_s": b / wall, "generate_s": ts, "generate_1step_s": t1,
              "generate_3step_s": t3, "s_per_step": (t3 - t1) / 2, "peak_mem_bytes": peak, "launches": counts,
              "launches_expected": want, "self_attention_sites": sorted(sites["self_attention"]),
              "telemetry": tele.lines[0], "pngs_equal_generate": True, "uint8_mean": float(u8.mean())})
        del pipe, images, init
        gc.collect()
        torch.cuda.empty_cache()
        return {"refiner": counts}
    finally:
        root_logger.removeHandler(tele)
        root_logger.setLevel(old_level)
        if old_root is None:
            os.environ.pop("SASPA_DATA_ROOT", None)
        else:
            os.environ["SASPA_DATA_ROOT"] = old_root
        shutil.rmtree(root, ignore_errors=True)


NEW_RESOLUTION = 512
NEW_SOURCES = 8  # one batch of 8 a run
SD21_STEPS = 2
HED_STEPS = 2
HED_REFERENCE_RESOLUTION = 256  # the card-vs-CPU HED run, 2 sources
SD21_UNET_PARAMS = 865_910_724  # stabilityai/stable-diffusion-2-1's UNet (tests/test_convert_real_layout.py)


class PhaseRoot:
    """A temporary root for one phase: the working directory there, the
    variables of `env` set (SASPA_DATA_ROOT the root unless given), the
    driver's telemetry and errors captured in `tele`; all restored and the
    tree removed on exit."""

    def __init__(self, prefix: str, env=None):
        self.prefix, self.env = prefix, dict(env or {})

    def __enter__(self):
        import os
        import tempfile
        from pathlib import Path

        self.root = Path(tempfile.mkdtemp(prefix=self.prefix))
        env = {"SASPA_DATA_ROOT": str(self.root), "SASPA_CHECKPOINTS": str(self.root / "checkpoints"), **self.env}
        self.saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        self.cwd = os.getcwd()
        os.chdir(self.root)
        self.tele = TelemetryHandler()
        self.logger = logging.getLogger()
        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.tele)
        return self

    def __exit__(self, *exc):
        import os
        import shutil

        os.chdir(self.cwd)
        self.logger.removeHandler(self.tele)
        self.logger.setLevel(self.level)
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(self.root, ignore_errors=True)
        return False

    def gen(self, name: str, argv, want: dict, b: int):
        """One `cli gen` run with its launch counts against want; returns
        (its resolved configuration, cli.main's result, a record of the run)."""
        import gc

        from saspa_tpu_torch import cli

        args = cli.build_parser().parse_args(argv)
        cfg = (cli.preset_config(args) if args.preset else cli.gen_config(args)).with_dataset_overrides()
        self.tele.lines.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t = time.perf_counter()
        result = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        gc.collect()  # the driver's pipeline
        torch.cuda.empty_cache()
        require(len(self.tele.lines) == 1 and self.tele.lines[0]["num_errors"] == 0 and
                self.tele.lines[0]["total"] == b, name, "telemetry", self.tele.lines, *self.tele.errors)
        require(counts == want, name, "launch counts", counts, "expected", want)
        return cfg, result, {"argv": argv, "wall_s": wall, "img_per_s": b / wall, "peak_mem_bytes": peak,
                             "launches": counts, "launches_expected": want, "telemetry": self.tele.lines[0]}


def generated_pngs(cfg, ds) -> list:
    """A run's generated PNGs in the tree's order of sources."""
    from pathlib import Path

    from saspa_tpu_torch.gen.image_io import read_png

    stems = [Path(p).stem for p in ds.original_images_paths]
    files = sorted(Path(cfg.output_folder(str(ds.root_path))).glob("*.png"))
    outs = {f.name.split("_prompt_")[0]: f for f in files if "_prompt_" in f.name}
    require(sorted(outs) == sorted(stems), "generated files", [f.name for f in files])
    return [read_png(outs[s]) for s in stems]


def driver_batch(pipe, cfg, ds, classes):
    """The driver's inputs of a tree's 8 items: uint8 sources, noise,
    prompts, and their token ids and the negative prompt's."""
    from saspa_tpu_torch.gen.image_io import read_rgb
    from saspa_tpu_torch.gen.prompts import PromptEngine
    from saspa_tpu_torch.ops.image import resize_image
    from saspa_tpu_torch.utils import rng as rngs

    paths, res = ds.original_images_paths, cfg.resolution
    src = np.stack([resize_image(read_rgb(p), res) for p in paths])
    lf = pipe.latent_factor
    lat = np.stack([rngs.item_normal(cfg.seed, "noise", i, 0, shape=(res // lf, res // lf, 4))
                    for i in range(len(paths))])
    engine = PromptEngine(cfg, ds, classes)
    prompts = [engine.build(p, i, 0) for i, p in enumerate(paths)]
    return {"src": src, "lat": lat, "prompts": prompts, "ids": pipe.tokenizer(prompts, pad="eot"),
            "neg_ids": pipe.tokenizer([cfg.negative_prompt or ""] * len(paths), pad="eot")}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def same_pngs(what, pngs, u8) -> None:
    same = [bool(np.array_equal(p, u)) for p, u in zip(pngs, u8)]
    require(len(same) == len(u8) and all(same), what, "PNGs differ from the pipeline's output", same)


def run_sd21_phase(seed: int, checks: dict) -> dict:
    """SD2.1 + canny through `cli gen --base_model sd_v2.1` (module
    docstring, phase 17); returns its launch counts."""
    import gc

    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import init_pipeline, quantize

    size, b, steps = NEW_RESOLUTION, NEW_SOURCES, SD21_STEPS
    with PhaseRoot("saspa_sd21_") as ph:
        write_planes_tree(ph.root, np.random.RandomState(seed + 701), b, size)
        argv = ["gen", "--dataset", "planes", "--base_model", "sd_v2.1", "--skip_filter", "--num_per_image", "1",
                "--num_inference_steps", str(steps), "--batch_size", str(b), "--seed", str(seed + 1)]
        want = expected_counts(steps, "default")
        cfg, _, run = ph.gen("sd21", argv, want, b)
        require((cfg.base_model, cfg.controlnet, cfg.resolution) == ("sd_v2.1", "canny", size), "sd21 recipe", cfg)
        ds = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        pngs = generated_pngs(cfg, ds)

        # the same batch through the fused function and through generate:
        # same seeded weights, prompts, sources and noise, bit for bit
        pipe, init_s = timed(lambda: init_pipeline("sd_v2.1", "canny"))
        n_unet = sum(p.numel() for p in pipe.params["unet"].parameters())
        n_text = sum(p.numel() for p in pipe.params["text"][0].parameters())
        require(n_unet == SD21_UNET_PARAMS and 3.39e8 < n_text < 3.41e8, "SD2.1 widths", n_unet, n_text)
        x = driver_batch(pipe, cfg, ds, ds.get_image_stem_to_class_str_dict())

        def fused(n_steps):
            fn = pipe.make_fused_generate(size, size, n_steps, cfg.guidance_scale, 0.75, 120.0, 200.0)
            return timed(lambda: fn(pipe.params, x["ids"], x["neg_ids"], x["src"], x["lat"]))

        sites, handles = record_sites(pipe)
        fused(1)  # warm-up, hooked: the self-attention sites
        for h in handles:
            h.remove()
        k1_sites = {(bb, ll, hh) for bb, ll, _, hh in sites["self_attention"] if ll >= 256}
        k1_rows = {(r["B"], r["L"], r["H"]) for r in checks["attention_packed"] if r["shape"].startswith("sd21")}
        require(k1_sites == k1_rows == {(b, 4096, 5), (2 * b, 4096, 5), (2 * b, 1024, 10), (2 * b, 256, 20)},
                "sd21 K1 sites", sorted(k1_sites), sorted(k1_rows))
        u8, ts = fused(steps)
        u8 = u8.cpu().numpy()
        same_pngs("sd21 (fused)", pngs, u8)
        _, t1 = fused(1)
        images, tg = timed(lambda: pipe.generate(
            x["prompts"], x["lat"], size, size, steps, cfg.guidance_scale, cfg.negative_prompt,
            control_image=pipe.control_from_src(x["src"], size, size), controlnet_scale=0.75))
        require(bool(torch.isfinite(images).all()), "sd21: non-finite images")
        same_pngs("sd21 (generate)", pngs, quantize(images).cpu().numpy())
        emit({"phase": "sd21", **run, "base_model": pipe.base_model, "unet_params": n_unet, "text_params": n_text,
              "params": sum(p.numel() for m in pipe._modules() for p in m.parameters()), "batch": b,
              "resolution": size, "steps": steps, "init_s": init_s, "fused_s": ts, "fused_1step_s": t1,
              "s_per_step": (ts - t1) / (steps - 1), "generate_s": tg, "pngs_equal_fused": True,
              "pngs_equal_generate": True, "self_attention_sites": sorted(sites["self_attention"]),
              "uint8_mean": float(u8.mean())})
        del pipe, images
        gc.collect()
        torch.cuda.empty_cache()
        return {"sd21": run["launches"]}


def calibrated_hed(hed, images):
    """An f32 CPU copy of `hed` whose offset is the images' mean colour
    (x 255) and whose five projections are scaled and shifted so that each
    side output has mean 0 and std 1 on `images` ((B, H, W, 3) in [0, 1],
    CPU f32): seeded weights put every side output far from 0 and saturate
    the sigmoid; calibrated, the edge map spreads over (0, 1)."""
    from saspa_tpu_torch.models.hed import HED, STAGES

    cpu = HED(torch.float32, "cpu")
    cpu.load_state_dict({n: t.float().cpu() for n, t in hed.state_dict().items()})
    cpu.norm.copy_((images * 255.0).mean(dim=(0, 1, 2)).reshape(1, 1, 1, 3))
    moments, handles = {}, []

    def record(si):
        def hook(mod, args, out):
            moments[si] = (out.mean().item(), out.std().item())
        return hook

    for si in range(1, len(STAGES) + 1):
        handles.append(getattr(cpu, f"block{si}_projection").register_forward_hook(record(si)))
    cpu(images)
    for h in handles:
        h.remove()
    for si, (mean, std) in moments.items():
        proj = getattr(cpu, f"block{si}_projection")
        proj.kernel.div_(std)
        proj.bias.sub_(mean).div_(std)
    return cpu


def run_hed_phase(seed: int) -> dict:
    """The HED ControlNet through `cli gen --controlnet hed` on SD1.5, with
    SDEdit and on BLIP-Diffusion (module docstring, phase 18); returns the
    launch counts of its runs."""
    import gc
    import os

    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import init_pipeline, quantize
    from saspa_tpu_torch.models.hed import HED, hed_control_image

    size, b = NEW_RESOLUTION, NEW_SOURCES
    out, counts = {"phase": "hed", "batch": b, "resolution": size}, {}
    with PhaseRoot("saspa_hed_") as ph:
        write_planes_tree(ph.root, np.random.RandomState(seed + 711), b, size)
        # ---- SD1.5 + HED, the fused path
        argv = ["gen", "--dataset", "planes", "--controlnet", "hed", "--skip_filter", "--num_per_image", "1",
                "--num_inference_steps", str(HED_STEPS), "--batch_size", str(b), "--seed", str(seed + 1)]
        cfg, _, out["hed"] = ph.gen("hed", argv, expected_counts(HED_STEPS, "default"), b)
        counts["hed"] = out["hed"]["launches"]
        require(cfg.controlnet == "hed" and cfg.base_model == "sd_v1.5", "hed recipe", cfg)
        ds = DS_UTILS_DICT["planes"](print_func=lambda *a: None)
        pngs = generated_pngs(cfg, ds)
        pipe, init_s = timed(lambda: init_pipeline("sd_v1.5", "hed"))
        hed = pipe.params["hed"]
        x = driver_batch(pipe, cfg, ds, ds.get_image_stem_to_class_str_dict())
        fn = pipe.make_fused_generate(size, size, HED_STEPS, cfg.guidance_scale, 0.75, 120.0, 200.0)
        u8, ts = timed(lambda: fn(pipe.params, x["ids"], x["neg_ids"], x["src"], x["lat"]))
        same_pngs("hed (fused)", pngs, u8.cpu().numpy())
        control = pipe.control_from_src(x["src"], size, size)
        images = pipe.generate(x["prompts"], x["lat"], size, size, HED_STEPS, cfg.guidance_scale,
                               cfg.negative_prompt, control_image=control, controlnet_scale=0.75)
        same_pngs("hed (generate)", pngs, quantize(images).cpu().numpy())
        # HED's time on the card at B8 512^2 (sources / 255 in f32, bf16 convolutions)
        src01 = torch.as_tensor(x["src"], device="cuda").float() / 255.0
        with torch.no_grad():
            hed_ms = cuda_ms(lambda: hed_control_image(hed, src01), 5)
            prof = profile_run(lambda: timed(lambda: hed_control_image(hed, src01)))
            # card bf16 against an f32 CPU run of the same weights on 2 sources
            # at 256^2; the seeded weights saturate the edge map at 0, so both
            # take them calibrated on these sources (calibrated_hed)
            k = size // HED_REFERENCE_RESOLUTION
            small = torch.as_tensor(x["src"][:2, ::k, ::k]).float() / 255.0
            cpu_hed = calibrated_hed(hed, small)
            card_hed = HED(torch.bfloat16, "cuda")
            card_hed.load_state_dict(cpu_hed.state_dict())
            t = time.perf_counter()
            ref = hed_control_image(cpu_hed, small)
            cpu_s = time.perf_counter() - t
            card = hed_control_image(card_hed, small.cuda()).float().cpu()
        require(ref.std().item() >= 0.05, "the calibrated HED's edge map does not spread", ref.std().item())
        diff = (card - ref).abs()
        out["hed"].update({"init_s": init_s, "fused_s": ts, "pngs_equal_fused": True, "pngs_equal_generate": True,
                           "hed_ms": hed_ms, "hed_device_ms": prof["device_busy_s"] * 1e3,
                           "hed_kernels": sum(r["calls"] for r in prof["kernels"]),
                           "hed_params": sum(p.numel() for p in hed.parameters()),
                           "edge_mean": float(control.mean()),
                           "card_vs_cpu": {"resolution": HED_REFERENCE_RESOLUTION, "calibrated": True,
                                           "mean_abs_diff": diff.mean().item(), "max_abs_diff": diff.max().item(),
                                           "cpu_s": cpu_s, "edge_spread": float(ref.std()),
                                           "edge_mean": float(ref.mean())}})
        # bf16 convolutions through 13 layers against f32: the edge maps (in
        # [0, 1]) agree to 0.01 on average
        require(diff.mean().item() <= 0.01, "hed card vs CPU mean |diff|", diff.mean().item())

        # ---- SDEdit + HED: the unfused path, the control image of the sources
        argv = ["gen", "--dataset", "planes", "--controlnet", "hed", "--sdedit", "--sdedit_strength", "0.5",
                "--num_inference_steps", "4", "--skip_filter", "--num_per_image", "1", "--batch_size", str(b),
                "--seed", str(seed + 2)]
        cfg, _, out["sdedit_hed"] = ph.gen("sdedit_hed", argv, expected_sdedit_counts(2, controlnet=True), b)
        counts["sdedit_hed"] = out["sdedit_hed"]["launches"]
        x = driver_batch(pipe, cfg, ds, ds.get_image_stem_to_class_str_dict())
        init = torch.as_tensor(x["src"], device="cuda").float() / 255.0
        images = pipe.generate(x["prompts"], x["lat"], size, size, 4, cfg.guidance_scale, cfg.negative_prompt,
                               control_image=pipe.control_from_src(x["src"], size, size), controlnet_scale=0.75,
                               init_image=init, sdedit_strength=0.5)
        same_pngs("sdedit_hed", generated_pngs(cfg, ds), quantize(images).cpu().numpy())
        out["sdedit_hed"]["pngs_equal_generate"] = True
        del pipe, images, init, src01, hed, card_hed
        gc.collect()
        torch.cuda.empty_cache()

        # ---- BLIP-Diffusion + HED on dtd (the fused path, HED inside it)
        os.environ["SASPA_DATA_ROOT"] = "data"  # DTD's captions are keyed by paths under data/
        write_dtd_tree(ph.root, np.random.RandomState(seed + 712), size)
        argv = ["gen", "--dataset", "dtd", "--controlnet", "hed", "--skip_filter", "--num_per_image", "1",
                "--resolution", str(size), "--num_inference_steps", str(HED_STEPS), "--batch_size", str(b),
                "--seed", str(seed + 3)]
        cfg, folder, out["blip_hed"] = ph.gen("blip_hed", argv, expected_counts(HED_STEPS, "default"), b)
        counts["blip_hed"] = out["blip_hed"]["launches"]
        require(cfg.base_model == "blip_diffusion" and "/hed/" in folder, "blip + hed", cfg, folder)
        blip = generated_pngs(cfg, DS_UTILS_DICT["dtd"](print_func=lambda *a: None))
        require(all(p.shape == (size, size, 3) for p in blip), "blip_hed PNGs", [p.shape for p in blip])
        out["blip_hed"]["uint8_mean"] = float(np.mean(blip))
        emit(out)
        return counts


def f32_vae_counts(want: dict, decodes: int, encodes: int = 0) -> dict:
    """`want` with the XL VAE in f32: its attention (one a decode, one an
    encode) and its GroupNorms (30 a decode, 22 an encode) move from the bf16
    counts to the f32 kernels'."""
    k1, k3 = decodes + encodes, 30 * decodes + 22 * encodes
    return {**want, "attention_packed": want["attention_packed"] - k1, "group_norm": want["group_norm"] - k3,
            "attention_packed_f32": k1, "group_norm_f32": k3}


def vae_f32_sites(pipe, images) -> dict:
    """The f32 VAE's GroupNorm sites {(B, C, H, W, act, eps)} and the inputs
    of its two mid attentions ("encoder", "decoder": (B, C, h, w) f32) over
    one encode of images and one decode of the result."""
    from saspa_tpu_torch.models.unet import GroupNorm32

    vae = pipe.params["vae"]
    sites, attn, handles = set(), {}, []
    for m in vae.modules():
        if isinstance(m, GroupNorm32):
            handles.append(m.register_forward_pre_hook(lambda mod, a: sites.add((*a[0].shape, mod.act, mod.eps))))
    for part in ("encoder", "decoder"):
        blk = getattr(vae, part).mid_attn
        handles.append(blk.register_forward_pre_hook(lambda mod, a, p=part: attn.setdefault(p, a[0])))
    with torch.no_grad():
        vae.decode(vae.encode(images.permute(0, 3, 1, 2) * 2.0 - 1.0)[0])
    for h in handles:
        h.remove()
    return {"group_norm": sites, "attention": attn}


def check_k1_f32(pipe, attn_inputs) -> list:
    """K1 in f32 at the VAE's two mid attentions, on their own activations
    (q, k, v made as VAEAttentionBlock makes them) against the plain version:
    within 1e-4 of the largest output (f32 throughout; the online softmax
    and the products sum in other orders); times, bound (f32 operations at
    67 TFLOP/s), SDPA in f32 as the yardstick."""
    from saspa_tpu_torch.ops import attention as att

    rows = []
    for part, x in sorted(attn_inputs.items()):
        blk = getattr(pipe.params["vae"], part).mid_attn
        b, c, h, w = x.shape
        with torch.no_grad():
            xn = blk.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
            q = att.fold_scale(blk.to_q(xn), (1.0 / math.sqrt(c)) * att.LOG2E).contiguous()
            k, v = blk.to_k(xn).contiguous(), blk.to_v(xn).contiguous()
            require(q.dtype == torch.float32, "the f32 VAE's attention in", q.dtype)
            out = att.flash_attention_packed(q, k, v, 1)
            ref = att.flash_attention_packed_plain(q, k, v, 1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        what = f"xl vae {part} mid attention, f32"
        require(err <= 1e-4 * ref_max, what, "max |kernel - plain|", err, "> 1e-4 of", ref_max)
        l = h * w
        qh, kh, vh = (t.reshape(b, l, 1, c).transpose(1, 2) for t in (q, k, v))

        def kernel():
            return att.flash_attention_packed(q, k, v, 1)

        b_ms, b_by = bound(4.0 * b * l * l * c, 4 * b * l * c * 4, H100_F32_FLOPS, exps=b * l * l)
        ms = cuda_ms(kernel, 5)
        dev_ms, _ = device_ms(kernel, floor_ms=b_ms)
        rows.append(dict(shape=what, cell="xl_vae_f32", B=b, L=l, H=1, d=c, d_pad=c, max_abs_err=err,
                         ref_max=ref_max, rel_err=err / ref_max, ms=ms, device_ms=dev_ms,
                         plain_ms=cuda_ms(lambda: att.flash_attention_packed_plain(q, k, v, 1), 2, warmup=1),
                         library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                             qh, kh, vh, scale=math.log(2.0)), 3),
                         bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms))
        del q, k, v, out, ref, xn
    return rows


def check_k3_f32(gen, sites) -> list:
    """K3 in f32 at every f32 site: both epilogues against their plain
    versions, within 2e-5 of the largest output (f32 out; the statistics
    sum in another order); times of the xla order (the path's) with
    F.group_norm as the yardstick where there is no SiLU, the TPU
    numerics' time at the largest site."""
    from saspa_tpu_torch.ops import groupnorm as gn

    rows = []
    order = sorted(sites, key=lambda s: (s[0] * s[1] * s[2] * s[3], s[1], str(s[4])))
    for (b, c, h, w, act, eps) in order:
        x = torch.randn(b, c, h, w, generator=gen, device="cuda").mul_(3.0).add_(0.5)
        x = x.to(memory_format=torch.channels_last)
        gamma = 1.0 + 0.2 * torch.randn(c, generator=gen, device="cuda")
        beta = 0.2 * torch.randn(c, generator=gen, device="cuda")
        n = x.numel()
        b_ms, b_by = bound((10.0 if act else 6.0) * n, 8 * n + 8 * c, H100_F32_FLOPS)
        lib = {"library_ms": None, "library_device_ms": None}
        if act is None:
            def library():
                return torch.nn.functional.group_norm(x, gn.groups_for(c, 32), gamma, beta, eps)

            lib = {"library_ms": cuda_ms(library, 5), "library_device_ms": device_ms(library)[0]}
        for tpu in (False, True):
            plain = gn.group_norm_tpu_plain if tpu else gn.group_norm_plain

            def kernel():
                return gn.group_norm(x, gamma, beta, 32, eps, act, tpu_numerics=tpu)

            out, ref = kernel(), plain(x, gamma, beta, 32, eps, act)
            err, ref_max = (out - ref).abs().max().item(), ref.abs().max().item()
            what = f"f32 B{b} C{c} {h}x{w} act={act} {'tpu' if tpu else 'xla'}"
            require(out.dtype == torch.float32 and err <= 2e-5 * ref_max, what, "max |kernel - plain|", err,
                    "> 2e-5 of", ref_max)
            del out, ref
            timed_row = not tpu or (h, w, c) == max((s[2], s[3], s[1]) for s in sites)
            row = dict(shape=what, cell="xl_vae_f32", B=b, C=c, HW=h * w, act=act, eps=eps, tpu_numerics=tpu,
                       plan=list(gn.gn_plan(b, h * w, c, gn.sm_count(x.device), 4)), max_abs_err=err,
                       ref_max=ref_max, rel_err=err / ref_max, bound_ms=b_ms, bound_by=b_by, **lib)
            if timed_row:
                ms = cuda_ms(kernel, 5)
                row.update(ms=ms, plain_ms=cuda_ms(lambda: plain(x, gamma, beta, 32, eps, act), 2, warmup=1),
                           host_us=host_us(kernel), bound_share=b_ms / ms)
            rows.append(row)
        del x
        torch.cuda.empty_cache()
    return rows


def run_xl_vae_f32_phase(seed: int, checks: dict) -> dict:
    """The XL VAE in f32 (SASPA_XL_VAE_FP32=1) through `cli gen --dataset
    cub` and `--preset alia --dataset cub` (module docstring, phase 19);
    returns the launch counts of both runs and puts the f32 kernels' rows in
    `checks`."""
    import gc

    from saspa_tpu_torch.data.registry import DS_UTILS_DICT
    from saspa_tpu_torch.diffusion.pipelines import init_pipeline, quantize
    from saspa_tpu_torch.models.vae import AutoencoderKL

    size, b, steps = NEW_RESOLUTION, NEW_SOURCES, XL_STEPS
    out, counts = {"phase": "xl_vae_f32", "batch": b, "resolution": size}, {}
    with PhaseRoot("saspa_xl_vae_f32_", {"SASPA_XL_VAE_FP32": "1"}) as ph:
        write_cub_tree(ph.root, np.random.RandomState(seed + 801), b, size)
        ds = DS_UTILS_DICT["cub"](print_func=lambda *a: None)
        classes = ds.get_image_path_to_class_str_dict()
        # ---- cub's recipe: SDXL-Turbo + ControlNet-XL, 2 steps, guidance 0; the decode in f32
        argv = ["gen", "--dataset", "cub", "--skip_filter", "--num_per_image", "1", "--batch_size", str(b),
                "--seed", str(seed + 1)]
        cfg, _, out["cub"] = ph.gen("xl_vae_f32 cub", argv, f32_vae_counts(expected_xl_counts(steps), 1), b)
        counts["xl_vae_f32"] = out["cub"]["launches"]
        require((cfg.base_model, cfg.controlnet, cfg.guidance_scale) == ("sd_xl-turbo", "canny", 0.0), "cub", cfg)
        pngs = generated_pngs(cfg, ds)
        pipe, init_s = timed(lambda: init_pipeline("sd_xl-turbo", "canny"))
        require(pipe.vae_dtype == torch.float32 and pipe.params["unet"].conv_in.kernel.dtype == torch.bfloat16,
                "SASPA_XL_VAE_FP32: the VAE in f32, the UNet in bf16", pipe.vae_dtype)
        x = driver_batch(pipe, cfg, ds, classes)
        fn = pipe.make_fused_generate(size, size, steps, 0.0, 0.75, 120.0, 200.0)
        (u8, _), ts = timed(lambda: fn(pipe.params, x["ids"], x["neg_ids"], x["src"], x["lat"], return_images=True))
        u8 = u8.cpu().numpy()
        same_pngs("xl_vae_f32 cub (fused)", pngs, u8)
        # the same latents through the bf16 VAE of the same weights, rounded: for information
        vae32 = pipe.params["vae"]
        vae16 = AutoencoderKL(vae32.cfg, torch.bfloat16, "cuda")
        vae16.load_state_dict(vae32.state_dict())  # each parameter in vae16's dtype: kernels bf16, norms f32
        pipe.params["vae"] = vae16
        reset_counts()
        u8_16 = fn(pipe.params, x["ids"], x["neg_ids"], x["src"], x["lat"]).cpu().numpy()
        require(read_counts()["group_norm_f32"] == 0, "the bf16 decode launched the f32 kernels")
        pipe.params["vae"] = vae32
        del vae16
        out["cub"].update({"init_s": init_s, "fused_s": ts, "pngs_equal_fused": True,
                           "mean_abs_levels_f32_vs_bf16_vae": float(np.abs(u8.astype(np.int32) - u8_16).mean()),
                           "max_abs_levels_f32_vs_bf16_vae": int(np.abs(u8.astype(np.int32) - u8_16).max())})
        # the f32 sites of one encode and one decode of the sources: K1 at both
        # mid attentions, K3 at every GroupNorm (both epilogues)
        src01 = torch.as_tensor(x["src"], device="cuda").float() / 255.0
        sites = vae_f32_sites(pipe, src01)
        require(len(sites["attention"]) == 2 and sites["group_norm"], "f32 VAE sites", sites["group_norm"])
        checks["attention_packed_f32"] = check_k1_f32(pipe, sites["attention"])
        emit({"phase": "kernels", "kernel": "attention_packed_f32", "cell": "xl_vae_f32",
              "shapes": checks["attention_packed_f32"]})
        del pipe, src01, sites["attention"]
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(seed + 802)
        checks["group_norm_f32"] = check_k3_f32(gen, sites["group_norm"])
        emit({"phase": "kernels", "kernel": "group_norm_f32", "cell": "xl_vae_f32",
              "shapes": checks["group_norm_f32"]})

        # ---- ALIA on cub: SDXL-Turbo + SDEdit, 1 trailing step; the encode and the decode in f32
        argv = ["gen", "--preset", "alia", "--dataset", "cub", "--num_per_image", "1", "--batch_size", str(b),
                "--seed", str(seed + 2)]
        cfg, _, out["alia_cub"] = ph.gen("xl_vae_f32 alia_cub", argv,
                                         f32_vae_counts(expected_sdedit_counts(1, xl=True), 1, 1), b)
        counts["xl_vae_f32_alia"] = out["alia_cub"]["launches"]
        require((cfg.base_model, cfg.controlnet, cfg.sdedit, cfg.guidance_scale) == ("sd_xl-turbo", None, True, 0.0),
                "alia on cub", cfg)
        xpipe = init_pipeline("sd_xl-turbo", None, SDEdit=True)
        x = driver_batch(xpipe, cfg, ds, classes)
        init = torch.as_tensor(x["src"], device="cuda").float() / 255.0
        images, tg = timed(lambda: xpipe.generate(
            x["prompts"], x["lat"], size, size, cfg.num_inference_steps, cfg.guidance_scale, cfg.negative_prompt,
            init_image=init, sdedit_strength=cfg.sdedit_strength))
        require(bool(torch.isfinite(images).all()), "alia cub: non-finite images")
        same_pngs("xl_vae_f32 alia_cub (generate)", generated_pngs(cfg, ds), quantize(images).cpu().numpy())
        encode_ms = cuda_ms(lambda: xpipe.encode_image(init), 3)
        out["alia_cub"].update({"generate_s": tg, "pngs_equal_generate": True, "encode_ms": encode_ms})
        emit(out)
        del xpipe, images, init
        gc.collect()
        torch.cuda.empty_cache()
        return counts


# ---- phase 20: the prompt and caption tools ---------------------------------
CAPTION_JPEGS = ("q75_420_375x500", "prog_420_375x500", "q90_420_667x1000", "opt_420_90x120")
CAPTION_PNG_HW = ((480, 640), (375, 500), (300, 300), (900, 600))  # larger and smaller than BLIP's 384 / 480
CAPTION_QUESTIONS = ("what color is the plane?", "is it day or night?")
PROMPTS_NUM = 16
CAPTION_MARGIN = 1e-3  # ids are held card vs CPU up to the first step whose CPU top-2 margin is below this
# read but not loaded: BERT's tied MLM bias (cls.predictions.bias is loaded) and T5's tied copies of shared.weight
CAPTION_NOT_LOADED = WEIGHTS_NOT_LOADED + ("cls.predictions.decoder.bias", "embed_tokens", "lm_head")


def unit_norms(sd: dict, rng) -> dict:
    """The layouts' LayerNorm and RMS weights at 1 + N(0, 0.1^2) instead of
    N(0, 0.02^2): seeded networks whose activations keep their scale, so the
    logits' top-2 margins are not all below CAPTION_MARGIN."""
    for k in sd:
        leaf = k.rsplit(".", 2)
        if k.endswith(".weight") and ("norm" in leaf[-2].lower() or "LayerNorm" in k or "layer_norm" in k):
            sd[k] = (1 + 0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    return sd


def hf_t5_state_dict(fill) -> dict:
    """mrm8488/t5-base-finetuned-common_gen's pytorch_model.bin layout at
    t5-base's width (12 + 12 blocks, d_model 768, 12 heads of 64, FFN 3072,
    32128 tokens, 32 buckets), seeded; the tied copies hold shared.weight's
    values, as the .bin does."""
    from tools.synth_checkpoints import _SD

    sd = _SD(fill)
    d, inner, heads = 768, 768, 12
    sd.t("shared.weight", 32128, d)
    for stack, n_sub in (("encoder", 2), ("decoder", 3)):
        for i in range(12):
            b = f"{stack}.block.{i}.layer"
            attns = [(f"{b}.0.SelfAttention", i == 0)] + ([(f"{b}.1.EncDecAttention", False)] if n_sub == 3 else [])
            for name, rel in attns:
                for m in "qkv":
                    sd.linear(f"{name}.{m}", inner, d, bias=False)
                sd.linear(f"{name}.o", d, inner, bias=False)
                if rel:
                    sd.t(f"{name}.relative_attention_bias.weight", 32, heads)
            for j in range(n_sub):
                sd.t(f"{b}.{j}.layer_norm.weight", d)
            sd.linear(f"{b}.{n_sub - 1}.DenseReluDense.wi", 3072, d, bias=False)
            sd.linear(f"{b}.{n_sub - 1}.DenseReluDense.wo", d, 3072, bias=False)
        sd.t(f"{stack}.final_layer_norm.weight", d)
    return dict(sd)


def write_caption_weights(root, seed: int) -> dict:
    """The prompt tools' public files under root, full width, seeded:
    LAVIS's model_base_caption_capfilt_large.pth and
    model_base_vqa_capfilt_large.pth ({"model": sd}, tools/
    synth_checkpoints.py's layouts), the T5's pytorch_model.bin (tied copies
    sharing one tensor), and a 30522-line WordPiece vocab.txt.  Returns
    {path: (elements, f64 sum)} of what each file holds for its model."""
    from pathlib import Path

    from tools import synth_checkpoints as synth

    root = Path(root)
    fill = NormalFill(seed)
    rng = np.random.default_rng(seed + 1)
    sums = {}
    for name, make in (("model_base_caption_capfilt_large.pth", synth.lavis_blip_caption_state_dict),
                       ("model_base_vqa_capfilt_large.pth", synth.lavis_blip_vqa_state_dict)):
        sd = unit_norms(make(fill=fill), rng)  # cls.predictions.bias is decoder.bias, as HF's head saves it
        torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, root / name)
        sums[str(root / name)] = caption_file_sum(sd)
        del sd
    sd = unit_norms(hf_t5_state_dict(fill), rng)
    shared = torch.from_numpy(sd["shared.weight"])
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    tensors.update({k: shared for k in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight",
                                        "lm_head.weight")})
    folder = root / "t5-base-finetuned-common_gen"
    folder.mkdir()
    torch.save(tensors, folder / "pytorch_model.bin")
    sums[str(folder / "pytorch_model.bin")] = caption_file_sum(sd)
    # bert-base-uncased's specials where BERT has them, the caption prompt's
    # words, then made-up words and word pieces
    words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words += ["a", "picture", "of", "the", "plane", "white", "blue", "day", "night", "sky"]
    words += [f"w{i}" if i % 2 else f"##p{i}" for i in range(30522 - len(words))]
    (root / "tokenizer").mkdir()
    (root / "tokenizer" / "vocab.txt").write_text("\n".join(words) + "\n")
    return sums


def caption_file_sum(sd: dict):
    kept = [v for k, v in sd.items() if not any(x in k for x in CAPTION_NOT_LOADED)]
    return sum(v.size for v in kept), float(sum(np.sum(v, dtype=np.float64) for v in kept))


def rel_err(card: torch.Tensor, cpu: torch.Tensor) -> float:
    return float((card.float().cpu() - cpu).abs().max() / cpu.abs().max())


def ids_agree(card_ids: torch.Tensor, cpu_ids: torch.Tensor, cpu_margins: torch.Tensor, start: int) -> dict:
    """Card and CPU ids (B, L) equal at every generated position up to the
    first step whose CPU top-2 margin (B, steps) is below CAPTION_MARGIN."""
    low = (cpu_margins < CAPTION_MARGIN).any(dim=0).nonzero()
    cut = int(low[0]) if len(low) else cpu_margins.shape[1]
    equal = bool(torch.equal(card_ids.cpu()[:, start:start + cut], cpu_ids[:, start:start + cut]))
    return {"first_low_margin_step": int(low[0]) if len(low) else None, "steps_held": cut, "equal": equal,
            "min_margin": float(cpu_margins.min()), "all_steps_equal": bool(torch.equal(card_ids.cpu(), cpu_ids))}


def run_captions_phase(seed: int) -> dict:
    """The prompt and caption tools through `cli prep-captions` and `cli
    prep-prompts` (module docstring, phase 20); returns their launch counts,
    which must be 0."""
    import gc
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.gen import caption_tools
    from saspa_tpu_torch.gen.image_io import read_rgb, write_png
    from saspa_tpu_torch.models import blip_caption as bc
    from saspa_tpu_torch.models import blip_vqa as bv
    from saspa_tpu_torch.models import t5 as t5m
    from saspa_tpu_torch.utils import graphs
    from saspa_tpu_torch.utils import rng as rngs
    from saspa_tpu_torch.weights import load as wload

    fixtures = Path(__file__).resolve().parent / JPEG_FIXTURES
    out = {"phase": "captions"}
    made = {}
    factories = {k: getattr(caption_tools, k) for k in ("_default_captioner", "_default_vqa",
                                                         "_default_sentence_generator")}

    def recording(name):
        return lambda *a: made.setdefault(name, factories[name](*a))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    wload.REPORT_SUMS = True
    try:
        with PhaseRoot("saspa_captions_") as ph:
            for name in factories:
                setattr(caption_tools, name, recording(name))
            wd = ph.root / "weights"
            wd.mkdir()
            file_sums, out["write_s"] = timed(lambda: write_caption_weights(wd, seed + 801))
            out["tree_bytes"] = sum(f.stat().st_size for f in wd.rglob("*") if f.is_file())
            srcs = []
            rs = np.random.RandomState(seed + 802)
            for i, (h, w) in enumerate(CAPTION_PNG_HW):
                path = ph.root / "sources" / f"png_{i}_{h}x{w}.png"
                path.parent.mkdir(exist_ok=True)
                write_png(path, synthetic_sources(rs, 1, max(h, w))[0][:h, :w])
                srcs.append(str(path))
            srcs += [str(fixtures / f"{name}.jpg") for name in CAPTION_JPEGS]

            # ---- cli prep-captions: the captioner and VQA load, caption and answer
            wload.REPORTS.clear()
            cap_json = ph.root / "captions" / "planes_captions.json"
            argv = ["prep-captions", "--dataset", "planes", "--images", *srcs, "--output", str(cap_json),
                    "--questions", *CAPTION_QUESTIONS, "--weights_dir", str(wd)]
            caps, out["prep_captions_s"] = timed(lambda: cli.main(argv))
            reports = list(wload.REPORTS)
            written = json.loads(cap_json.read_text())
            require(written == caps and list(written) == srcs, "captions JSON keys", list(written))
            require(all(set(e) == {"caption", *CAPTION_QUESTIONS} and all(isinstance(v, str) for v in e.values())
                        for e in written.values()), "captions JSON schema", written)
            cap, vqa = made["_default_captioner"], made["_default_vqa"]
            require(cap.tokenizer.has_vocab and cap.device.type == "cuda" and vqa.device.type == "cuda",
                    "the captioner's vocab and device", cap.device, vqa.device)
            out["captions"] = {Path(p).name: e for p, e in written.items()}

            # ---- throughput, warm: captions/s, answers/s, s a decode step from the
            # CUDA graph and launched eagerly (the same ids)
            _, t_cap = timed(lambda: [cap(p) for p in srcs])
            _, t_vqa = timed(lambda: [vqa.answer_questions(p, list(CAPTION_QUESTIONS)) for p in srcs])
            images = bc.blip_preprocess(read_rgb(srcs[0])[None], 384, "cuda")
            prompt = cap.prompt_ids()
            steps = cap.max_len - len(prompt)
            with torch.no_grad():
                _, t_vit = timed(lambda: cap.model.encode_image(images))
            ids_graph, t_graph = timed(lambda: bc.greedy_caption_ids(cap.model, images, prompt, cap.max_len))
            graphs.ENABLED = False
            try:
                ids_eager, t_eager = timed(lambda: bc.greedy_caption_ids(cap.model, images, prompt, cap.max_len))
            finally:
                graphs.ENABLED = True
            require(torch.equal(ids_graph, ids_eager), "caption ids: CUDA graph vs eager", ids_graph, ids_eager)
            out.update({"sources": len(srcs), "captions_per_s": len(srcs) / t_cap,
                        "answers_per_s": len(srcs) * len(CAPTION_QUESTIONS) / t_vqa, "caption_vit_s": t_vit,
                        "caption_s_per_decode_step": (t_graph - t_vit) / steps,
                        "caption_s_per_decode_step_eager": (t_eager - t_vit) / steps})

            # ---- card against the port's CPU f32 on 2 sources (a PNG and a JPEG), one
            # batch each model; the card decodes through the graphed functions
            raw = [read_rgb(p)[None] for p in (srcs[0], srcs[len(CAPTION_PNG_HW)])]
            qs = list(CAPTION_QUESTIONS)
            cap_cpu, out["cpu_load_caption_s"] = timed(lambda: bc.TorchBlipCaptioner(weights_dir=str(wd),
                                                                                       device="cpu"))
            n0, first, held = len(prompt), {}, {}
            with torch.no_grad():
                for tool, dev in ((cap, "cuda"), (cap_cpu, "cpu")):
                    x = torch.cat([bc.blip_preprocess(r, 384, dev) for r in raw])
                    tokens = tool.model.encode_image(x)
                    ids = torch.full((len(raw), tool.max_len), bc.PAD_ID, dtype=torch.long, device=dev)
                    ids[:, :n0] = torch.tensor(prompt, device=dev)
                    first[dev] = tool.model.text_decoder(ids, tokens)[:, n0 - 1]
                    if dev == "cuda":
                        card_ids = bc.greedy_caption_ids(tool.model, x, prompt, tool.max_len)
                    else:
                        dec = tool.model.text_decoder
                        cpu_ids, cpu_margins = bc.greedy_decode(lambda t: dec.decoder_hidden(t, tokens), dec.head,
                                                                ids, n0, return_margins=True)
            held["caption"] = {"first_step_rel_err": rel_err(first["cuda"], first["cpu"]),
                               **ids_agree(card_ids, cpu_ids, cpu_margins, n0)}
            del cap_cpu
            vqa_cpu, out["cpu_load_vqa_s"] = timed(lambda: bv.TorchBlipVQA(weights_dir=str(wd), device="cpu"))
            with torch.no_grad():
                for tool, dev in ((vqa, "cuda"), (vqa_cpu, "cpu")):
                    x = torch.cat([bc.blip_preprocess(r, bv.VQA_IMAGE_SIZE, dev) for r in raw])
                    qids, qmask = tool.tokenize_questions(qs * len(raw))
                    tokens = tool.model.encode_image(x).repeat_interleave(len(qs), dim=0)  # image i, question j
                    states = tool.model.encode_question(qids, tokens, qmask)
                    a0 = torch.full((len(qids), bv.MAX_ANSWER_LEN), bc.PAD_ID, dtype=torch.long, device=dev)
                    a0[:, 0] = bc.BOS_ID
                    first[dev] = tool.model.text_decoder(a0, states, qmask)[:, 0]
                    if dev == "cuda":
                        card_ids = bv.greedy_answer_ids_from_states(tool.model, states, qmask)
                    else:
                        cpu_ids, cpu_margins = bv.greedy_answer_ids_from_states(tool.model, states, qmask,
                                                                                return_margins=True)
            held["vqa"] = {"first_step_rel_err": rel_err(first["cuda"], first["cpu"]),
                           **ids_agree(card_ids, cpu_ids, cpu_margins, 1)}
            del vqa_cpu
            out["card_vs_cpu"] = held

            # ---- cli prep-prompts: the keytotext T5 samples 16 sentences a class
            wload.REPORTS.clear()
            argv = ["prep-prompts", "--dataset", "planes", "--num", str(PROMPTS_NUM), "--output_path",
                    str(ph.root / "prompts"), "--weights_dir", str(wd)]
            path, out["prep_prompts_s"] = timed(lambda: cli.main(argv))
            reports += list(wload.REPORTS)
            pool = json.loads(Path(path).read_text())
            classes = caption_tools.DATASET_TO_LABEL_DICT["planes"]
            require(Path(path).name == f"LE_{PROMPTS_NUM}_planes_all_classes_False.json" and
                    list(pool) == list(dict.fromkeys(classes)) and
                    all(isinstance(v, list) and all(isinstance(s, str) for s in v) for v in pool.values()),
                    "LE JSON schema", path, pool)
            t5 = made["_default_sentence_generator"]
            t5_load_s = wload.REPORTS[-1]["seconds"]
            n_sentences = PROMPTS_NUM * len(classes)
            ids, mask = t5.encode_batch(["airplane"])
            with torch.no_grad():
                _, t_enc = timed(lambda: t5.model.encode(ids, mask))
            t5m.t5_generate_ids(t5.model, ids, mask, t5.max_new_tokens)  # records the greedy loop's graph
            greedy_graph, t_graph = timed(lambda: t5m.t5_generate_ids(t5.model, ids, mask, t5.max_new_tokens))
            graphs.ENABLED = False
            try:
                greedy_eager, t_eager = timed(lambda: t5m.t5_generate_ids(t5.model, ids, mask, t5.max_new_tokens))
            finally:
                graphs.ENABLED = True
            require(torch.equal(greedy_graph, greedy_eager), "T5 ids: CUDA graph vs eager", greedy_graph, greedy_eager)
            _, t_noise = timed(lambda: t5m.sampling_noise(rngs.prng_key(0), 1, t5.max_new_tokens,
                                                          t5.cfg.vocab_size))
            out.update({"sentences": n_sentences, "sentences_kept": sum(len(v) for v in pool.values()),
                        "sentences_per_s": n_sentences / (out["prep_prompts_s"] - t5_load_s),
                        "t5_s_per_decode_step": (t_graph - t_enc) / t5.max_new_tokens,
                        "t5_s_per_decode_step_eager": (t_eager - t_enc) / t5.max_new_tokens,
                        "t5_host_noise_s_per_call": t_noise,
                        "tokenizer": "sentencepiece" if t5.tokenizer.has_vocab else "hash-fallback"})
            t5_cpu, out["cpu_load_t5_s"] = timed(lambda: t5m.TorchKeytotextT5(weights_dir=str(wd), device="cpu"))
            key = rngs.split(rngs.prng_key(seed + 803))[1]
            texts = ["airplane", "jet"]
            with torch.no_grad():
                logits = []
                for tool in (t5, t5_cpu):
                    tids, tmask = tool.encode_batch(texts)
                    enc = tool.model.encode(tids, tmask)
                    d0 = torch.zeros((len(texts), 1 + tool.max_new_tokens), dtype=torch.long, device=tids.device)
                    logits.append(tool.model.lm_logits(tool.model.decoder_hidden(d0, enc, tmask)[:, 0]))
                tids, tmask = t5.encode_batch(texts)
                card_ids = t5m.t5_generate_ids(t5.model, tids, tmask, t5.max_new_tokens, key=key)
                tids, tmask = t5_cpu.encode_batch(texts)
                cpu_ids, cpu_margins = t5m.t5_generate_ids(t5_cpu.model, tids, tmask, t5.max_new_tokens, key=key,
                                                           return_margins=True)
            held["t5"] = {"prompts": texts, "first_step_rel_err": rel_err(*logits),
                          **ids_agree(card_ids, cpu_ids, cpu_margins, 1)}
            del t5_cpu
            counts = read_counts()
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            for r in held.values():
                # f32 on the card (TF32 off) against f32 on the CPU, 12-24 layers deep
                require(r["first_step_rel_err"] <= 1e-4, "captions: first-step logits card vs CPU", r)
                require(r["equal"], "captions: ids card vs CPU before the first low-margin step", r)
            out["load"] = [{**row, "gb_per_s": row["bytes"] / row["seconds"] / 1e9}
                           for row in check_load_reports(reports, file_sums, "captions")]
            require(sorted(r["model"] for r in reports) == ["blip_caption", "blip_vqa", "t5"], "captions loads",
                    [r["model"] for r in reports])
            require(all(v == 0 for v in counts.values()), "captions: the prompt tools launched a kernel", counts)
            out.update({"launches": counts, "models_params": {
                "blip_caption": sum(p.numel() for p in cap.model.parameters()),
                "blip_vqa": sum(p.numel() for p in vqa.model.parameters()),
                "t5": sum(p.numel() for p in t5.model.parameters())}})
            emit(out)
    finally:
        for name, fn in factories.items():
            setattr(caption_tools, name, fn)
        wload.REPORT_SUMS = False
        made.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return {"captions": counts}


BACKBONE_NETS = ("inception_mixed_6e", "inception_mixed_7c", "resnet50_cbam")
BACKBONE_TIMED_STEPS = 10
BACKBONE_PROFILED_STEPS = 2
BACKBONE_AUGS = 2  # seeded 256^2 PNG augs for each of the filter's first 8 train images
CLIP_VITB16_IMAGES = 4


def inception_cal_state_dict(net: str, num_classes: int, m: int, fill) -> dict:
    """The reference's WSDAN-CAL state_dict of an Inception net: torchvision's
    Inception layout (tools/synth_checkpoints.py) under the index names of
    get_features_mixed_6e/7c's Sequential (weights/convert.py
    INCEPTION_SEQUENTIAL), the BasicConv2d attention head (which a mixed_7c
    file holds and its forward never uses) and the bias-free fc."""
    from saspa_tpu_torch.models.cal import cal_num_features
    from saspa_tpu_torch.weights.convert import INCEPTION_SEQUENTIAL
    from tools import synth_checkpoints as synth

    index = {name: i for i, name in enumerate(INCEPTION_SEQUENTIAL) if name}
    last = index["Mixed_6e" if net == "inception_mixed_6e" else "Mixed_7c"]
    sd = synth._SD(fill)
    for k, v in synth.torchvision_inception_state_dict(fill=fill, with_aux=False).items():
        block, rest = k.split(".", 1)
        if block in index and index[block] <= last:  # not torchvision's fc
            sd[f"features.{index[block]}.{rest}"] = v
    sd.conv("attentions.conv", m, cal_num_features(net), 1, bias=False)
    sd.bn("attentions.bn", m)
    sd.linear("fc", num_classes, m * cal_num_features(net), bias=False)
    return dict(sd)


def write_cal_pth(path, sd: dict, center) -> None:
    from pathlib import Path

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"logs": {"epoch": 80, "val_topk_accuracy": [0.9]},
                "state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "feature_center": torch.from_numpy(center)}, path)


def backbone_step_times(net: str, b: int, aug_json, seed: int, profile: bool = False) -> dict:
    """s/step of one net's train step fed by the input pipeline (the planes
    recipe at batch b, bf16 over f32 masters): 3 warm-up steps, then
    BACKBONE_TIMED_STEPS timed; peak memory above what the state holds; with
    profile, BACKBONE_PROFILED_STEPS more under torch.profiler (idle share)."""
    from saspa_tpu_torch.data import datasets as tds
    from saspa_tpu_torch.data.pipeline import InputPipeline
    from saspa_tpu_torch.fgvc import train as ttrain
    from saspa_tpu_torch.utils import rng as rngs
    from saspa_tpu_torch.utils.config import get_train_config

    cfg = get_train_config("planes", batch_size=b, net=net)
    state = ttrain.create_train_state(cfg, TRAIN_CLASSES, device="cuda", init_seed=seed)
    ds = tds.get_datasets("planes", aug_json=str(aug_json), aug_sample_ratio=0.4, limit_aug_per_image=2,
                          special_aug="classic", seed=1, print_func=lambda *a: None)[0]
    pipe = InputPipeline(ds, b, resize=cfg.image_size, train_transform="classic", seed=1,
                         num_threads=cfg.workers * 2, device="cuda")
    step = ttrain.make_train_step(cfg, len(pipe))

    def batches():
        e = 0
        while True:
            yield from pipe.iter_train(e)
            e += 1

    it = batches()

    def run_steps(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            X, y, _ = next(it)
            met = step(state, X, y, rngs.item_key(1, "dropout", 9, i))
        torch.cuda.synchronize()
        require(math.isfinite(met["loss"].item()), "backbones:", net, "a non-finite loss")
        return None, time.perf_counter() - t0

    run_steps(3)  # warm-up: cuDNN's heuristics, the allocator
    held = sum(t.numel() * t.element_size() for t in (*state.model.parameters(), *state.model.buffers(),
                                                      *state.momentum.values(), state.feature_center))
    base = torch.cuda.memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    _, wall = run_steps(BACKBONE_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    row = {"net": net, "batch": b, "steps": BACKBONE_TIMED_STEPS, "wall_s": wall,
           "s_per_step": wall / BACKBONE_TIMED_STEPS, "img_per_s": b * BACKBONE_TIMED_STEPS / wall,
           "peak_mem_bytes": peak, "peak_mem_above_base_bytes": peak - base, "state_bytes": held,
           "parameters": sum(p.numel() for p in state.model.parameters())}
    if profile:
        prof = profile_run(lambda: run_steps(BACKBONE_PROFILED_STEPS))
        row.update({"profiled_steps": BACKBONE_PROFILED_STEPS, "profiled_wall_s": prof["wall_s"],
                    "device_busy_s": prof["device_busy_s"], "idle_share": prof["idle_share"],
                    "kernels_per_step": sum(r["calls"] for r in prof["kernels"]) / BACKBONE_PROFILED_STEPS,
                    "groups_ms": prof["groups_ms"]})
    del state, it, pipe
    torch.cuda.empty_cache()
    return row


def run_backbones_phase(seed: int, smi: str) -> dict:
    """The Inception-v3 and CBAM backbones of WS-DAN/CAL and CLIP ViT-B/16
    (module docstring, phase 21); returns the phase's launch counts, which
    must be 0."""
    import importlib.util
    import os
    from pathlib import Path

    from saspa_tpu_torch import cli
    from saspa_tpu_torch.filters.clip_filters import CLIPScorer, clip_preprocess_path
    from saspa_tpu_torch.gen.image_io import write_png
    from saspa_tpu_torch.models.cal import cal_num_features
    from saspa_tpu_torch.utils.config import get_train_config
    from saspa_tpu_torch.weights import load as wload

    t_phase = time.perf_counter()
    with PhaseRoot("saspa_backbones_") as pr:
        root = pr.root
        t = time.perf_counter()
        aug_json = write_train_tree(root, seed + 701)
        tree_s = time.perf_counter() - t
        recipe = ["--dataset", "planes", "--aug_json", str(aug_json), "--aug_sample_ratio", "0.4",
                  "--limit_aug_per_image", "2", "--special_aug", "classic", "--epochs", "1", "--seed", "1"]
        reset_counts()

        # ---- cli train --net inception_mixed_6e: the planes recipe, one epoch (16 steps), validation, checkpoint;
        # --plot_per_class_acc too where matplotlib is installed
        has_mpl = importlib.util.find_spec("matplotlib") is not None
        argv = ["train", *recipe, "--net", "inception_mixed_6e", "--logdir", str(root / "logs_6e")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        logs = cli.main(argv + (["--plot_per_class_acc"] if has_mpl else []))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        lines = [json.loads(ln) for ln in (Path(logs["save_dir"]) / "metrics.jsonl").read_text().splitlines()]
        epoch = lines[0]
        val = next(ln for ln in lines if "val_loss" in ln)
        test = next(ln for ln in lines if "test_loss" in ln)
        require(epoch["steps"] == TRAIN_SPLITS["train"] // 4 and math.isfinite(epoch["train_loss"]),
                "backbones: the 6e epoch's metrics", epoch)
        require(math.isfinite(val["val_loss"]) and math.isfinite(test["test_loss"]), "backbones: 6e eval", lines)
        require(Path(logs["ckpt_path"]).is_file(), "backbones: no 6e checkpoint at", logs["ckpt_path"])
        if has_mpl:
            plots = sorted(str(p.relative_to(logs["save_dir"])) for p in Path(logs["save_dir"]).glob("plots/*/*.png"))
            require(plots == [f"plots/{t}/num_samples_per_class_vs_class_accuracy_epoch_0.png" for t in ("test", "val")],
                    "backbones: the per-class accuracy plots", plots)
            plot = {"matplotlib": True, "pngs": plots}
        else:  # the card's machine: the flag must fail before the first step, naming matplotlib
            try:
                cli.main(argv[:-1] + [str(root / "logs_plot"), "--plot_per_class_acc"])
                plot_error = None
            except ImportError as e:
                plot_error = str(e)
            require(plot_error is not None and "matplotlib" in plot_error and not list(root.glob("*logs_plot*")),
                    "backbones: --plot_per_class_acc without matplotlib did not fail before its first step",
                    plot_error)
            plot = {"matplotlib": False, "error": plot_error}
        run_6e = {"argv": argv, "wall_s": wall, "steps": epoch["steps"], "epoch": epoch, "val": val, "test": test,
                  "peak_mem_bytes": peak, "plot": plot}

        # ---- --ckpt: seeded reference-layout .pth files of 6e and 7c, 2 steps each; resnet50_cbam, 2 steps
        fill = NormalFill(seed + 702)
        files, restores = {}, {}
        for net in ("inception_mixed_6e", "inception_mixed_7c"):
            sd = inception_cal_state_dict(net, TRAIN_CLASSES, 32, fill)
            center = fill.randn(TRAIN_CLASSES, 32 * cal_num_features(net)) * np.float32(0.02)
            files[net] = (root / "pth" / net / "model_bestacc.pth", sd)
            write_cal_pth(files[net][0], sd, center)
        short = ["--train_sample_ratio", "0.125"]  # 8 of the 64 train images: 2 steps at batch 4
        short_runs = {}
        for net, ckpt in (("inception_mixed_6e", files["inception_mixed_6e"][0]),
                          ("inception_mixed_7c", files["inception_mixed_7c"][0]), ("resnet50_cbam", None)):
            argv_n = ["train", *recipe, *short, "--net", net, "--logdir", str(root / f"logs_{net}")]
            argv_n += ["--ckpt", str(ckpt)] if ckpt else []
            t = time.perf_counter()
            logs_n = cli.main(argv_n)
            torch.cuda.synchronize()
            wall_n = time.perf_counter() - t
            ep = json.loads((Path(logs_n["save_dir"]) / "metrics.jsonl").read_text().splitlines()[0])
            require(ep["steps"] == 2 and math.isfinite(ep["train_loss"]), "backbones:", net, "steps", ep)
            short_runs[net] = {"argv": argv_n, "wall_s": wall_n, "epoch": ep}
            if ckpt:
                sd = files[net][1]
                r = logs_n["restored"]
                dropped = sorted(k for k in sd if k.startswith("attentions.")) if net == "inception_mixed_7c" else []
                nbt = sum(1 for k in sd if "num_batches_tracked" in k)
                require(r is not None and r["skipped"] == [] and r["missing"] == [] and r["feature_center"]
                        and r["pth"]["skipped"] == dropped and len(dropped) in (0, 6)
                        and r["pth"]["read"] == len(sd) - nbt - sum(1 for k in dropped if "num_batches" not in k),
                        "backbones: --ckpt did not restore every key", net, r)
                restores[net] = {"file_keys": r["pth"]["file_keys"], "read": r["pth"]["read"],
                                 "skipped": r["pth"]["skipped"], "num_batches_tracked": nbt,
                                 "restored_params": len(torch.load(logs_n["ckpt_path"], weights_only=True)["params"])}

        # ---- cli filter with the 6e file as the planes baseline (--weights_dir), the confidence and ALIA
        # filters, on a planes train split of 100 images in the file's 100 variants
        tree = root / "weights"
        (tree / "checkpoints" / "planes").mkdir(parents=True)
        os.link(files["inception_mixed_6e"][0], tree / "checkpoints" / "planes" / "model_bestacc.pth")
        write_wide_planes_tree(root / "wide", root, [], TRAIN_CLASSES, seed + 703)
        os.environ["SASPA_DATA_ROOT"] = str(root / "wide")
        aug_dir = root / "filter_augs" / "images"  # the filter reads a folder's images/
        aug_dir.mkdir(parents=True)
        rng = np.random.RandomState(seed + 704)
        train_ids = (root / "wide/FGVC-Aircraft/fgvc-aircraft-2013b/data/images_train.txt").read_text().split()[:8]
        for i in train_ids:
            for j in range(BACKBONE_AUGS):
                write_png(aug_dir / f"{i}_prompt_synthetic_{j}.png", synthetic_sources(rng, 1, 256)[0])
        argv_f = ["filter", "--dataset", "planes", "--aug_folder", str(aug_dir), "--weights_dir", str(tree),
                  "--alia_conf_filtering"]
        wload.REPORTS.clear()
        t = time.perf_counter()
        json_path = cli.main(argv_f)
        torch.cuda.synchronize()
        filter_wall = time.perf_counter() - t
        os.environ["SASPA_DATA_ROOT"] = str(root)
        cal_reports = [r for r in wload.REPORTS if r["kind"] == "cal"]
        require(len(cal_reports) >= 1 and all(r["unconsumed"] == 0 and r["skipped"] == [] and
                                              r["params"] == r["module_params"] for r in cal_reports),
                "backbones: filter's baseline load", cal_reports)
        kept = json.loads(Path(json_path).read_text())
        thresholds = sorted(Path(root).glob("alia_confidence_thresholds/*"))
        filter_row = {"argv": argv_f, "wall_s": filter_wall, "augs": len(train_ids) * BACKBONE_AUGS,
                      "kept": sum(len(v) for v in kept.values()), "cal_loads": len(cal_reports),
                      "cal_report": {k: cal_reports[0][k] for k in ("file_keys", "params", "elements", "skipped")},
                      "alia_threshold_files": [p.name for p in thresholds]}

        counts = read_counts()
        require(all(v == 0 for v in counts.values()), "backbones: the train and filter runs launched K1-K6", counts)
        emit({"phase": "backbones", "tree_s": tree_s, "train_6e": run_6e, "short_runs": short_runs,
              "ckpt_restores": restores, "filter": filter_row, "launches": counts})

        # ---- s/step: 6e at batch 4 (profiled) and 16 (cub's recipe), 7c and resnet50_cbam at batch 4
        rows = []
        for net, b in (("inception_mixed_6e", 4), ("inception_mixed_6e", 16), ("inception_mixed_7c", 4),
                       ("resnet50_cbam", 4)):
            rows.append(backbone_step_times(net, b, aug_json, seed + 705, profile=(net, b) == ("inception_mixed_6e", 4)))
            emit({"phase": "backbones_throughput", **rows[-1], "nvidia_smi": smi})

        # ---- one f32 step of each net, card against the port on the CPU (the train phase's f32 bounds), and
        # one f64 step of the Inception nets (its f64 bounds): the f32 gaps are rounding
        cfg = get_train_config("planes")
        cmp = {"f32": {}, "f64": {}}
        t = time.perf_counter()
        for net in BACKBONE_NETS:
            cmp["f32"][net] = card_vs_cpu(cfg.replace(net=net), torch.float32, cfg.learning_rate, seed + 706, steps=1)
        for net in BACKBONE_NETS[:2]:
            cmp["f64"][net] = card_vs_cpu(cfg.replace(net=net), torch.float64, cfg.learning_rate, seed + 706, steps=1)
        emit({"phase": "backbones_card_vs_cpu", "cpu_threads": torch.get_num_threads(),
              "seconds": time.perf_counter() - t, **cmp})
        for net, rs in cmp["f32"].items():
            for r in rs:
                require(r["loss_rel"] <= 1e-2 and r["feature_center_cos"] >= 0.99 and r["fc_update_cos"] >= 0.98
                        and r["running_stats_rel"] <= 0.1, "backbones: the card's f32 step differs from the CPU's",
                        net, r)
        for net, rs in cmp["f64"].items():
            for r in rs:
                require(r["loss_rel"] <= 1e-6 and r["running_stats_rel"] <= 1e-4 and r["feature_center_cos"] >= 0.9999
                        and r["fc_update_cos"] >= 0.9999, "backbones: the card's f64 step differs from the CPU's",
                        net, r)

        # ---- CLIP ViT-B/16: seeded, card (bf16) against the CPU (f32) on the same weights
        paths = []
        rng = np.random.RandomState(seed + 707)
        for i, hw in enumerate(((300, 400), (224, 224), (512, 384), (260, 260))[:CLIP_VITB16_IMAGES]):
            paths.append(str(root / f"clip_{i}.png"))
            write_png(paths[-1], synthetic_sources(rng, 1, hw[0], hw[1])[0])
        prompts = ["a photo of a 737-800, a type of aircraft.", "a photo of an A320, a type of aircraft.",
                   "a photo of an object", "an image"]
        t = time.perf_counter()
        card = CLIPScorer("vit-b-16", seed=seed + 708)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        cpu = CLIPScorer("vit-b-16", device="cpu", seed=seed + 708)
        cpu.model.load_state_dict({k: v.float().cpu() for k, v in card.model.state_dict().items()})
        (f_card, _), card_s = timed(lambda: (card.image_features(paths, batch_size=CLIP_VITB16_IMAGES), None))
        f_cpu = cpu.image_features(paths, batch_size=CLIP_VITB16_IMAGES)
        t_card, t_cpu = card.text_features(prompts), cpu.text_features(prompts)
        img_cos = row_cosines(torch.from_numpy(f_card), torch.from_numpy(f_cpu)).tolist()
        txt_cos = row_cosines(torch.from_numpy(t_card), torch.from_numpy(t_cpu)).tolist()
        x = torch.from_numpy(np.stack([clip_preprocess_path(p) for p in paths])).permute(0, 3, 1, 2)
        enc_ms = cuda_ms(lambda: card.model.encode_image(x.to("cuda", torch.bfloat16)), iters=10)
        emit({"phase": "backbones_clip_vitb16", "images": len(paths), "init_s": init_s, "image_features_s": card_s,
              "encode_image_ms": enc_ms, "image_cosines": img_cos, "text_cosines": txt_cos,
              "parameters": sum(p.numel() for p in card.model.parameters()),
              "logits_card": card.logits(f_card, t_card).tolist(), "logits_cpu": cpu.logits(f_cpu, t_cpu).tolist()})
        require(f_card.shape == (len(paths), 512) and min(img_cos) >= 0.99 and min(txt_cos) >= 0.99,
                "backbones: CLIP ViT-B/16 card vs CPU", img_cos, txt_cos)
        del card, cpu
        torch.cuda.empty_cache()
    emit({"phase": "backbones_summary", "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi,
          "s_per_step": {f"{r['net']}_b{r['batch']}": r["s_per_step"] for r in rows},
          "peak_mem_bytes": {f"{r['net']}_b{r['batch']}": r["peak_mem_bytes"] for r in rows},
          "idle_share_6e_b4": rows[0].get("idle_share")})
    require(all(v == 0 for v in read_counts().values()), "backbones: the phase launched K1-K6", read_counts())
    return read_counts()


def train_profile_path(profile):
    from pathlib import Path

    return str(Path(profile).with_name(f"{Path(profile).stem}_train{Path(profile).suffix}")) if profile else None


def copy_weights(src, dst) -> None:
    """Loads src pipeline's parameters into dst (any device and dtype)."""
    for k, mod in src.params.items():
        mods = mod if isinstance(mod, list) else [mod]
        dmods = dst.params[k] if isinstance(mod, list) else [dst.params[k]]
        for m, dm in zip(mods, dmods):
            dtypes = {n: t.dtype for n, t in dm.state_dict().items()}
            dm.load_state_dict({n: t.to(device=dst.device, dtype=dtypes[n]) for n, t in m.state_dict().items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4, help="DDIM steps of the main path (the recipe uses 30)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="OUT.json",
                    help="also profile one main-path run of each configuration: OUT.json, OUT_opt_in.json")
    ap.add_argument("--parent", metavar="DIR",
                    help="also time another checkout's K3 and K5 wrappers and kernels beside these (parent_* keys)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the card", file=sys.stderr)
        return 2
    if args.steps < 2:
        ap.error("--steps must be at least 2")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
    from saspa_tpu_torch.gen.tokenizer import NEGATIVE_PROMPT
    from saspa_tpu_torch.models.controlnet import ZERO_INIT_PREFIXES
    from saspa_tpu_torch.ops import _build
    from saspa_tpu_torch.ops.canny import canny_batch

    global SM_CLOCK_HZ
    smi = nvidia_smi_line()
    SM_CLOCK_HZ = float(nvidia_smi_line("clocks.max.sm", units=False)) * 1e6
    build_s = _build.build_all()
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "registers" in ln or "spill" in ln]
             for k, v in _build.build_log.items()}
    k6 = k6_ptxas(_build.build_log.get("flash_attention", ""))
    emit({"phase": "build", "seconds": build_s, "nvidia_smi": smi, "sm_clock_max_hz": SM_CLOCK_HZ, "ptxas": ptxas,
          "k1_wgmma": k1_ptxas(_build.build_log.get("attention_packed", "")),
          "k2_wgmma": k2_ptxas(_build.build_log.get("ln_geglu", "")),
          "k5_wgmma": k5_ptxas(_build.build_log.get("attention_block", "")),
          "k3": k3_ptxas(_build.build_log.get("group_norm", "")), "k6_wgmma": k6,
          "k1_f32": k1_f32_ptxas(_build.build_log.get("attention_packed_f32", ""))})
    require(sorted(k6) == K6_INSTANCES, "K6 instantiations in the ptxas report", sorted(k6))
    require(all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 for r in k6.values()),
            "K6 kernels spill", k6)
    if args.parent:
        emit({"phase": "parent_build", "dir": args.parent, "seconds": load_parent(args.parent)})

    # ---- the pipelines of both configurations, one set of seeded weights ---
    t0 = time.perf_counter()
    pipes = {"default": DiffusionPipeline("sd_v1.5", controlnet="canny", sampler="ddim", dtype=torch.bfloat16,
                                          init_seed=args.seed)}
    with torch.no_grad():  # small seeded values so the ControlNet residuals are not all zero
        zgen = torch.Generator(device="cuda").manual_seed(args.seed + 11)
        for name, p in sorted(pipes["default"].params["controlnet"].named_parameters()):
            if name.startswith(ZERO_INIT_PREFIXES):
                p.copy_(torch.randn(p.shape, generator=zgen, device="cuda") * 0.02)
    pipes["opt_in"] = DiffusionPipeline("sd_v1.5", controlnet="canny", sampler="ddim", dtype=torch.bfloat16,
                                        init_seed=None, **CONFIGS["opt_in"])
    copy_weights(pipes["default"], pipes["opt_in"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(args.seed)
    b, size = 8, 512
    src = synthetic_sources(rng, b, size)
    prompts = [f"a photo of a {c} airliner on the runway" for c in ("red", "white", "blue", "grey") * 2]
    ids = pipes["default"].tokenizer(prompts, pad="eot")
    neg_ids = pipes["default"].tokenizer([NEGATIVE_PROMPT] * b, pad="eot")
    latents = rng.randn(b, size // 8, size // 8, 4).astype(np.float32)

    def run(config, steps):
        pipe = pipes[config]
        fn = pipe.make_fused_generate(size, size, steps, 7.5, 0.75, 120.0, 200.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(pipe.params, ids, neg_ids, src, latents, return_images=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # warm-up (cuDNN/cuBLAS heuristics, kernel library loads), recording the
    # norm and self-attention shapes of the main path
    sites, handles = record_sites(pipes["default"])
    run("default", 1)
    for h in handles:
        h.remove()
    # the gen path's norm shapes: one hooked step of the same pipeline at
    # 1024^2 (K1, K2 and K6 list theirs above; K5 is not on that path)
    sites_gen, handles = record_sites(pipes["default"])
    big = synthetic_sources(np.random.RandomState(args.seed + 202), b, GEN_RESOLUTION)
    big_lat = np.random.RandomState(args.seed + 203).randn(b, GEN_RESOLUTION // 8, GEN_RESOLUTION // 8, 4)
    pipes["default"].make_fused_generate(GEN_RESOLUTION, GEN_RESOLUTION, 1, 7.5, 0.75, 120.0, 200.0)(
        pipes["default"].params, ids, neg_ids, big, big_lat.astype(np.float32), return_images=True)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    del big, big_lat
    torch.cuda.empty_cache()
    for key in ("group_norm", "layernorm"):
        sites[key] |= sites_gen[key]
    # the VAE decoder's GroupNorm at B8 C256 1024^2 holds exactly 2^31 elements
    require(any(math.prod(st[:4]) >= 2 ** 31 for st in sites["group_norm"]),
            "no 2^31-element GroupNorm among the recorded sites", sorted(sites["group_norm"], key=str))

    # ---- kernels against their plain versions --------------------------------
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    checks = {}
    for name, check, arg in (("attention_packed", check_k1, None), ("flash_attention", check_k6, None),
                             ("ln_geglu", check_k2, None),
                             ("group_norm", check_k3, "group_norm"), ("layernorm", check_k4, "layernorm"),
                             ("attention_block", check_k5, "attention_block")):
        checks[name] = check(gen) if arg is None else check(gen, sites[arg])
        emit({"phase": "kernels", "kernel": name, "shapes": checks[name]})

    # ---- main path, each configuration ---------------------------------------
    counts = {}
    for config in CONFIGS:
        if config != "default":
            run(config, 1)  # warm-up
        _, t1 = run(config, 1)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (u8, images), ts = run(config, args.steps)
        counts[config] = read_counts()
        peak = torch.cuda.max_memory_allocated()
        require(u8.shape == (b, size, size, 3) and u8.dtype == torch.uint8, "output", tuple(u8.shape), u8.dtype)
        require(bool(torch.isfinite(images).all()), config, "non-finite images before quantisation")
        want = expected_counts(args.steps, config)
        require(counts[config] == want, config, "launch counts", counts[config], "expected", want)
        s_step = (ts - t1) / (args.steps - 1)
        emit({"phase": "main", "config": config, "batch": b, "resolution": size, "steps": args.steps,
              "init_s": init_s, "wall_s": ts, "wall_1step_s": t1, "s_per_step": s_step, "img_per_s": b / ts,
              "img_per_s_30_steps_est": b / (t1 + 29 * s_step), "peak_mem_bytes": peak,
              "launches": counts[config], "launches_expected": want, "uint8_mean": u8.float().mean().item()})
        del u8, images

    # ---- the main path's batch on UniPC: DDIM's launches, fused == generate ----
    counts["unipc"] = run_unipc_phase(pipes["default"], src, ids, neg_ids, latents, args.steps)

    if args.profile:
        from pathlib import Path

        out = Path(args.profile)
        for config in CONFIGS:
            path = out if config == "default" else out.with_name(f"{out.stem}_{config}{out.suffix}")
            profile_main(lambda: run(config, args.steps), str(path), args.steps, config)

    # ---- reference: small input against the plain path on the CPU ----------
    rs, n_small = 256, 1  # 32^2 latents: K1/K5 at 1024 and 256 tokens, K2/K4 on a ragged 32-row mid block
    small = (src[:n_small, ::2, ::2], ids[:n_small], neg_ids[:n_small], latents[:n_small, ::2, ::2])
    edges_gpu = canny_batch(torch.as_tensor(src, device="cuda"), 120.0, 200.0).cpu()
    edges_cpu = canny_batch(torch.as_tensor(src), 120.0, 200.0)
    canny_equal = bool(torch.equal(edges_gpu, edges_cpu))
    # One CPU f32 run of the plain path is the reference of both
    # configurations: in f32 the opt-in plain versions compute the default
    # path's function (the TPU numerics' normalize and the block's plain
    # version round nothing to bf16), up to f32 rounding.
    t = time.perf_counter()
    cpu = DiffusionPipeline("sd_v1.5", controlnet="canny", sampler="ddim", dtype=torch.float32, device="cpu",
                            init_seed=None)
    copy_weights(pipes["default"], cpu)
    t_setup = time.perf_counter()
    _, img_cpu = cpu.make_fused_generate(rs, rs, 2, 7.5)(cpu.params, small[1], small[2], small[0], small[3],
                                                         return_images=True)
    cpu_setup_s, cpu_s = t_setup - t, time.perf_counter() - t_setup
    del cpu
    for config in CONFIGS:
        pipe = pipes[config]
        reset_counts()
        t = time.perf_counter()
        _, img_gpu = pipe.make_fused_generate(rs, rs, 2, 7.5)(pipe.params, small[1], small[2], small[0], small[3],
                                                               return_images=True)
        small_counts = read_counts()
        gpu_s = time.perf_counter() - t
        diff = (img_gpu.float().cpu() - img_cpu).abs()
        # bf16 network with the kernels vs the f32 plain path: agreement to a few
        # uint8 levels on average (mean |diff| <= 0.02 of the [0, 1] range)
        mean_diff, max_diff = diff.mean().item(), diff.max().item()
        emit({"phase": "reference", "config": config, "resolution": rs, "batch": n_small, "steps": 2,
              "launches": small_counts, "mean_abs_diff": mean_diff, "max_abs_diff": max_diff,
              "canny_bit_exact": canny_equal, "edge_fraction": (edges_gpu > 0).float().mean().item(),
              "cpu_setup_s": cpu_setup_s, "gpu_s": gpu_s, "cpu_s": cpu_s,
              "cpu_threads": torch.get_num_threads()})
        ran = [k for k, v in expected_counts(2, config).items() if v > 0]
        require(all(small_counts[k] > 0 for k in ran), config, "reference run missed a kernel", small_counts)
        require(mean_diff <= 0.02, config, "card vs CPU mean |diff|", mean_diff)
        require(canny_equal, "Canny on the card differs from the CPU")

    # ---- the gen entry point at 1024^2 -----------------------------------------
    gen_profile = None
    if args.profile:
        from pathlib import Path

        out = Path(args.profile)
        gen_profile = str(out.with_name(f"{out.stem}_gen_{GEN_RESOLUTION}{out.suffix}"))
    counts[f"gen_{GEN_RESOLUTION}"] = run_gen_phase(args.steps, args.seed, gen_profile)

    # ---- the filter stage: gen without --skip_filter, filter, merge-jsons ----
    filter_profile = None
    if args.profile:
        from pathlib import Path

        out = Path(args.profile)
        filter_profile = str(out.with_name(f"{out.stem}_filter{out.suffix}"))
    counts[f"filter_gen_{FILTER_RESOLUTION}"] = run_filter_phase(args.steps, args.seed, smi, filter_profile)

    # ---- the train stage: cli train at the planes preset, card vs CPU, throughput ----
    counts["train"] = run_train_phase(args.seed, smi, train_profile_path(args.profile))

    # ---- BLIP-Diffusion: cli gen --dataset dtd, every dataset's default but planes' ----
    blip_profile = None
    if args.profile:
        from pathlib import Path

        out = Path(args.profile)
        blip_profile = str(out.with_name(f"{out.stem}_blip{out.suffix}"))
    counts["blip"] = run_blip_phase(args.seed, blip_profile)

    # ---- the paper's best train recipes: dtd classic-cutmix, compcars-parts randaug-cutmix ----
    counts["train_recipes"] = run_train_recipes_phase(args.seed, smi)

    # ---- SDXL-Turbo: cli gen --dataset cub; sd_xl under CFG; the XL kernel sites ----
    pipes.clear()  # the main path's two SD1.5 pipelines
    torch.cuda.empty_cache()
    xl_profile = None
    if args.profile:
        from pathlib import Path

        out = Path(args.profile)
        xl_profile = str(out.with_name(f"{out.stem}_xl{out.suffix}"))
    counts.update(run_xl_phase(args.seed, checks, sites, xl_profile))

    # ---- the public checkpoint files: cli gen / filter / train --ckpt from a --weights_dir tree ----
    torch.cuda.empty_cache()
    counts["weights"] = run_weights_phase(WEIGHTS_STEPS, args.seed, smi)

    # ---- SDEdit (Real-Guidance, ALIA) and BLIP-Diffusion's inversion edit through cli gen ----
    torch.cuda.empty_cache()
    sdedit_profile = None
    if args.profile:
        from pathlib import Path

        out = Path(args.profile)
        sdedit_profile = str(out.with_name(f"{out.stem}_sdedit{out.suffix}"))
    counts.update(run_sdedit_phase(args.seed, checks, sites, sdedit_profile))

    # ---- the planes_biased path: ip2p through cli gen, filter, train, eval-biased; the soft-CE teacher ----
    torch.cuda.empty_cache()
    counts.update(run_planes_biased_phase(args.seed, checks, sites))

    # ---- JPEG sources without PIL: the fixtures bit-equal to PIL's pixels; gen, filter, train on a JPEG tree ----
    torch.cuda.empty_cache()
    counts["jpeg"] = run_jpeg_phase(args.seed)

    # ---- the SDXL refiner: cli gen --base_model sd_xl --sdedit --controlnet none ----
    torch.cuda.empty_cache()
    counts.update(run_refiner_phase(args.seed, checks, sites))

    # ---- SD2.1 + canny, the HED ControlNet (SD1.5, SDEdit, BLIP-Diffusion), the XL VAE in f32 ----
    torch.cuda.empty_cache()
    counts.update(run_sd21_phase(args.seed, checks))
    counts.update(run_hed_phase(args.seed))
    counts.update(run_xl_vae_f32_phase(args.seed, checks))

    # ---- the prompt and caption tools: cli prep-captions (BLIP, VQA) and prep-prompts (keytotext T5) ----
    torch.cuda.empty_cache()
    counts.update(run_captions_phase(args.seed))

    # ---- the Inception-v3 and CBAM backbones through cli train, --ckpt, filter; CLIP ViT-B/16 ----
    torch.cuda.empty_cache()
    counts["backbones"] = run_backbones_phase(args.seed, smi)

    # (name, source, TPU kernel, the check row reported in the line: level 0 after the CFG fork)
    lines = [
        ("attention_packed", "attention_packed.cu", "saspa_tpu/ops/attention.py:181",
         lambda r: r["shape"] == "unet/cn level 0"),
        ("ln_geglu", "ln_geglu.cu", "saspa_tpu/ops/geglu.py:123", lambda r: r["shape"] == "level 0"),
        ("group_norm", "group_norm.cu", "saspa_tpu/ops/groupnorm.py:111",
         lambda r: (r["B"], r["C"], r["HW"], r["act"], r["tpu_numerics"]) == (16, 320, 4096, None, False)),
        ("layernorm", "layernorm.cu", "saspa_tpu/ops/layernorm.py:62", lambda r: (r["rows"], r["C"]) == (65536, 320)),
        ("attention_block", "attention_block.cu", "saspa_tpu/ops/attention.py:268",
         lambda r: (r["B"], r["L"]) == (16, 4096)),
        ("flash_attention", "flash_attention.cu", "saspa_tpu/ops/attention.py:80",
         lambda r: r["shape"] == "1024^2 level 0"),
        # the f32 variants: the XL VAE's decode under SASPA_XL_VAE_FP32=1
        ("attention_packed_f32", "attention_packed_f32.cu", "saspa_tpu/ops/attention.py:181",
         lambda r: r["shape"] == "xl vae decoder mid attention, f32"),
        ("group_norm_f32", "group_norm.cu", "saspa_tpu/ops/groupnorm.py:111",
         lambda r: (r["B"], r["C"], r["HW"], r["act"], r["tpu_numerics"]) == (8, 256, 512 * 512, "silu", False)),
    ]
    kernels = []
    for name, source, replaces, pick in lines:
        rows = checks[name]
        row = next(r for r in rows if pick(r))
        kernels.append({"name": name, "route": "cuda", "source": f"saspa_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches": sum(c[name] for c in counts.values()),
                        "launches_by_config": {c: counts[c][name] for c in counts},
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "shape")},
                        **{k: row[k] for k in ("device_ms", "host_us", "cublas_ms", "route_a_ms") if k in row},
                        # an exp2 on the special-function unit is an operation too
                        "bound_by": "operations" if row["bound_by"] == "exp" else row["bound_by"],
                        "bound_term": row["bound_by"]})
    print(json.dumps({"kernels": kernels, "device_ms_from_events": len(PROFILER_MISSES)}), flush=True)  # no t_s
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
