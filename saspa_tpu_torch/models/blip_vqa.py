"""BLIP VQA (counterpart of saspa_tpu/models/blip_vqa.py): LAVIS's blip_vqa
vqav2, which the reference loads beside the captioner to answer optional
per-image questions (prompts_engineering/blip_utils.py:34-53).

  * vision: the captioner's `BlipViT` at 480x480 (LAVIS's vqav2 eval size);
  * question encoder: `BlipTextEncoder`, the BERT fusion encoder over the
    question, its first token the [ENC] id, with cross-attention to the
    image tokens in every layer;
  * answer decoder: the captioner's `BlipTextDecoder`, cross-attending to
    the question states with the padded positions masked; decoding opens
    with [DEC] and runs greedily (`greedy_decode`, <= 10 tokens, on the
    device, from a CUDA graph on the card), as the JAX package's scan does.

`TorchBlipVQA` answers a batch of (image, question) pairs
(`answer_batch`), several questions about one image with one vision pass
tiled across them (`answer_questions`), or one pair (`__call__`).  Its
weights come from LAVIS's public checkpoint (weights/sources.py:
"blip_vqa"); images are read without PIL.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from saspa_tpu_torch import resolve_device, to_device
from saspa_tpu_torch.models.blip_caption import (
    BOS_ID,
    PAD_ID,
    SEP_ID,
    BlipTextConfig,
    BlipTextDecoder,
    BlipTextEncoder,
    BlipViT,
    BlipViTConfig,
    WordPieceTokenizer,
    blip_preprocess,
    greedy_decode,
    vocab_path,
)
from saspa_tpu_torch.utils import graphs
from saspa_tpu_torch.weights.load import load_or_init

ENC_ID = 30523  # LAVIS [ENC] token replaces the question's [CLS]
VQA_IMAGE_SIZE = 480  # LAVIS blip_vqa vqav2 eval processor
MAX_QUESTION_LEN = 32
MAX_ANSWER_LEN = 10  # LAVIS predict_answers max_len


class BlipVQA(nn.Module):
    def __init__(self, vit: BlipViTConfig = BlipViTConfig(image_size=VQA_IMAGE_SIZE),
                 text: BlipTextConfig = BlipTextConfig(), device=None):
        super().__init__()
        self.vit = vit
        self.visual_encoder = BlipViT(vit, device)
        self.text_encoder = BlipTextEncoder(text, device)
        self.text_decoder = BlipTextDecoder(text, device)

    def forward(self, images, question_ids, question_mask, answer_ids):
        """Teacher-forced answer logits (B, L_ans, vocab)."""
        states = self.encode(images, question_ids, question_mask)
        return self.text_decoder(answer_ids, states, cross_mask=question_mask)

    def encode(self, images, question_ids, question_mask):
        """Normalised images (B, H, W, 3) and questions -> question states."""
        return self.text_encoder(question_ids, self.visual_encoder(images), question_mask)

    def encode_image(self, images):
        return self.visual_encoder(images)

    def encode_question(self, question_ids, image_tokens, question_mask):
        return self.text_encoder(question_ids, image_tokens, question_mask)

    def decode_step_logits(self, answer_ids, question_states, question_mask):
        return self.text_decoder(answer_ids, question_states, cross_mask=question_mask)


def greedy_answer_ids_from_states(model: BlipVQA, states, question_mask, max_len: int = MAX_ANSWER_LEN,
                                  return_margins: bool = False):
    """Greedy answers from question states (B, Lq, W): (B, max_len) ids,
    [DEC] first, stopping a row at SEP."""
    ids = torch.full((states.shape[0], max_len), PAD_ID, dtype=torch.long, device=states.device)
    ids[:, 0] = BOS_ID
    dec = model.text_decoder

    def loop(ids, states, question_mask):
        return greedy_decode(lambda t: dec.decoder_hidden(t, states, question_mask), dec.head, ids, 1,
                             return_margins)

    ids, margins = graphs.replay(model, ("answer", return_margins), loop, ids, states, question_mask)
    return (ids, margins) if return_margins else ids


def greedy_answer_ids(model: BlipVQA, images, question_ids, question_mask, max_len: int = MAX_ANSWER_LEN,
                      return_margins: bool = False):
    with torch.no_grad():
        states = model.encode(images, question_ids, question_mask)
    return greedy_answer_ids_from_states(model, states, question_mask, max_len, return_margins)


class TorchBlipVQA:
    """Callable (path, question) -> answer (the gen/caption_tools.py `vqa`
    plug), on `device` (None: the card)."""

    def __init__(self, weights_dir: Optional[str] = None, vit: Optional[BlipViTConfig] = None,
                 text: Optional[BlipTextConfig] = None, params=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = BlipVQA(vit or BlipViTConfig(image_size=VQA_IMAGE_SIZE), text or BlipTextConfig(),
                             self.device).eval()
        self.tokenizer = WordPieceTokenizer(vocab_path(weights_dir))
        self.load_reports = load_or_init(self.model, "blip_vqa", "BLIP VQA file", weights_dir, params, seed)

    def tokenize_questions(self, questions: Sequence[str]):
        """[ENC] tokens [SEP], padded to MAX_QUESTION_LEN: (ids, mask) on the device."""
        ids = np.full((len(questions), MAX_QUESTION_LEN), PAD_ID, np.int64)
        mask = np.zeros((len(questions), MAX_QUESTION_LEN), np.int64)
        for i, q in enumerate(questions):
            row = [ENC_ID] + self.tokenizer.encode(q)[: MAX_QUESTION_LEN - 2] + [SEP_ID]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return to_device(ids, self.device), to_device(mask, self.device)

    def _decode(self, ids: torch.Tensor) -> List[str]:
        return [self.tokenizer.decode(row[1:]) for row in ids.cpu().numpy()]

    def answer_ids(self, images_uint8: np.ndarray, questions: Sequence[str], return_margins: bool = False):
        images = blip_preprocess(images_uint8, self.model.vit.image_size, self.device)
        qids, qmask = self.tokenize_questions(questions)
        return greedy_answer_ids(self.model, images, qids, qmask, return_margins=return_margins)

    def answer_batch(self, images_uint8: np.ndarray, questions: Sequence[str]) -> List[str]:
        return self._decode(self.answer_ids(images_uint8, questions))

    def answer_questions(self, path: str, questions: Sequence[str]) -> List[str]:
        """Every answer about ONE image: the 480^2 vision tower runs once and
        its tokens are tiled across the questions."""
        from saspa_tpu_torch.gen.image_io import read_rgb

        images = blip_preprocess(read_rgb(path)[None], self.model.vit.image_size, self.device)
        qids, qmask = self.tokenize_questions(questions)
        with torch.no_grad():
            tokens = self.model.encode_image(images)
            states = self.model.encode_question(qids, tokens.expand(qids.shape[0], -1, -1), qmask)
        return self._decode(greedy_answer_ids_from_states(self.model, states, qmask))

    def __call__(self, path: str, question: str) -> str:
        from saspa_tpu_torch.gen.image_io import read_rgb

        return self.answer_batch(read_rgb(path)[None], [question])[0]
