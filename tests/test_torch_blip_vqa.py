"""Parity of the port's BLIP VQA with the JAX package, on the CPU.

Tiny configs (ViT 32^2, patch 16, width 16, 1 layer; fusion encoder and
answer decoder of width 16, 2 layers, 2 heads, FFN 32, BLIP's vocabulary),
f32, one seeded flax-layout tree handed to both packages.  Tolerances: the
question states and the answer logits within 1e-5 of the largest output;
greedy answer ids and the decoded answers of `answer_batch`,
`answer_questions` (one vision pass tiled across the questions) and
`__call__` equal to the JAX wrapper's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saspa_tpu.models import blip_caption as JC
from saspa_tpu.models import blip_vqa as J
from saspa_tpu_torch.models import blip_caption as TC
from saspa_tpu_torch.models import blip_vqa as T
from tests.test_torch_blip_caption import _close, _two_torch_threads, images, jax_apply, seeded_tree  # noqa: F401

VIT = dict(image_size=32, patch_size=16, width=16, layers=1, heads=2)
TEXT = dict(width=16, layers=2, heads=2, intermediate=32)
QUESTIONS = ["what color is the plane?", "how many engines does it have?", "is it day or night?"]


@pytest.fixture(scope="module")
def vqas():
    port = T.TorchBlipVQA(vit=TC.BlipViTConfig(**VIT), text=TC.BlipTextConfig(**TEXT), device="cpu")
    tree = seeded_tree(port.model, 17)
    port = T.TorchBlipVQA(vit=TC.BlipViTConfig(**VIT), text=TC.BlipTextConfig(**TEXT), params=tree, device="cpu")
    jax_vqa = J.FlaxBlipVQA(vit=JC.BlipViTConfig(**VIT), text=JC.BlipTextConfig(**TEXT),
                            params=jax.tree_util.tree_map(jnp.asarray, tree))
    return port, jax_vqa


def test_question_states_and_answer_logits_match_flax(vqas):
    port, jax_vqa = vqas
    x = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    qids, qmask = port.tokenize_questions(QUESTIONS)
    jq, jm = jax_vqa._tokenize_questions(QUESTIONS)
    np.testing.assert_array_equal(qids.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(qmask.numpy(), np.asarray(jm))
    answer = np.random.RandomState(1).randint(0, TC.VOCAB, (3, 5)).astype(np.int32)
    j_states = jax_apply(jax_vqa.model, jax_vqa.params, jnp.asarray(x), jq, jm, method=J.BlipVQA.encode)
    j_logits = jax_apply(jax_vqa.model, jax_vqa.params, jnp.asarray(x), jq, jm, jnp.asarray(answer))
    with torch.no_grad():
        t_states = port.model.encode(torch.from_numpy(x), qids, qmask)
        t_logits = port.model(torch.from_numpy(x), qids, qmask, torch.from_numpy(answer).long())
    _close(t_states, j_states, 1e-5)
    _close(t_logits, j_logits, 1e-5)


def test_answer_batch_matches_jax(vqas):
    port, jax_vqa = vqas
    batch = np.concatenate(images(21, [(40, 56)] * 3))
    want = jax_vqa.answer_batch(batch, QUESTIONS)
    qids, qmask = jax_vqa._tokenize_questions(QUESTIONS)
    want_ids = np.asarray(jax_vqa._answer_jit(jax_vqa.params, JC.blip_preprocess(batch, 32), qids, qmask))
    got_ids, margins = port.answer_ids(batch, QUESTIONS, return_margins=True)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    assert margins.shape == (3, T.MAX_ANSWER_LEN - 1)
    assert (want_ids[:, 1:] != TC.PAD_ID).any()
    assert port.answer_batch(batch, QUESTIONS) == want


def test_answer_questions_and_call_match_jax(vqas, tmp_path):
    from PIL import Image

    port, jax_vqa = vqas
    path = tmp_path / "src.png"
    Image.fromarray(images(22, [(36, 30)])[0][0]).save(path)
    want = jax_vqa.answer_questions(str(path), QUESTIONS)
    assert port.answer_questions(str(path), QUESTIONS) == want
    assert [port(str(path), q) for q in QUESTIONS] == [jax_vqa(str(path), q) for q in QUESTIONS]
