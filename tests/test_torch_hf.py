"""HF interop on the port (`lmrl_gym_torch/models/hf.py`,
`loops/checkpoints.py::export_hf_format`), on tiny random GPT-2, GPT-J,
LLaMA and T5 models built locally (no downloads).

- The port's logits from `params_from_hf_state_dict` match the HF torch
  model's within 1e-5 (f32), and its state dict equals the JAX route's
  (`lmrl_gym_tpu.models.hf` → `models/convert.py::params_from_jax`)
  exactly; the same for T5.
- `export_hf_pretrained` (no `transformers` used) writes a directory that
  `transformers.AutoModelForCausalLM.from_pretrained` loads, with the same
  logits.
- `load_hf_pretrained` reads a `save_pretrained` directory in both weight
  formats (model.safetensors, pytorch_model.bin); the port's safetensors
  reader agrees with `safetensors.torch.load_file`, and its writer's file
  is read by it.
- `export_hf_format` is read by the JAX package's `load_pytree`.
"""
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from lmrl_gym_tpu.core.checkpointing import load_pytree as jload_pytree  # noqa: E402
from lmrl_gym_tpu.models import hf as jhf  # noqa: E402
from lmrl_gym_torch.loops.checkpoints import export_hf_format  # noqa: E402
from lmrl_gym_torch.models import hf  # noqa: E402
from lmrl_gym_torch.models.convert import encdec_params_from_jax, params_from_jax  # noqa: E402
from lmrl_gym_torch.models.encdec import EncoderDecoder  # noqa: E402
from lmrl_gym_torch.models.transformer import Transformer  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
IDS = torch.tensor([[3, 9, 250, 17, 4, 99, 1, 0], [5, 5, 2, 200, 11, 7, 30, 8]])


def _tiny(family: str):
    kw = dict(resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    if family == "gpt2":
        cfg, cls, seed = transformers.GPT2Config(vocab_size=257, n_positions=64, n_embd=32, n_layer=2, n_head=4,
                                                 **kw), transformers.GPT2LMHeadModel, 0
    elif family == "gptj":
        cfg, cls, seed = transformers.GPTJConfig(vocab_size=257, n_positions=64, n_embd=32, n_layer=2, n_head=4,
                                                 rotary_dim=8, tie_word_embeddings=False, **kw), \
            transformers.GPTJForCausalLM, 1
    else:
        cfg, cls, seed = transformers.LlamaConfig(vocab_size=257, max_position_embeddings=64, hidden_size=32,
                                                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                                                  intermediate_size=48, rms_norm_eps=1e-6, tie_word_embeddings=False,
                                                  attention_dropout=0.0), transformers.LlamaForCausalLM, 2
    torch.manual_seed(seed)
    return cls(cfg).eval()


def _port(hf_model):
    config = hf.config_from_hf(hf_model.config).replace(dtype="float32", pad_vocab_to_multiple=64)
    model = Transformer(config, device="cpu")
    model.load_state_dict(hf.params_from_hf_state_dict(hf_model.state_dict(), config))
    return config, model


def _logits(model, ids=IDS):
    with torch.no_grad():
        return model(ids)[0][..., : model.config.vocab_size]


@pytest.mark.parametrize("family", ["gpt2", "gptj", "llama"])
def test_import_matches_hf_and_the_jax_route(family):
    hf_model = _tiny(family)
    config, model = _port(hf_model)
    with torch.no_grad():
        want = hf_model(IDS).logits
    torch.testing.assert_close(_logits(model), want, **TOL)
    assert model(IDS)[0].shape[-1] == config.padded_vocab_size
    jtree = jhf.params_from_hf_state_dict(hf_model.state_dict(), config)
    for k, v in params_from_jax(jtree, config).items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("family", ["gpt2", "gptj", "llama"])
def test_export_loads_in_transformers(family, tmp_path):
    hf_model = _tiny(family)
    config, model = _port(hf_model)
    hf.export_hf_pretrained(model, config, str(tmp_path))
    reloaded = transformers.AutoModelForCausalLM.from_pretrained(str(tmp_path)).eval()
    with torch.no_grad():
        torch.testing.assert_close(reloaded(IDS).logits, hf_model(IDS).logits, **TOL)
    # and back into the port without transformers: the same weights
    config2, model2 = hf.load_hf_pretrained(str(tmp_path), device="cpu", dtype="float32", pad_vocab_to_multiple=64)
    assert config2 == config.replace(embd_pdrop=config2.embd_pdrop, resid_pdrop=config2.resid_pdrop,
                                     attn_pdrop=config2.attn_pdrop)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(model2.state_dict()[k], v, rtol=0, atol=0, msg=k)
    torch.testing.assert_close(_logits(model2), _logits(model), rtol=0, atol=0)


@pytest.mark.parametrize("safe", [True, False])
def test_load_save_pretrained_dir(safe, tmp_path):
    hf_model = _tiny("gpt2")
    hf_model.save_pretrained(str(tmp_path), safe_serialization=safe)
    config, model = hf.load_hf_pretrained(str(tmp_path), device="cpu", dtype="float32")
    assert config.vocab_size == 257 and config.num_layers == 2
    assert model.wte.weight.shape[0] == config.padded_vocab_size == 384
    assert torch.all(model.wte.weight[config.vocab_size:] == 0)  # padding rows zero-filled
    with torch.no_grad():
        torch.testing.assert_close(_logits(model), hf_model(IDS).logits, **TOL)
    if safe:
        from safetensors.torch import load_file

        path = os.path.join(str(tmp_path), "model.safetensors")
        ref, got = load_file(path), hf.read_safetensors(path)
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k


def test_safetensors_writer_round_trip(tmp_path):
    from safetensors.torch import load_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g), "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3), "d": torch.zeros(0, 4), "e": torch.tensor(2.5)}
    path = str(tmp_path / "x.safetensors")
    hf.write_safetensors(tensors, path)
    for loaded in (load_file(path), hf.read_safetensors(path)):
        assert sorted(loaded) == sorted(tensors)
        for k, v in tensors.items():
            assert loaded[k].dtype == v.dtype and loaded[k].shape == v.shape and torch.equal(loaded[k], v), k


def _tiny_t5():
    cfg = transformers.T5Config(vocab_size=257, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_decoder_layers=2,
                                num_heads=4, dropout_rate=0.0, feed_forward_proj="gated-gelu",
                                tie_word_embeddings=False, decoder_start_token_id=0, pad_token_id=0)
    torch.manual_seed(0)
    return transformers.T5ForConditionalGeneration(cfg).eval()


def test_t5_import_matches_hf_and_round_trips():
    hf_model = _tiny_t5()
    config = hf.encdec_config_from_hf(hf_model.config).replace(dtype="float32", pad_vocab_to_multiple=1)
    assert hf.encdec_config_from_hf(hf_model.config.to_dict()) == hf.encdec_config_from_hf(hf_model.config)
    model = EncoderDecoder(config, device="cpu")
    model.load_state_dict(hf.encdec_params_from_hf_state_dict(hf_model.state_dict(), config))
    enc = torch.tensor([[5, 6, 7, 0], [8, 9, 0, 0]])
    em = (enc != 0).long()
    dec = torch.tensor([[0, 11, 12], [0, 13, 14]])
    with torch.no_grad():
        want = hf_model(input_ids=enc, attention_mask=em, decoder_input_ids=dec).logits
        got, _ = model(enc, em, dec, torch.ones_like(dec))
    torch.testing.assert_close(got, want, **TOL)
    jtree = jhf.encdec_params_from_hf_state_dict(hf_model.state_dict(), config)
    for k, v in encdec_params_from_jax(jtree).items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0, msg=k)
    back = hf.encdec_params_to_hf_state_dict(model, config)
    for k, v in hf_model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)


def test_export_hf_format_is_read_by_jax(tmp_path):
    _, model = _port(_tiny("gpt2"))
    export_hf_format(model, {"model_type": "gpt2", "n_layer": 2}, str(tmp_path))
    tree = jload_pytree(os.path.join(str(tmp_path), "flax_model.msgpack"))
    want = params_from_jax(tree, model.config)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(want[k].numpy(), v.numpy(), err_msg=k)
    with open(os.path.join(str(tmp_path), "config.json")) as f:
        assert "gpt2" in f.read()
