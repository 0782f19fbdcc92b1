"""Attention seq2seq NMT, the training graph (counterpart of
``paddle_tpu/models/seq2seq.py``).

A bidirectional GRU encoder (``networks.bidirectional_gru(fused=True)``:
on the card each encoder timestep runs the CUDA GRU step kernel once per
direction when the width is a multiple of 128), and a GRU decoder with
fused Bahdanau attention built with ``recurrent_group`` / ``memory``.  The
vocab projection is hoisted out of the decoder loop: one fc over the whole
decoded sequence, then ``classification_cost``.  Every parametered layer
carries the JAX package's name, so one parameter tree serves both.

Generation (``is_generating=True``, beam search sharing the trained
parameters by name) is not ported yet and raises.
"""

from __future__ import annotations

from paddle_tpu_torch import data_type, layer, networks


def encoder(src_vocab_size: int, emb_dim: int, enc_dim: int,
            max_src_len: int):
    """Bidirectional GRU encoder -> (encoded seq [B, T, 2h], the backward
    GRU's half, whose first step seeds the decoder boot)."""
    src_word = layer.data(
        "source_words",
        data_type.integer_value_sequence(src_vocab_size, max_len=max_src_len))
    src_emb = layer.embedding(src_word, emb_dim, name="src_embedding")
    encoded = networks.bidirectional_gru(src_emb, enc_dim, fused=True,
                                         name="encoded_sequence")
    bwd = layer.slice(encoded, enc_dim, 2 * enc_dim, name="enc_bwd_part")
    return encoded, bwd


def _decoder_step(dec_dim, trg_vocab_size, boot, emit_probs=True):
    """The decoder's step body.  emit_probs=False stops at the GRU state:
    training applies the vocab projection to the whole decoded sequence
    after the loop."""

    def step(word_emb, enc_s, enc_proj_s):
        dec_mem = layer.memory(name="gru_decoder", size=dec_dim,
                               boot_layer=boot)
        context = networks.simple_attention(enc_s, enc_proj_s, dec_mem,
                                            name="att", fused=True)
        gates = layer.fc([context, word_emb], 3 * dec_dim, act=None,
                         bias_attr=False, name="dec_gates")
        gru = layer.gru_step_layer(gates, dec_mem, name="gru_decoder")
        if emit_probs:
            return layer.fc(gru, trg_vocab_size, act="softmax",
                            name="dec_out")
        return gru

    return step


def build(src_vocab_size: int, trg_vocab_size: int, emb_dim: int = 512,
          enc_dim: int = 512, dec_dim: int = 512, max_src_len: int = 50,
          max_trg_len: int = 50, is_generating: bool = False,
          beam_size: int = 3, bos_id: int = 0, eos_id: int = 1):
    """Return the training cost layer.  ``is_generating=True`` raises
    until beam search is ported."""
    if is_generating:
        raise NotImplementedError(
            "seq2seq generation (beam_search) is not ported to "
            "paddle_tpu_torch yet (ROADMAP.md section 1)")
    enc_seq, enc_bwd = encoder(src_vocab_size, emb_dim, enc_dim, max_src_len)
    # boot state from the backward GRU's first step, sized to the decoder
    boot = layer.fc(layer.first_seq(enc_bwd), dec_dim, act="tanh",
                    name="decoder_boot")
    enc_proj = layer.fc(enc_seq, dec_dim, act=None, bias_attr=False,
                        name="encoded_proj")
    step = _decoder_step(dec_dim, trg_vocab_size, boot, emit_probs=False)
    trg_word = layer.data(
        "target_words",
        data_type.integer_value_sequence(trg_vocab_size,
                                         max_len=max_trg_len))
    trg_emb = layer.embedding(trg_word, emb_dim, name="trg_embedding")
    decoded = layer.recurrent_group(
        step,
        [trg_emb, layer.StaticInput(enc_seq, is_seq=True),
         layer.StaticInput(enc_proj, is_seq=True)],
        name="decoder_group")
    trg_next = layer.data(
        "target_next_words",
        data_type.integer_value_sequence(trg_vocab_size,
                                         max_len=max_trg_len))
    logits = layer.fc(decoded, trg_vocab_size, act=None, name="dec_out")
    return layer.classification_cost(logits, trg_next, name="nmt_cost")
