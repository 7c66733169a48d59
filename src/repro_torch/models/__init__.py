"""The language-model stack of the port: layers, attention (GQA,
cross-attention, MLA), MoE, the RWKV6 and Mamba mixers, blocks and the
model (train forward, the whisper encoder, prefill and decode)."""
