"""Models of the port: the decoder transformers (GQA + SwiGLU or a mixture
of experts, cross-attention, the whisper encoder-decoder, the zamba2 Mamba2
hybrid), with the tri_attn kernel behind ``cfg.attn_impl``, and the RWKV-6
stack, with the wkv kernel behind its chunked time mix."""
