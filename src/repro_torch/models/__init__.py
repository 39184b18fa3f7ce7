"""Models of the port: the dense decoder transformer (GQA + SwiGLU), with
the tri_attn kernel behind ``cfg.attn_impl``, and the RWKV-6 stack, with the
wkv kernel behind its chunked time mix."""
