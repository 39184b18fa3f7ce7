"""Models of the port: the dense decoder transformer (GQA + SwiGLU), with
the tri_attn kernel behind ``cfg.attn_impl``."""
