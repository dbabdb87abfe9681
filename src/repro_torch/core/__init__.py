"""Bit-accurate posit codec, ILM planes and the EULER engine in PyTorch."""
