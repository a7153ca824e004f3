"""Slow-fast LM host code: token grids, tokenizer, sampling, generation."""
