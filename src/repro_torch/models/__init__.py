"""The Molecular Transformer in PyTorch: layers, attention over a dense
position-tagged KV cache, and the encoder-decoder model."""
