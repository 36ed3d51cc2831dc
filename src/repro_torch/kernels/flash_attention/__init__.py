"""Online-softmax attention: `ref` (plain), `kernel` (CUDA), `ops` (entry)."""
