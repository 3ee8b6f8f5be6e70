"""Synthetic data: the multi-task arrays (numpy; exactly the arrays
``repro.data`` makes) and the LM token stream (its tokens bit for bit)."""
