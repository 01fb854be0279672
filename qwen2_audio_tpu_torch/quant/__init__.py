"""ggml block codecs (codecs.py) and the card-side weight forms built from
them (qparams.py)."""
