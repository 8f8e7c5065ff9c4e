from tris_tpu_torch.tokenizer.bpe import ClipBPETokenizer, tokenize

__all__ = ["ClipBPETokenizer", "tokenize"]
