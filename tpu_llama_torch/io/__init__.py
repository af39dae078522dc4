"""Tokenizer constants; the tokenizer itself comes with the HTTP slice."""
