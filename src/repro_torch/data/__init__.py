"""Tokenizer, cached featurization, the synthetic QA corpus and the LM and
recsys generators (numpy only)."""
