"""Tokenizer, cached featurization and the synthetic QA corpus (numpy only)."""
