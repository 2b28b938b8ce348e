"""Model definitions over plain parameter dictionaries of tensors."""
