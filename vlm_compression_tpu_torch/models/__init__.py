"""Towers and compositions of the port (EVA ViT-g, Q-Former, FlanT5,
LLaMA, InstructBLIP-T5, InstructBLIP-Vicuna), decoding, and the weight
bridge."""
