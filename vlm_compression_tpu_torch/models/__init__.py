"""Towers and compositions of the port (EVA ViT-g, Q-Former, FlanT5,
InstructBLIP-T5), decoding, and the weight bridge."""
