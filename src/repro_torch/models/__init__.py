"""The attn:dense decoder LM, its layers and the flat parameter layout."""
