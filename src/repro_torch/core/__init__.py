"""Core math of the port: types, abs-top-k, the SAE, retrieval."""
