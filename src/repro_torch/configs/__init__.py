"""The paper's PDE configurations (the LM configurations are not ported yet)."""
