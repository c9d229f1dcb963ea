"""Core b-bit minwise hashing: hash families, b-bit codes, OPH."""
