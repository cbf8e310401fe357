"""Grid, colour, face and light-code helpers of the decoding (copied)."""
