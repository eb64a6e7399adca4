"""Models of the port: Whisper, and the decoder-only LM
(``decoder.DecoderLMHead``, the SantaCoder family so far)."""
