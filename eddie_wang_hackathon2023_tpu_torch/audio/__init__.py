"""Audio front end: log-Mel spectrogram and FLAC input."""
from .flac import read_flac
from .mel import (CHUNK_LENGTH, HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES,
                  SAMPLE_RATE, log_mel_spectrogram, mel_filters, pad_or_trim)

__all__ = ["CHUNK_LENGTH", "HOP_LENGTH", "N_FFT", "N_FRAMES", "N_SAMPLES",
           "SAMPLE_RATE", "log_mel_spectrogram", "mel_filters", "pad_or_trim",
           "read_flac"]
