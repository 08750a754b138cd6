"""The native host audio runtime (C++ WAV decoder and thread-pool batch loader)."""
