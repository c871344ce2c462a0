"""Engine core: scheduler, sequences, the LLMEngine step loop."""
