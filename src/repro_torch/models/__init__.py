"""The LM-architecture zoo of the port: dense GQA decoders (ROADMAP A12)."""
