"""Host data tier of the port: vocab, tokenizer, packed corpus, episodes."""
