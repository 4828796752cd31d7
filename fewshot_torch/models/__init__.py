"""Models of the port: the LSTM backbone and the few-shot LM head."""
