"""Model core: LSTM cells, the RAU eval forward, hop aggregation."""
