"""Host-side data path (numpy): tokenization, feature stores, labels, batches."""
