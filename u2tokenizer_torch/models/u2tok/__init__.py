"""The μ²tokenizer: SVR refiner and TTA aggregator."""
