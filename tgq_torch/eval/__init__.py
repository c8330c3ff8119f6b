from tgq_torch.eval.ppl import (build_window_requests, evaluate_perplexity,
                                perplexity_from_token_stream)
