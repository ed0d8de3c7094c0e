from analytics_zoo_torch.models.seq2seq.seq2seq import Seq2seq

__all__ = ["Seq2seq"]
