"""Special token ids of the Llama-2 sentencepiece vocabulary.

Only the constants the scheduler needs; the ``tokenizer.bin`` parser and
BPE encoder come with the HTTP-server slice (ROADMAP queue 1).
"""

BOS = 1  # sentencepiece <s> (llama2.ts:463)
EOS = 2  # </s> — the reference never special-cases it; generation stops on BOS
