from dynamo_tpu_torch.worker.main import main

main()
