from dynamo_tpu_torch.frontend.main import main

main()
